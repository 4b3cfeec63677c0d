"""``pretrain.pool_roofline``: ``train.pool_roofline``, read in the cells whose rate is
``pretrain_pairs_per_s``."""

from benchmark import spec

read = spec.reader("train.pool_roofline")
