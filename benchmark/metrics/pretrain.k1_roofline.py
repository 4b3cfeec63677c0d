"""``pretrain.k1_roofline``: ``train.k1_roofline``, read in the cells whose rate is
``pretrain_pairs_per_s``."""

from benchmark import spec

read = spec.reader("train.k1_roofline")
