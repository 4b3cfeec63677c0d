"""``pretrain.augment_ms``: ``train.augment_ms``, read in the cells whose rate is
``pretrain_pairs_per_s``."""

from benchmark import spec

read = spec.reader("train.augment_ms")
