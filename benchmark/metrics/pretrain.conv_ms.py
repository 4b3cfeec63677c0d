"""``pretrain.conv_ms``: ``train.conv_ms``, read in the cells whose rate is
``pretrain_pairs_per_s``."""

from benchmark import spec

read = spec.reader("train.conv_ms")
