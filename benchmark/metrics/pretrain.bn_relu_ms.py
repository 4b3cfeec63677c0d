"""``pretrain.bn_relu_ms``: ``train.bn_relu_ms``, read in the cells whose rate is
``pretrain_pairs_per_s``."""

from benchmark import spec

read = spec.reader("train.bn_relu_ms")
