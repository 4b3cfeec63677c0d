"""``pretrain.device_idle_pct``: ``train.device_idle_pct``, read in the cells whose rate is
``pretrain_pairs_per_s``."""

from benchmark import spec

read = spec.reader("train.device_idle_pct")
