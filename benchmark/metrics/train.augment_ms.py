"""``train.augment_ms``: device ms a train step in the augmentation (span
``train.augment``: factor sampling, gray means, K1, noise and clamp), mean
over the traced steps."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.mean_per_unit("train.step", ("train.augment",), "device_ms")
