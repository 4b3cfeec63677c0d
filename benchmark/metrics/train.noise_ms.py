"""``train.noise_ms``: device ms a train step in the augmentation's noise and
clamp epilogue (span ``train.augment.noise``), mean over the traced steps."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.mean_per_unit("train.step", ("train.augment.noise",), "device_ms")
