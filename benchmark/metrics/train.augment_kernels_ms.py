"""``train.augment_kernels_ms``: The augmentation kernels' device ms a train
step: K1 and the gray means."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "K1 augment", "augment gray means")
