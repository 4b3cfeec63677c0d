"""``train.optimizer_ms``: AdamW's device ms a train step (its multi-tensor
kernels)."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "optimizer")
