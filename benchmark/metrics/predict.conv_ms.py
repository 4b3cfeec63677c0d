"""``predict.conv_ms``: Convolution kernels' device ms a batch, float32 (TF32
where cuDNN takes it)."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "conv")
