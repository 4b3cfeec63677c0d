"""``train.conv_ms``: Convolution kernels' device ms a train step (cuDNN
forward, dgrad, wgrad)."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "conv")
