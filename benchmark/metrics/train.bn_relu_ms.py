"""``train.bn_relu_ms``: BatchNorm and ReLU device ms a train step:
cuDNN/PyTorch BatchNorm, ReLU, and BN1-BN4 where the model runs them."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "batchnorm", "relu", "BN1-BN4")
