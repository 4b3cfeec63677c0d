"""Compute ops: loss, plain PyTorch augmentation, the disparity codec, the halo
exchange, and the custom ops over the CUDA kernels (augmentation, max pool,
BatchNorm + ReLU)."""
