"""Compute ops: loss, plain PyTorch augmentation, and the CUDA augmentation kernel."""
