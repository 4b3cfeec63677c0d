"""The yardstick's arithmetic: the card's published peaks, the operations of
a StereoUNet forward and the bytes the port's kernels have to move.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit.
A byte is counted once where a kernel reads it and once where it writes
it, whatever the kernel reads again.
"""

from __future__ import annotations

from .reference.unet import conv_macs

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def forward_flops(cfg: dict) -> int:
    """FLOPs of one forward of one pair, 2 a multiply-add: every convolution,
    transposed convolution and head."""
    return 2 * conv_macs(cfg["base_channels"], cfg["height"], cfg["width"], cfg["in_channels"])


def train_step_flops(cfg: dict, batch: int) -> int:
    """A train step's FLOPs: the forward, the data gradient and the weight
    gradient of every convolution (3x the forward); no recomputation."""
    return 3 * batch * forward_flops(cfg)


def k1_bytes(n: int, h: int, w: int, out_itemsize: int) -> int:
    """Kernel K1 (``csrc/augment.cu``): the uint8 (N, H, W, 6) batch in, the
    augmented batch out, and the (N, 16) float32 factor rows in."""
    return n * h * w * 6 * (1 + out_itemsize) + n * 16 * 4


def pool_level_bytes(n: int, h: int, w: int, c: int, itemsize: int) -> int:
    """K2 at one level: x in, the pooled values and their uint8 first-max
    index out. K3 moves the same: dy and the index in, dx out."""
    out = n * (h // 2) * (w // 2) * c
    return n * h * w * c * itemsize + out * itemsize + out


def pool_forward_bytes(cfg: dict, n: int, itemsize: int) -> int:
    """K2's bytes over the model's four pool levels for a batch of ``n``."""
    return sum(pool_level_bytes(n, cfg["height"] >> k, cfg["width"] >> k,
                                cfg["base_channels"] << k, itemsize) for k in range(4))
