"""FoundationStereo RGB24 disparity codec, on numpy arrays and on tensors.

Counterpart of ``stereo_depth_estimation_tpu/ops/codec.py``. The dataset
stores float disparity (horizontal pixels) packed into an RGB PNG:
``value = (R*255*255 + G*255 + B) / scale`` with ``scale=1000``.

``disparity_decode`` / ``disparity_encode`` take tensors and compute on the
tensor's device, bitwise as the numpy versions do: the decode divides by
the scale (the JAX package's device decode multiplies by its float32
reciprocal, one ulp away for most codes), and the encode rounds in float64
(the JAX package's in float32).
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_SCALE = 1000.0


def disparity_decode_np(rgb_u8: np.ndarray, scale: float = DEFAULT_SCALE) -> np.ndarray:
    """Decode HWC (or ...HW3) uint8 RGB into float32 disparity."""
    x = rgb_u8.astype(np.float32)
    out = x[..., 0] * (255.0 * 255.0) + x[..., 1] * 255.0 + x[..., 2]
    return out / np.float32(scale)


def disparity_encode_np(disparity: np.ndarray, scale: float = DEFAULT_SCALE) -> np.ndarray:
    """Inverse of :func:`disparity_decode_np`; returns uint8 ...HW3."""
    values = np.round(disparity.astype(np.float64) * scale).astype(np.int64)
    r = values // (255 * 255)
    rem = values - r * (255 * 255)
    g = rem // 255
    b = rem - g * 255
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def disparity_decode(rgb_u8: torch.Tensor, scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """...HW3 uint8 -> ...HW float32 disparity on ``rgb_u8``'s device, bitwise
    as ``disparity_decode_np``."""
    x = rgb_u8.to(torch.float32)
    out = x[..., 0] * (255.0 * 255.0) + x[..., 1] * 255.0 + x[..., 2]
    # A 0-dim tensor on the device: CUDA turns division by a Python scalar
    # into a multiplication by its reciprocal.
    return out / torch.tensor(scale, dtype=torch.float32, device=out.device)


def disparity_encode(disparity: torch.Tensor, scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """...HW float -> ...HW3 uint8 on ``disparity``'s device, bitwise as
    ``disparity_encode_np`` (rounded half to even in float64)."""
    values = torch.round(disparity.to(torch.float64) * scale).to(torch.int64)
    r = values // (255 * 255)
    rem = values - r * (255 * 255)
    g = rem // 255
    b = rem - g * 255
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)
