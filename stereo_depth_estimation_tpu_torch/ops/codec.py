"""FoundationStereo RGB24 disparity codec (host side, numpy).

Counterpart of the ``*_np`` functions of
``stereo_depth_estimation_tpu/ops/codec.py``. The dataset stores float
disparity (horizontal pixels) packed into an RGB PNG:
``value = (R*255*255 + G*255 + B) / scale`` with ``scale=1000``.
"""

from __future__ import annotations

import numpy as np

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
