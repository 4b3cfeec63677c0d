"""Preview montage rendering: [left | right | target | prediction].

Counterpart of ``stereo_depth_estimation_tpu/eval/preview.py`` (numpy and
PIL, copied so that the port imports nothing of the JAX package).
Same semantics as reference eval_utils.py:42-73 — disparity maps are
percentile-normalised (5th/95th of finite values) to grayscale; RGB views
pass through; the four panels concatenate horizontally into one PNG.
Operates on NHWC numpy arrays (host side; inputs are device outputs already
fetched)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def normalize_map(map_2d: np.ndarray) -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 grayscale via 5/95 percentile scaling."""
    finite = np.isfinite(map_2d)
    if not finite.any():
        return np.zeros((*map_2d.shape, 3), dtype=np.uint8)
    values = map_2d[finite]
    vmin = float(np.percentile(values, 5))
    vmax = float(np.percentile(values, 95))
    scale = max(vmax - vmin, 1e-6)
    normalized = np.clip((map_2d - vmin) / scale, 0.0, 1.0)
    grayscale = (normalized * 255.0).astype(np.uint8)
    return np.stack([grayscale] * 3, axis=-1)


def save_preview_montage(
    save_path: Path,
    stereo_input: np.ndarray,
    target: np.ndarray,
    pred: np.ndarray,
) -> None:
    """stereo_input: (H, W, 6) float [0,1] or uint8; target/pred: (H, W)."""
    if stereo_input.dtype == np.uint8:
        left_img = stereo_input[..., :3]
        right_img = stereo_input[..., 3:6]
    else:
        left_img = np.clip(stereo_input[..., :3] * 255.0, 0, 255).astype(np.uint8)
        right_img = np.clip(stereo_input[..., 3:6] * 255.0, 0, 255).astype(np.uint8)

    montage = np.concatenate(
        [left_img, right_img, normalize_map(np.asarray(target)),
         normalize_map(np.asarray(pred))],
        axis=1,
    )
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(montage).save(save_path)
