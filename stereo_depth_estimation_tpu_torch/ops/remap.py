"""Stereo rectification: undistort/rectify maps and the bilinear remap.

Counterpart of ``stereo_depth_estimation_tpu/ops/remap.py``. The map
construction (plumb-bob / Brown-Conrady model, 4, 5 or 8 distortion
coefficients) is numpy in float64, copied; the per-frame remap is torch
indexing with the JAX package's formula, so the live engine rectifies on the
device beside the forward.

Map semantics: for each destination pixel, undo the new (rectified)
projection P, rotate by R^-1 into the original camera frame, apply lens
distortion, and project through the original intrinsics K. Samples outside
the source image are 0 (cv2's BORDER_CONSTANT default).

``F.grid_sample`` is not used: its normalised coordinates,
``(x + 1) * W / 2 - 0.5``, move each sample by float noise.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .._device import resolve_device
from .geometry import estimate_baseline_m


def compute_rectify_map(
    camera_matrix: np.ndarray,
    dist_coeffs: np.ndarray,
    R: np.ndarray,
    new_projection: np.ndarray,
    image_size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """float32 (map_x, map_y) of shape (H, W); image_size is (W, H) like cv2."""
    w, h = image_size
    K = np.asarray(camera_matrix, dtype=np.float64)
    d = np.asarray(dist_coeffs, dtype=np.float64).reshape(-1)
    # cv2 accepts 4, 5, 8, 12 or 14 coefficients; up to 8 (rational) here.
    coeffs = np.zeros(8)
    coeffs[: d.size] = d[:8]
    k1, k2, p1, p2, k3, k4, k5, k6 = coeffs

    P = np.asarray(new_projection, dtype=np.float64)
    fx_new, fy_new = P[0, 0], P[1, 1]
    cx_new, cy_new = P[0, 2], P[1, 2]

    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (u - cx_new) / fx_new
    y = (v - cy_new) / fy_new
    ones = np.ones_like(x)
    rays = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(np.asarray(R)).T
    xp = rays[..., 0] / rays[..., 2]
    yp = rays[..., 1] / rays[..., 2]

    r2 = xp * xp + yp * yp
    radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
        1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    )
    x_dist = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    y_dist = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    map_x = (fx * x_dist + cx).astype(np.float32)
    map_y = (fy * y_dist + cy).astype(np.float32)
    return map_x, map_y


def remap_bilinear(
    image: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor
) -> torch.Tensor:
    """Bilinear gather; image (H, W) or (H, W, C) float32, maps (H', W')
    float32 on the image's device; zero outside. Each of the four taps is
    zeroed on its own when it lies outside, its index clamped."""
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    h, w, c = image.shape
    flat = image.reshape(h * w, c)

    x0f = torch.floor(map_x)
    y0f = torch.floor(map_y)
    wx = (map_x - x0f)[..., None]
    wy = (map_y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)

    def sample(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        index = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return flat[index] * inside[..., None]

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bottom = v10 * (1.0 - wx) + v11 * wx
    out = top * (1.0 - wy) + bottom * wy
    return out[..., 0] if squeeze else out


def remap_bilinear_np(
    image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray
) -> np.ndarray:
    """Host remap, zero border; image (H, W[, C]) float or uint8 (uint8
    comes back as float32)."""
    out = remap_bilinear(
        torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32)),
        torch.from_numpy(np.asarray(map_x, dtype=np.float32)),
        torch.from_numpy(np.asarray(map_y, dtype=np.float32)),
    ).numpy()
    return out.astype(image.dtype if np.issubdtype(image.dtype, np.floating) else np.float32)


class Rectifier:
    """Left/right rectification maps, held on one device."""

    def __init__(
        self,
        map_l: tuple[np.ndarray, np.ndarray],
        map_r: tuple[np.ndarray, np.ndarray],
        image_size: tuple[int, int],
        focal_length_px: float,
        baseline_m: float | None,
        device: str | torch.device = "cuda",
    ) -> None:
        device = resolve_device(device)
        self.map_l_x, self.map_l_y, self.map_r_x, self.map_r_y = (
            torch.from_numpy(np.asarray(m, dtype=np.float32)).to(device)
            for m in (*map_l, *map_r)
        )
        self.image_size = image_size  # (W, H), cv2 convention
        self.focal_length_px = focal_length_px
        self.baseline_m = baseline_m

    @classmethod
    def from_calibration(
        cls, calib: Mapping[str, np.ndarray], device: str | torch.device = "cuda"
    ) -> "Rectifier":
        """From a calibration bundle (dict or npz): maps on ``device``."""
        image_size_values = np.asarray(calib["image_size"]).reshape(-1).tolist()
        image_size = (int(image_size_values[0]), int(image_size_values[1]))
        map_l = compute_rectify_map(
            calib["mtx_l"], calib["dist_l"], calib["R1"], calib["P1"], image_size
        )
        map_r = compute_rectify_map(
            calib["mtx_r"], calib["dist_r"], calib["R2"], calib["P2"], image_size
        )
        T = calib["T"] if "T" in calib else None
        return cls(
            map_l,
            map_r,
            image_size,
            focal_length_px=float(np.asarray(calib["P1"])[0, 0]),
            baseline_m=estimate_baseline_m(
                np.asarray(calib["P1"]), np.asarray(calib["P2"]), T
            ),
            device=device,
        )

    def rectify_left(self, image: torch.Tensor) -> torch.Tensor:
        return remap_bilinear(image, self.map_l_x, self.map_l_y)

    def rectify_right(self, image: torch.Tensor) -> torch.Tensor:
        return remap_bilinear(image, self.map_r_x, self.map_r_y)
