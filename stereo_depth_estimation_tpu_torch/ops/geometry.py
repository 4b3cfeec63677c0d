"""Stereo geometry: depth conversion, baseline estimation, confidence,
contours, centre-patch readout.

Counterpart of ``stereo_depth_estimation_tpu/ops/geometry.py``: the numpy
functions are copied (the port imports nothing of the JAX package), and the
two device functions are written in torch.
- depth = f * B / disparity, invalid (<= 1e-6 or non-finite) -> NaN;
- baseline from |P2[0,3] / P1[0,0]|, with ||T|| as the fallback;
- model-resolution focal length f_model = f_calib * model_w / calib_w;
- confidence = exp(-logvar / 2);
- iso-depth contour edges between depth bins;
- centre-patch median readouts.
"""

from __future__ import annotations

import numpy as np
import torch


def disparity_to_depth_np(
    disparity: np.ndarray, focal_length_px: float, baseline_m: float
) -> np.ndarray:
    depth = np.full_like(disparity, np.nan, dtype=np.float32)
    valid = np.isfinite(disparity) & (disparity > 1e-6)
    depth[valid] = (focal_length_px * baseline_m) / disparity[valid]
    return depth


def disparity_to_depth(
    disparity: torch.Tensor, focal_length_px: float, baseline_m: float
) -> torch.Tensor:
    valid = torch.isfinite(disparity) & (disparity > 1e-6)
    safe = torch.where(valid, disparity, torch.ones_like(disparity))
    return torch.where(valid, (focal_length_px * baseline_m) / safe,
                       torch.full_like(disparity, float("nan")))


def confidence_from_logvar_np(logvar: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * logvar)


def confidence_from_logvar(logvar: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * logvar)


def estimate_baseline_m(
    P1: np.ndarray | None, P2: np.ndarray | None, T: np.ndarray | None
) -> float | None:
    """|-P2[0,3] / P1[0,0]| when valid, else ||T||, else None."""
    baseline_m = None
    if P1 is not None and P2 is not None:
        focal_px = float(P1[0, 0])
        if np.isfinite(focal_px) and abs(focal_px) > 1e-9:
            tx = float(P2[0, 3])
            candidate = abs(-tx / focal_px)
            if np.isfinite(candidate) and candidate > 0.0:
                baseline_m = candidate
    if baseline_m is None and T is not None:
        t = np.asarray(T, dtype=np.float64).reshape(-1)
        if t.size >= 3:
            candidate = float(np.linalg.norm(t))
            if np.isfinite(candidate) and candidate > 0.0:
                baseline_m = candidate
    return baseline_m


def scale_focal_to_model(
    focal_calib_px: float, calib_width_px: int, model_width_px: int
) -> float:
    """Disparity is predicted at model resolution: scale the calibration's
    focal length by the width ratio."""
    return focal_calib_px * (model_width_px / float(calib_width_px))


def depth_contour_mask(
    depth_m: np.ndarray,
    contour_step_m: float,
    min_depth_m: float,
    max_depth_m: float,
) -> np.ndarray:
    """uint8 {0,255} mask of iso-depth bin boundaries between valid neighbours."""
    valid = np.isfinite(depth_m) & (depth_m > min_depth_m) & (depth_m <= max_depth_m)
    if not np.any(valid):
        return np.zeros(depth_m.shape, dtype=np.uint8)

    clipped = np.clip(depth_m, min_depth_m, max_depth_m)
    bins = np.full(depth_m.shape, -1, dtype=np.int32)
    bins[valid] = np.floor((clipped[valid] - min_depth_m) / contour_step_m).astype(
        np.int32
    )
    edges = np.zeros(depth_m.shape, dtype=bool)
    vertical = valid[:-1, :] & valid[1:, :]
    horizontal = valid[:, :-1] & valid[:, 1:]
    edges[:-1, :] |= vertical & (bins[:-1, :] != bins[1:, :])
    edges[:, :-1] |= horizontal & (bins[:, :-1] != bins[:, 1:])
    return edges.astype(np.uint8) * 255


def center_patch_median(values: np.ndarray, window: int) -> float:
    """Median of finite positive values in the centre window (NaN if none)."""
    h, w = values.shape
    cx, cy = w // 2, h // 2
    half = max(1, window // 2)
    patch = values[
        max(0, cy - half) : min(h, cy + half + 1),
        max(0, cx - half) : min(w, cx + half + 1),
    ]
    patch = patch[np.isfinite(patch) & (patch > 0.0)]
    return float(np.median(patch)) if patch.size > 0 else float("nan")
