"""Bilinear resize with PyTorch ``align_corners=False`` semantics, on the
host (numpy) and on the device (torch).

Counterpart of ``stereo_depth_estimation_tpu/ops/resize.py``: half-pixel
source centres, no anti-aliasing (the reference resizes with
``F.interpolate(mode="bilinear", align_corners=False)``). Each 1-D resample is
a small dense matrix with two non-zeros per row, applied as two matrix
products. On the device these are two ``einsum`` products in float64 with
cached matrices: TF32 applies to float32 products only, so none enters them
whatever the caller has set, as the JAX package holds its products at
``Precision.HIGHEST``. (``F.interpolate`` computes its weights in float32
and lands up to 8e-6 away from the JAX resize.) Disparity values are also
scaled by the width ratio, because disparity is measured in horizontal
pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 matrix for 1-D bilinear resampling.

    Source coordinate for output i: ``max(0, (i + 0.5) * in/out - 0.5)``,
    PyTorch's area_pixel_compute_source_index (align_corners=False).
    """
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) * scale - 0.5, 0.0)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float64)
    w0 = 1.0 - w1
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), i0] += w0
    mat[np.arange(out_size), i1] += w1
    return mat.astype(np.float32)


def resize_bilinear_np(image: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Resize ``(H, W)`` or ``(H, W, C)`` float arrays."""
    h_out, w_out = out_hw
    h_in, w_in = image.shape[0], image.shape[1]
    a_h = _resample_matrix(h_in, h_out)
    a_w = _resample_matrix(w_in, w_out)
    x = image.astype(np.float32)
    if x.ndim == 2:
        x = x[..., None]
    rows = (a_h @ x.reshape(h_in, -1)).reshape(h_out, w_in, -1)
    out = np.tensordot(rows, a_w, axes=([1], [1]))  # (h_out, c, w_out)
    out = np.moveaxis(out, -1, 1)  # (h_out, w_out, c)
    if image.ndim == 2:
        return out[..., 0]
    return out


def resize_disparity_np(
    disparity: np.ndarray, out_hw: tuple[int, int], src_width: int | None = None
) -> np.ndarray:
    """Resize ``(H, W)`` disparity and scale its values by ``out_w / src_w``."""
    w_in = src_width if src_width is not None else disparity.shape[-1]
    resized = resize_bilinear_np(disparity, out_hw)
    return resized * np.float32(out_hw[1] / float(w_in))


@functools.lru_cache(maxsize=32)
def _resample_tensor(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``_resample_matrix`` in float64 on ``device``, copied there once."""
    return torch.from_numpy(_resample_matrix(in_size, out_size)).to(device, torch.float64)


def resample_matrices(
    in_hw: tuple[int, int], out_hw: tuple[int, int], device: torch.device
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The float64 (rows, columns) matrices of a resize from ``in_hw`` to
    ``out_hw`` on ``device``, or None where the sizes are equal. A caller
    that compiles its resize builds them here, outside the traced code, and
    passes them to ``resize_bilinear_with``."""
    if tuple(in_hw) == tuple(out_hw):
        return None
    return (_resample_tensor(in_hw[0], out_hw[0], device),
            _resample_tensor(in_hw[1], out_hw[1], device))


def resize_bilinear_with(
    image: torch.Tensor, matrices: tuple[torch.Tensor, torch.Tensor] | None
) -> torch.Tensor:
    """Device resize of ``(..., H, W, C)`` tensors by ``resample_matrices``'
    result: two float64 products -> float32."""
    x = image.to(torch.float32)
    if matrices is None:
        return x
    a_h, a_w = matrices
    x = torch.einsum("oh,...hwc->...owc", a_h, x.to(torch.float64))
    return torch.einsum("pw,...owc->...opc", a_w, x).to(torch.float32)


def resize_bilinear(image: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Device resize of ``(..., H, W, C)`` tensors (NHWC or HWC) -> float32."""
    in_hw = (image.shape[-3], image.shape[-2])
    return resize_bilinear_with(image, resample_matrices(in_hw, out_hw, image.device))


def resize_disparity(
    disparity: torch.Tensor, out_hw: tuple[int, int], src_width: int | None = None
) -> torch.Tensor:
    """Resize ``(..., H, W)`` disparity and scale its values by ``out_w / src_w``."""
    w_in = src_width if src_width is not None else disparity.shape[-1]
    resized = resize_bilinear(disparity[..., None], out_hw)[..., 0]
    return resized * float(np.float32(out_hw[1] / float(w_in)))
