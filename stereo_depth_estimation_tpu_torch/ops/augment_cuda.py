"""The augmentation chain as one hand-written CUDA kernel (``csrc/augment.cu``).

Counterpart of ``stereo_depth_estimation_tpu/ops/augment_pallas.py``: the
(N, H, W, 6) uint8 stereo batch goes through the colour chain, gamma and the
probabilistic blur of both views in one pass, written as f32 or bf16 in the
same NHWC layout. Factor sampling, the gray-mean pre-pass (``_pack_factors``)
and the noise + clamp epilogue stay plain PyTorch, as they are plain XLA in
the JAX package.

``pointwise_chain`` takes the plain version (``pointwise_chain_plain``) for a
tensor on the CPU, and launches the kernel for a CUDA tensor; there is no
fallback from the kernel to the plain version. ``pointwise_chain_cuda``
launches the kernel or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .augment import (
    _GRAY_WEIGHTS,
    AugmentConfig,
    _bcast,
    _blend,
    adjust_brightness,
    adjust_gamma,
    adjust_hue,
    adjust_saturation,
    gaussian_blur,
    noise_and_clip_stereo,
    sample_factors,
    split_views,
)

# Factors per view in a packed row: brightness, contrast, saturation, hue,
# gamma, gray mean (of the brightness-adjusted view, for the contrast
# blend), blur-on flag, blur sigma.
_F_PER_VIEW = 8
MAX_BLUR_KERNEL = 15  # csrc/augment.cu kMaxHalf


def _pack_factors(
    images_u8: torch.Tensor, factors: dict[str, torch.Tensor], n: int
) -> torch.Tensor:
    """(N, 16) f32 per-image factor rows, left view then right; also computes
    the contrast gray means (mean luma of the brightness-adjusted view)."""
    h, w = images_u8.shape[1], images_u8.shape[2]
    weights = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=images_u8.device)
    rows = []
    for fv, sl in zip(split_views(factors, n), (slice(0, 3), slice(3, 6))):
        xb = (
            fv["brightness"][:, None, None, None]
            * (images_u8[..., sl].to(torch.float32) * (1.0 / 255.0))
        ).clamp_(0.0, 1.0)
        gray_mean = (xb * weights).sum(dim=(1, 2, 3)) / (h * w)
        rows.append(
            torch.stack(
                [
                    fv["brightness"], fv["contrast"], fv["saturation"],
                    fv["hue"], fv["gamma"], gray_mean,
                    fv["blur_on"].to(torch.float32), fv["blur_sigma"],
                ],
                dim=1,
            )
        )
    return torch.cat(rows, dim=1)


def pointwise_chain_plain(
    images_u8: torch.Tensor,
    factors_packed: torch.Tensor,
    blur_k: int = 0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same signature and result:
    (N, H, W, 6) uint8 + (N, 16) factors -> (N, H, W, 6) ``out_dtype``."""
    x = images_u8.to(torch.float32) * (1.0 / 255.0)
    views = []
    for view in (0, 1):
        row = factors_packed[:, view * _F_PER_VIEW : (view + 1) * _F_PER_VIEW]
        fb, fc, fs, fh, fg, gray_mean, blur_on, sigma = row.unbind(1)
        img = adjust_brightness(x[..., 3 * view : 3 * view + 3], fb)
        img = _blend(img, _bcast(gray_mean), _bcast(fc))
        img = adjust_saturation(img, fs)
        img = adjust_hue(img, fh)
        img = adjust_gamma(img, fg)
        if blur_k > 0:
            img = torch.where(_bcast(blur_on) > 0, gaussian_blur(img, sigma, blur_k), img)
        views.append(img)
    return torch.cat(views, dim=-1).to(out_dtype)


def _check_inputs(
    images_u8: torch.Tensor, factors_packed: torch.Tensor, blur_k: int,
    out_dtype: torch.dtype,
) -> None:
    if images_u8.device.type != "cuda":
        raise ValueError(
            f"the CUDA augmentation kernel takes CUDA tensors, got {images_u8.device}"
        )
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4 or images_u8.shape[-1] != 6:
        raise ValueError(
            "images must be (N, H, W, 6) uint8, got "
            f"{tuple(images_u8.shape)} {images_u8.dtype}"
        )
    n, h, w, _ = images_u8.shape
    if factors_packed.dtype != torch.float32 or tuple(factors_packed.shape) != (n, 16):
        raise ValueError(
            f"factors must be ({n}, 16) float32, got "
            f"{tuple(factors_packed.shape)} {factors_packed.dtype}"
        )
    if factors_packed.device != images_u8.device:
        raise ValueError("images and factors must be on the same device")
    if not (images_u8.is_contiguous() and factors_packed.is_contiguous()):
        raise ValueError("images and factors must be contiguous")
    if images_u8.data_ptr() % 2:
        raise ValueError("images must be 2-byte aligned")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if blur_k and (
        blur_k < 3 or blur_k % 2 == 0 or blur_k > MAX_BLUR_KERNEL
        or blur_k // 2 >= h or blur_k // 2 >= w
    ):
        raise ValueError(
            f"blur_k must be 0 or odd in [3, {MAX_BLUR_KERNEL}] with blur_k // 2 "
            f"below the image's height and width, got {blur_k} for {h}x{w}"
        )


class PointwiseChainKernel:
    """Launches ``augment_pointwise_chain`` (``csrc/augment.cu``) on the current
    stream. ``launches`` counts the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None
        self._error_string = None

    def _bind(self):
        if self._fn is None:
            lib = load_library("augment")
            fn = lib.augment_pointwise_chain
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            err = lib.augment_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            if lib.augment_max_blur_kernel() != MAX_BLUR_KERNEL:
                raise RuntimeError("csrc/augment.cu and MAX_BLUR_KERNEL disagree")
            self._fn, self._error_string = fn, err
        return self._fn

    def __call__(
        self,
        images_u8: torch.Tensor,
        factors_packed: torch.Tensor,
        blur_k: int = 0,
        out_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        _check_inputs(images_u8, factors_packed, blur_k, out_dtype)
        out = torch.empty(images_u8.shape, dtype=out_dtype, device=images_u8.device)
        if out.numel() == 0:
            return out
        fn = self._bind()
        n, h, w, _ = images_u8.shape
        with torch.cuda.device(images_u8.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                images_u8.data_ptr(), factors_packed.data_ptr(), out.data_ptr(),
                n, h, w, blur_k, int(out_dtype == torch.bfloat16), stream,
            )
        if code != 0:
            reason = self._error_string(code).decode()
            raise RuntimeError(f"augment_pointwise_chain launch failed: {reason}")
        self.launches += 1
        return out


pointwise_chain_cuda = PointwiseChainKernel()


def pointwise_chain(
    images_u8: torch.Tensor,
    factors_packed: torch.Tensor,
    blur_k: int = 0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(N, H, W, 6) uint8 + (N, 16) factors -> (N, H, W, 6) ``out_dtype``: the
    plain version for a CPU tensor, the CUDA kernel for any other."""
    if images_u8.device.type == "cpu":
        return pointwise_chain_plain(images_u8, factors_packed, blur_k, out_dtype)
    return pointwise_chain_cuda(images_u8, factors_packed, blur_k, out_dtype)


def augment_stereo_batch_fused(
    generator: torch.Generator,
    stereo_u8: torch.Tensor,
    config: AugmentConfig,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Augment the (N, H, W, 6) uint8 stereo batch through the fused chain:
    sample, pack, chain (kernel on CUDA), then noise + clamp. Returns
    ``out_dtype`` in [0, 1]; with bf16 the noise epilogue runs in bf16.

    ``config.impl``: "auto" dispatches on the tensor's device, "kernel"
    launches the kernel (raises on the CPU), "plain" runs the plain chain."""
    n = stereo_u8.shape[0]
    factors = sample_factors(generator, 2 * n, config)
    packed = _pack_factors(stereo_u8, factors, n)
    blur_k = config.blur_kernel_size if config.blur_enabled else 0
    chain = {
        "auto": pointwise_chain,
        "kernel": pointwise_chain_cuda,
        "plain": pointwise_chain_plain,
    }[config.impl]
    out = chain(stereo_u8.contiguous(), packed, blur_k, out_dtype)
    return noise_and_clip_stereo(
        generator,
        out,
        factors["noise_std"][:n],
        factors["noise_std"][n:],
        config.noise_std_max > 0.0,
    ).to(out_dtype)
