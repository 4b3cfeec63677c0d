"""The augmentation chain on two hand-written CUDA kernels (``csrc/augment.cu``).

Counterpart of ``stereo_depth_estimation_tpu/ops/augment_pallas.py``: the
(N, H, W, 6) uint8 stereo batch goes through the colour chain, gamma and the
probabilistic blur of both views in one pass, written as f32 or bf16 in the
same NHWC layout. The contrast blend's per-view gray means come first, from
a reduction kernel that reads the batch once (the XLA reduce of the JAX
package's ``_pack_factors``). Factor sampling and the noise + clamp epilogue
stay plain PyTorch, as they are plain XLA in the JAX package.

On a height stripe (``augment_stereo_batch_fused(..., stripe=...)``) both
kernels run on the stripe, unchanged: the gray means become sums,
all-reduced over the spatial group and divided by the whole image's pixel
count; with the blur on, K1 runs on the stripe extended by ``k // 2`` uint8
rows of each neighbouring stripe and its output is cut back to the stripe,
so its reflect padding applies only at the image's top and bottom. Factors
and noise are drawn at the whole batch's shape (``ops/augment.py``).

``pointwise_chain`` and ``gray_means`` are ``torch.library`` custom ops
(``sde_torch::``) with fakes: their CPU implementations are the plain
versions (``pointwise_chain_plain``, ``gray_means_plain``), their CUDA
implementations launch the kernels; there is no fallback from a kernel to
its plain version. ``pointwise_chain_cuda`` and ``gray_means_cuda`` launch
their kernel or raise, and count their launches in ``.launches``.
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
from .halo import Stripe

# Factors per view in a packed row: brightness, contrast, saturation, hue,
# gamma, gray mean (of the brightness-adjusted view, for the contrast
# blend), blur-on flag, blur sigma.
_F_PER_VIEW = 8
MAX_BLUR_KERNEL = 15  # csrc/augment.cu kMaxHalf


def gray_means_plain(images_u8: torch.Tensor, brightness: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gray-mean kernel: (N, H, W, 6) uint8 and
    (2N,) brightness factors (left views, then right) -> (2N,) f32 mean luma
    of each brightness-adjusted view, in the same order."""
    n, h, w = images_u8.shape[:3]
    weights = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=images_u8.device)
    means = []
    for fb, sl in zip((brightness[:n], brightness[n:]), (slice(0, 3), slice(3, 6))):
        xb = (
            fb[:, None, None, None]
            * (images_u8[..., sl].to(torch.float32) * (1.0 / 255.0))
        ).clamp_(0.0, 1.0)
        means.append((xb * weights).sum(dim=(1, 2, 3)) / (h * w))
    return torch.cat(means)


def _pack_factors(
    images_u8: torch.Tensor, factors: dict[str, torch.Tensor], n: int,
    means_fn=None,
) -> torch.Tensor:
    """(N, 16) f32 per-image factor rows, left view then right, with the
    contrast gray means from ``means_fn`` (default: ``gray_means``, the
    kernel for a CUDA tensor)."""
    means = (means_fn or gray_means)(images_u8, factors["brightness"])
    rows = []
    for fv, gray_mean in zip(split_views(factors, n), (means[:n], means[n:])):
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


def _check_images(
    images_u8: torch.Tensor, other: torch.Tensor, name: str, shape: tuple[int, ...]
) -> None:
    """A contiguous (N, H, W, 6) uint8 CUDA batch and a contiguous f32
    tensor ``name`` of ``shape`` on its device."""
    if images_u8.device.type != "cuda":
        raise ValueError(
            f"the CUDA augmentation kernels take CUDA tensors, got {images_u8.device}"
        )
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4 or images_u8.shape[-1] != 6:
        raise ValueError(
            "images must be (N, H, W, 6) uint8, got "
            f"{tuple(images_u8.shape)} {images_u8.dtype}"
        )
    if other.dtype != torch.float32 or tuple(other.shape) != shape:
        raise ValueError(
            f"{name} must be {shape} float32, got {tuple(other.shape)} {other.dtype}"
        )
    if other.device != images_u8.device:
        raise ValueError(f"images and {name} must be on the same device")
    if not (images_u8.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"images and {name} must be contiguous")


def _check_inputs(
    images_u8: torch.Tensor, factors_packed: torch.Tensor, blur_k: int,
    out_dtype: torch.dtype,
) -> None:
    _check_images(images_u8, factors_packed, "factors", (images_u8.shape[0], 16))
    n, h, w, _ = images_u8.shape
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


class _LibraryKernel:
    """One ``extern "C"`` launcher of ``csrc/augment.cu``, bound at first use.
    ``launches`` counts its successful launches, and nothing else."""

    def __init__(self, name: str, argtypes: list) -> None:
        self.launches = 0
        self._name = name
        self._argtypes = argtypes
        self._fn = None
        self._error_string = None

    def _launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            lib = load_library("augment")
            if lib.augment_max_blur_kernel() != MAX_BLUR_KERNEL:
                raise RuntimeError("csrc/augment.cu and MAX_BLUR_KERNEL disagree")
            fn = getattr(lib, self._name)
            fn.argtypes = [*self._argtypes, ctypes.c_void_p]  # ..., stream
            fn.restype = ctypes.c_int
            err = lib.augment_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._error_string = fn, err
        with torch.cuda.device(device):
            code = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            reason = self._error_string(code).decode()
            raise RuntimeError(f"{self._name} launch failed: {reason}")
        self.launches += 1


class PointwiseChainKernel(_LibraryKernel):
    """Launches ``augment_pointwise_chain`` (K1) on the current stream."""

    def __init__(self) -> None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        super().__init__("augment_pointwise_chain", [ptr, ptr, ptr, i, i, i, i, i])

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
        n, h, w, _ = images_u8.shape
        self._launch(
            images_u8.device, images_u8.data_ptr(), factors_packed.data_ptr(),
            out.data_ptr(), n, h, w, blur_k, int(out_dtype == torch.bfloat16),
        )
        return out


class GrayMeansKernel(_LibraryKernel):
    """Launches ``augment_gray_means`` on the current stream."""

    def __init__(self) -> None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        super().__init__("augment_gray_means", [ptr, ptr, ptr, i, i, i])

    def __call__(self, images_u8: torch.Tensor, brightness: torch.Tensor) -> torch.Tensor:
        _check_images(images_u8, brightness, "brightness", (2 * images_u8.shape[0],))
        n, h, w, _ = images_u8.shape
        means = torch.empty((2 * n,), dtype=torch.float32, device=images_u8.device)
        self._launch(
            images_u8.device, images_u8.data_ptr(), brightness.data_ptr(),
            means.data_ptr(), n, h, w,
        )
        return means


pointwise_chain_cuda = PointwiseChainKernel()
gray_means_cuda = GrayMeansKernel()


# The custom ops: the plain version is the CPU implementation, the kernel
# the CUDA one, with fakes so that a traced program keeps them as calls.


@torch.library.custom_op("sde_torch::pointwise_chain", mutates_args=(), device_types="cpu")
def pointwise_chain(
    images_u8: torch.Tensor,
    factors_packed: torch.Tensor,
    blur_k: int = 0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(N, H, W, 6) uint8 + (N, 16) factors -> (N, H, W, 6) ``out_dtype``: the
    plain version for a CPU tensor, the CUDA kernel for a CUDA one."""
    return pointwise_chain_plain(images_u8, factors_packed, blur_k, out_dtype)


@pointwise_chain.register_kernel("cuda")
def _(images_u8, factors_packed, blur_k=0, out_dtype=torch.float32):
    return pointwise_chain_cuda(images_u8, factors_packed, blur_k, out_dtype)


@pointwise_chain.register_fake
def _(images_u8, factors_packed, blur_k=0, out_dtype=torch.float32):
    return images_u8.new_empty(images_u8.shape, dtype=out_dtype)


@torch.library.custom_op("sde_torch::gray_means", mutates_args=(), device_types="cpu")
def gray_means(images_u8: torch.Tensor, brightness: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 6) uint8 + (2N,) brightness -> (2N,) gray means: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA one."""
    return gray_means_plain(images_u8, brightness)


@gray_means.register_kernel("cuda")
def _(images_u8, brightness):
    return gray_means_cuda(images_u8, brightness)


@gray_means.register_fake
def _(images_u8, brightness):
    return brightness.new_empty((2 * images_u8.shape[0],), dtype=torch.float32)


def _stripe_means(means_fn, stripe: Stripe):
    """``means_fn`` of a height stripe turned into the whole image's means:
    the stripe's sums, summed over the spatial group, over the image's
    pixel count."""

    def means(images_u8: torch.Tensor, brightness: torch.Tensor) -> torch.Tensor:
        h, w = images_u8.shape[1:3]
        sums = stripe.spatial.sum_(means_fn(images_u8, brightness) * (h * w))
        return sums / (stripe.height * w)

    return means


def augment_stereo_batch_fused(
    generator: torch.Generator,
    stereo_u8: torch.Tensor,
    config: AugmentConfig,
    out_dtype: torch.dtype = torch.float32,
    stripe: Stripe | None = None,
) -> torch.Tensor:
    """Augment the (N, H, W, 6) uint8 stereo batch through the fused chain:
    sample, gray means and pack, chain (kernels on CUDA), then noise +
    clamp. Returns ``out_dtype`` in [0, 1]; with bf16 the noise epilogue
    runs in bf16. With ``stripe``, ``stereo_u8`` is that height stripe of
    the images (see the module docstring).

    ``config.impl``: "auto" dispatches on the tensor's device, "kernel"
    launches the kernels (raises on the CPU), "plain" runs the plain
    versions."""
    n = stereo_u8.shape[0]
    stereo_u8 = stereo_u8.contiguous()
    factors = sample_factors(generator, 2 * n, config)
    means_fn, chain = {
        "auto": (gray_means, pointwise_chain),
        "kernel": (gray_means_cuda, pointwise_chain_cuda),
        "plain": (gray_means_plain, pointwise_chain_plain),
    }[config.impl]
    if stripe is not None:
        means_fn = _stripe_means(means_fn, stripe)
    packed = _pack_factors(stereo_u8, factors, n, means_fn)
    blur_k = config.blur_kernel_size if config.blur_enabled else 0
    if stripe is not None and blur_k:
        extended, top = stripe.spatial.extend(stereo_u8, blur_k // 2)
        out = chain(extended, packed, blur_k, out_dtype)[:, top:top + stereo_u8.shape[1]]
    else:
        out = chain(stereo_u8, packed, blur_k, out_dtype)
    return noise_and_clip_stereo(
        generator,
        out,
        factors["noise_std"][:n],
        factors["noise_std"][n:],
        config.noise_std_max > 0.0,
        stripe,
    ).to(out_dtype)
