"""Batched photometric augmentation in plain PyTorch (NHWC, per-image factors).

Counterpart of ``stereo_depth_estimation_tpu/ops/augment.py``. Stage order:
brightness, contrast, saturation, hue, gamma, (probabilistic) Gaussian blur,
additive Gaussian noise, final clamp to [0, 1]. Factor distributions (defaults
in parentheses):

- brightness/contrast/saturation factor ~ U[max(0, 1-j), 1+j]   (j=0.25)
- hue shift ~ U[-j, j]                                          (j=0.09)
- gamma ~ U[max(0.1, 1-j), max(low, 1+j)]                       (j=0.2)
- blur applied with prob p (0.03), sigma ~ U[0.1, sigma_max(1.0)], k=5
- noise std ~ U[0, max] (0.05)

The colour math is the JAX package's, formula for formula: blend + clamp per
stage, rgb->hsv with the tolerant (eps=1e-6) max-channel rule, the branchless
hsv->rgb, and floor modulo (``torch.remainder``, never ``torch.fmod``: hue
shifts are negative half the time).

This module is the CPU path of the augmentation and, on the card, the oracle
that the CUDA kernel (``ops/augment_cuda.py``) is held against. Randomness
comes from an explicit ``torch.Generator``; its device decides where the
factors are drawn.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)  # torchvision rgb_to_grayscale


@dataclass(frozen=True)
class AugmentConfig:
    brightness_jitter: float = 0.25
    contrast_jitter: float = 0.25
    saturation_jitter: float = 0.25
    hue_jitter: float = 0.09
    gamma_jitter: float = 0.2
    noise_std_max: float = 0.05
    blur_prob: float = 0.03
    blur_sigma_max: float = 1.0
    blur_kernel_size: int = 5
    # "auto": the CUDA kernel for CUDA tensors, the plain chain for CPU
    # tensors. "plain" / "kernel" ask for one of them explicitly; "kernel"
    # on a CPU tensor raises.
    impl: str = "auto"

    def __post_init__(self) -> None:
        if self.impl not in ("auto", "plain", "kernel"):
            raise ValueError(f"impl must be auto|plain|kernel, got {self.impl}")
        if not 0.0 <= self.blur_prob <= 1.0:
            raise ValueError(f"blur_prob must be in [0, 1], got {self.blur_prob}")
        if self.blur_kernel_size < 3 or self.blur_kernel_size % 2 == 0:
            raise ValueError(
                f"blur_kernel_size must be odd and >= 3, got {self.blur_kernel_size}"
            )
        if self.saturation_jitter < 0.0:
            raise ValueError(
                f"saturation_jitter must be >= 0, got {self.saturation_jitter}"
            )
        if self.gamma_jitter < 0.0:
            raise ValueError(f"gamma_jitter must be >= 0, got {self.gamma_jitter}")

    @property
    def blur_enabled(self) -> bool:
        return self.blur_prob > 0.0 and self.blur_sigma_max > 0.0


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W, 1), torchvision weights."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    gray = _GRAY_WEIGHTS[0] * r + _GRAY_WEIGHTS[1] * g + _GRAY_WEIGHTS[2] * b
    return gray[..., None]


def _bcast(factor: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1, 1, 1) for NHWC broadcasting."""
    return factor[:, None, None, None]


def _blend(img: torch.Tensor, other, ratio: torch.Tensor) -> torch.Tensor:
    return (ratio * img + (1.0 - ratio) * other).clamp(0.0, 1.0)


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), _bcast(factor))


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = rgb_to_grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean, _bcast(factor))


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, rgb_to_grayscale(img), _bcast(factor))


def _rgb_to_hsv(
    img: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torchvision _rgb2hsv float semantics, NHWC -> (h, s, v) planes,
    with the JAX package's tolerant max-channel rule."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    # A channel within eps of the max counts as the max. The three sector
    # formulas agree where two channels tie, so this moves h by ~eps at
    # most, and two evaluations of the chain that differ by an ulp (the
    # kernel and this version) pick the same formula.
    eps = 1e-6
    is_r = maxc - r <= eps
    is_g = (maxc - g <= eps) & ~is_r
    is_b = ~is_r & ~is_g
    hr = torch.where(is_r, bc - gc, 0.0)
    hg = torch.where(is_g, 2.0 + rc - bc, 0.0)
    hb = torch.where(is_b, 4.0 + gc - rc, 0.0)
    h = torch.remainder((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Branchless hsv->rgb: channel(n) = v - v*s*clip(min(k, 4-k), 0, 1) with
    k = (n + 6h) mod 6, the classic sector table written without a select
    on a floored sector index (continuous in h)."""
    h6 = h * 6.0

    def channel(n: float) -> torch.Tensor:
        k = torch.remainder(n + h6, 6.0)
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def adjust_hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    h, s, v = _rgb_to_hsv(img.clamp(0.0, 1.0))
    h = torch.remainder(h + shift[:, None, None], 1.0)
    return _hsv_to_rgb(h, s, v)


def adjust_gamma(
    img: torch.Tensor, gamma: torch.Tensor, gain: float = 1.0
) -> torch.Tensor:
    return (gain * img.clamp(0.0, 1.0) ** _bcast(gamma)).clamp(0.0, 1.0)


def gaussian_blur(
    img: torch.Tensor, sigma: torch.Tensor, kernel_size: int
) -> torch.Tensor:
    """Separable Gaussian blur of (N, H, W, C), reflect padding, per-image
    sigma (N,), H first then W; k shifted multiply-adds per axis."""
    k = kernel_size
    half = (k - 1) * 0.5
    x = torch.linspace(-half, half, k, device=sigma.device)
    pdf = torch.exp(-0.5 * (x[None, :] / sigma[:, None]) ** 2)  # (N, k)
    w = pdf / pdf.sum(dim=1, keepdim=True)
    pad = k // 2

    def blur_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
        # F.pad's reflect mode pads the trailing dims of an (N, C, H, W)
        # tensor; the NHWC image is viewed that way without a copy.
        nchw = v.permute(0, 3, 1, 2)
        pads = (0, 0, pad, pad) if axis == 1 else (pad, pad, 0, 0)
        vp = F.pad(nchw, pads, mode="reflect").permute(0, 2, 3, 1)
        size = v.shape[axis]
        out = torch.zeros_like(v)
        for tap in range(k):
            shifted = vp.narrow(axis, tap, size)
            out = out + shifted * w[:, tap][:, None, None, None]
        return out

    return blur_axis(blur_axis(img, 1), 2)  # H, then W


def sample_factors(
    generator: torch.Generator, n: int, config: AugmentConfig
) -> dict[str, torch.Tensor]:
    """Per-image random factors, one independent draw per image (shape (N,)),
    on ``generator.device``. The stream differs from the JAX package's; the
    ranges and distributions are the same."""
    device = generator.device
    u = torch.rand((8, n), generator=generator, device=device)

    def uniform(row: int, lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * u[row]

    ones = torch.ones((n,), device=device)
    zeros = torch.zeros((n,), device=device)

    def jitter(row: int, j: float) -> torch.Tensor:
        return uniform(row, max(0.0, 1.0 - j), 1.0 + j) if j > 0.0 else ones

    hue = (
        uniform(3, -config.hue_jitter, config.hue_jitter)
        if config.hue_jitter > 0.0
        else zeros
    )
    if config.gamma_jitter > 0.0:
        g_lo = max(0.1, 1.0 - config.gamma_jitter)
        g_hi = max(g_lo, 1.0 + config.gamma_jitter)
        gamma = uniform(4, g_lo, g_hi)
    else:
        gamma = ones
    blur_on = (
        u[5] < config.blur_prob
        if config.blur_enabled
        else torch.zeros((n,), dtype=torch.bool, device=device)
    )
    sigma = uniform(6, 0.1, max(config.blur_sigma_max, 0.1))
    noise_std = (
        uniform(7, 0.0, config.noise_std_max) if config.noise_std_max > 0.0 else zeros
    )
    return {
        "brightness": jitter(0, config.brightness_jitter),
        "contrast": jitter(1, config.contrast_jitter),
        "saturation": jitter(2, config.saturation_jitter),
        "hue": hue,
        "gamma": gamma,
        "blur_on": blur_on,
        "blur_sigma": sigma,
        "noise_std": noise_std,
    }


def _chain_pre_noise(
    images: torch.Tensor, factors: dict[str, torch.Tensor], config: AugmentConfig
) -> torch.Tensor:
    """Pointwise stages + probabilistic blur, WITHOUT noise/clamp. (N,H,W,3)."""
    img = images.to(torch.float32)
    img = adjust_brightness(img, factors["brightness"])
    img = adjust_contrast(img, factors["contrast"])
    img = adjust_saturation(img, factors["saturation"])
    img = adjust_hue(img, factors["hue"])
    img = adjust_gamma(img, factors["gamma"])
    if config.blur_enabled:
        blurred = gaussian_blur(img, factors["blur_sigma"], config.blur_kernel_size)
        img = torch.where(_bcast(factors["blur_on"]) > 0, blurred, img)
    return img


def augment_with_factors(
    generator: torch.Generator,
    images: torch.Tensor,
    factors: dict[str, torch.Tensor],
    config: AugmentConfig,
) -> torch.Tensor:
    """Apply the augmentation chain with given factors. images: (N,H,W,3)."""
    img = _chain_pre_noise(images, factors, config)
    if config.noise_std_max > 0.0:
        noise = torch.randn(
            img.shape, generator=generator, device=img.device, dtype=img.dtype
        )
        img = img + noise * _bcast(factors["noise_std"])
    return img.clamp(0.0, 1.0)


def noise_and_clip_stereo(
    generator: torch.Generator,
    stereo: torch.Tensor,
    noise_std_left: torch.Tensor,
    noise_std_right: torch.Tensor,
    enabled: bool,
) -> torch.Tensor:
    """Joint additive-noise + clamp epilogue over the (N,H,W,6) stereo tensor.

    One (N,H,W,6) normal draw with the per-view std broadcast per channel is
    distributionally the same as two independent per-view draws. The draw is
    bfloat16 and the arithmetic runs in bfloat16 for bfloat16 inputs (noise
    std ~0.03 dwarfs bf16 rounding), float32 otherwise."""
    dtype = stereo.dtype if stereo.dtype == torch.bfloat16 else torch.float32
    img = stereo.to(dtype)
    if enabled:
        std6 = torch.cat(
            [
                noise_std_left[:, None].expand(-1, 3),
                noise_std_right[:, None].expand(-1, 3),
            ],
            dim=1,
        ).to(dtype)
        noise = torch.randn(
            img.shape, generator=generator, device=img.device, dtype=torch.bfloat16
        )
        img = img + noise.to(dtype) * std6[:, None, None, :]
    return img.clamp(0.0, 1.0)


def split_views(
    factors: dict[str, torch.Tensor], n: int
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Factors drawn for 2N views -> (left rows [:N], right rows [N:])."""
    return (
        {name: v[:n] for name, v in factors.items()},
        {name: v[n:] for name, v in factors.items()},
    )


def augment_stereo_batch(
    generator: torch.Generator, stereo: torch.Tensor, config: AugmentConfig
) -> torch.Tensor:
    """Augment the (N,H,W,6) float stereo concat in [0, 1]; left and right
    views get independent factors, each view processed as a channel slice."""
    n = stereo.shape[0]
    f_left, f_right = split_views(sample_factors(generator, 2 * n, config), n)
    left = _chain_pre_noise(stereo[..., :3], f_left, config)
    right = _chain_pre_noise(stereo[..., 3:], f_right, config)
    return noise_and_clip_stereo(
        generator,
        torch.cat([left, right], dim=-1),
        f_left["noise_std"],
        f_right["noise_std"],
        config.noise_std_max > 0.0,
    )
