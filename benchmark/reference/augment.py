"""The reference's photometric augmentation, in float32, drawn from a
``torch.Generator`` in a fixed order.

Per view, independently for left and right: brightness, contrast (blend
with the view's mean gray of the brightness-adjusted image), saturation,
hue (rgb -> hsv -> rgb), gamma, a Gaussian blur with probability
``blur_prob`` (reflect padding, separable, sigma per view), then additive
Gaussian noise with a per-view std and a clamp to [0, 1]. Every stage
clamps to [0, 1]. Factor ranges: brightness, contrast and saturation
U[1 - j, 1 + j]; hue U[-j, j]; gamma U[1 - j, 1 + j]; blur sigma U[0.1,
sigma_max]; noise std U[0, noise_std_max].

The draws: one ``rand((8, 2N))`` of uniforms (rows: brightness, contrast,
saturation, hue, gamma, blur flag, blur sigma, noise std; columns: the N
left views, then the N right views), then one bfloat16 ``randn((N, H, W,
6))`` for the noise. A generator seeded alike gives the program's stream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRAY = (0.2989, 0.587, 0.114)


def _b(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _blend(img, other, ratio):
    return (ratio * img + (1.0 - ratio) * other).clamp(0.0, 1.0)


def _gray(img):
    return (GRAY[0] * img[..., 0] + GRAY[1] * img[..., 1] + GRAY[2] * img[..., 2])[..., None]


def _hue(img, shift):
    img = img.clamp(0.0, 1.0)
    r, g, b = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eq = maxc == minc
    cr = maxc - minc
    s = cr / torch.where(eq, torch.ones_like(maxc), maxc)
    crd = torch.where(eq, torch.ones_like(cr), cr)
    rc, gc, bc = (maxc - r) / crd, (maxc - g) / crd, (maxc - b) / crd
    # A channel within 1e-6 of the max counts as the max (the sector
    # formulas agree where channels tie).
    is_r = maxc - r <= 1e-6
    is_g = (maxc - g <= 1e-6) & ~is_r
    h = torch.where(is_r, bc - gc, torch.where(is_g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    h = torch.remainder(h + shift[:, None, None], 1.0) * 6.0
    out = [maxc - maxc * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)
           for k in (torch.remainder(n + h, 6.0) for n in (5.0, 3.0, 1.0))]
    return torch.stack(out, dim=-1)


def _blur(img, sigma, k):
    half = (k - 1) * 0.5
    x = torch.linspace(-half, half, k, device=img.device)
    w = torch.exp(-0.5 * (x[None] / sigma[:, None]) ** 2)
    w = w / w.sum(dim=1, keepdim=True)  # (N, k)
    nchw = img.permute(0, 3, 1, 2)
    n, c = nchw.shape[:2]
    pad = k // 2
    # Per-image kernels as a grouped convolution, rows then columns.
    rows = w[:, None, :, None].repeat_interleave(c, 0)
    cols = w[:, None, None, :].repeat_interleave(c, 0)
    flat = nchw.reshape(1, n * c, *nchw.shape[2:])
    flat = F.conv2d(F.pad(flat, (0, 0, pad, pad), mode="reflect"), rows, groups=n * c)
    flat = F.conv2d(F.pad(flat, (pad, pad, 0, 0), mode="reflect"), cols, groups=n * c)
    return flat.reshape(nchw.shape).permute(0, 2, 3, 1)


def _view(img, f, cfg):
    img = _blend(img, torch.zeros_like(img), _b(f["brightness"]))
    img = _blend(img, _gray(img).mean(dim=(1, 2, 3), keepdim=True), _b(f["contrast"]))
    img = _blend(img, _gray(img), _b(f["saturation"]))
    img = _hue(img, f["hue"])
    img = img.clamp(0.0, 1.0) ** _b(f["gamma"])
    img = img.clamp(0.0, 1.0)
    if cfg["blur_prob"] > 0.0 and cfg["blur_sigma_max"] > 0.0:
        blurred = _blur(img, f["sigma"], cfg["blur_kernel_size"])
        img = torch.where(_b(f["blur"]), blurred, img)
    return img


def augment(generator: torch.Generator, stereo_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(N, H, W, 6) uint8 -> (N, H, W, 6) float32 in [0, 1]; ``cfg`` holds the
    jitters, ``noise_std_max``, ``blur_prob``, ``blur_sigma_max`` and
    ``blur_kernel_size``."""
    n = stereo_u8.shape[0]
    device = stereo_u8.device
    u = torch.rand((8, 2 * n), generator=generator, device=device)

    def span(row, lo, hi):
        return lo + (hi - lo) * u[row]

    def jitter(row, j):
        return span(row, max(0.0, 1.0 - j), 1.0 + j)

    g_lo = max(0.1, 1.0 - cfg["gamma_jitter"])
    factors = {
        "brightness": jitter(0, cfg["brightness_jitter"]),
        "contrast": jitter(1, cfg["contrast_jitter"]),
        "saturation": jitter(2, cfg["saturation_jitter"]),
        "hue": span(3, -cfg["hue_jitter"], cfg["hue_jitter"]),
        "gamma": span(4, g_lo, max(g_lo, 1.0 + cfg["gamma_jitter"])),
        "blur": u[5] < cfg["blur_prob"],
        "sigma": span(6, 0.1, max(cfg["blur_sigma_max"], 0.1)),
        "noise": span(7, 0.0, cfg["noise_std_max"]),
    }
    x = stereo_u8.float() / 255.0
    views = [_view(x[..., 3 * v:3 * v + 3],
                   {k: f[v * n:(v + 1) * n] for k, f in factors.items()}, cfg)
             for v in (0, 1)]
    img = torch.cat(views, dim=-1)
    noise = torch.randn(img.shape, generator=generator, device=device,
                        dtype=torch.bfloat16).float()
    std = torch.cat([factors["noise"][:n, None].expand(-1, 3),
                     factors["noise"][n:, None].expand(-1, 3)], dim=1)
    return (img + noise * std[:, None, None, :]).clamp(0.0, 1.0)
