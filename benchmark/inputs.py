"""What a run feeds both sides: seeds, weights and data, all from ``--seed``.

Weights are the benchmark's, drawn on the device in two calls: one
truncated normal over every kernel (cut at two standard deviations, scaled
to std 1/sqrt(fan_in), the JAX package's and flax's LeCun-normal init; a
transposed convolution's fan_in is its input channels times 2 x 2), biases
zero, BatchNorm scale 1 and shift 0. A serving cell's running statistics
are the batch statistics of one training-mode forward of the reference
over seeded images, so its eval-mode activations keep their scale through
the network as a trained model's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import unet

_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut to [-2, 2]


def sub_seeds(seed: int, count: int) -> list[int]:
    """``count`` independent 63-bit seeds from the run's ``--seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, dtype=np.uint64)
    return [int(s) >> 1 for s in state]


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter of the configuration's StereoUNet, by state_dict name."""
    shapes = unet.leaf_shapes(cfg["base_channels"], cfg["in_channels"])
    kernels = {k: s for k, s in shapes.items() if len(s) == 4}
    flat = torch.empty(sum(math.prod(s) for s in kernels.values()), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator(device, seed))
    out, offset = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            fan_in = shape[0 if name.startswith("up") else 1] * shape[2] * shape[3]
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape) / (math.sqrt(fan_in) * _TRUNCATED_STD)
            offset += n
        elif ".block." in name and name.endswith(".weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def running_stats(p: dict[str, torch.Tensor], cfg: dict, images: torch.Tensor) -> dict:
    """Running mean and variance of every BatchNorm: the batch statistics of
    a training-mode reference forward over ``images`` (N, H, W, C) in [0, 1]."""
    stats: dict = {}
    with torch.no_grad():
        unet.forward(p, images, train=True, stats=stats)
    out = {}
    for name, (mean, var) in stats.items():
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = var
    return out


def state_dict(p: dict[str, torch.Tensor], cfg: dict, running: dict | None = None) -> dict:
    """``p`` with every BatchNorm buffer, as the port's module holds them."""
    sd = dict(p)
    for name in unet.bn_names(cfg["base_channels"], cfg["in_channels"]):
        c = p[f"{name}.weight"].shape[0]
        device = p[f"{name}.weight"].device
        if running is None:
            sd[f"{name}.running_mean"] = torch.zeros(c, device=device)
            sd[f"{name}.running_var"] = torch.ones(c, device=device)
        else:
            sd[f"{name}.running_mean"] = running[f"{name}.running_mean"]
            sd[f"{name}.running_var"] = running[f"{name}.running_var"]
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return sd


def serving_weights(cfg: dict, mix: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights and calibrated running statistics of a serving cell."""
    w_seed, x_seed = sub_seeds(seed, 2)
    p = weights(cfg, w_seed, device)
    x = torch.rand((mix["bn_calibration_images"], cfg["height"], cfg["width"],
                    cfg["in_channels"]), generator=generator(device, x_seed), device=device)
    return state_dict(p, cfg, running_stats(p, cfg, x))


def stereo_u8(g: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
    return torch.randint(0, 256, (n, h, w, 6), generator=g, device=g.device, dtype=torch.uint8)


def disparity(g: torch.Generator, n: int, h: int, w: int, max_disparity: float,
              invalid_share: float) -> torch.Tensor:
    """Targets in (0, max_disparity], a share of them invalid (0)."""
    u = torch.rand((2, n, h, w), generator=g, device=g.device)
    t = (1.0 - u[0]) * max_disparity
    return torch.where(u[1] < invalid_share, torch.zeros_like(t), t)
