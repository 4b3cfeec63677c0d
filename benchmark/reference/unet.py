"""The StereoUNet as plain PyTorch functions over a dict of float32 tensors.

The reference StereoUNet (``src/foundation_stereo_depth/model.py`` of
sdfgeoff/stereo_depth_estimation): ConvBlock = (conv3x3 without bias ->
BatchNorm -> ReLU) x 2; channels 6 -> b -> 2b -> 4b -> 8b -> 16b; 2x2 max
pool down; 2x2 stride-2 transposed convolution (with bias) up, then the skip
concatenated after the up-path; a 1x1 disparity head through softplus and a
1x1 log-variance head clamped to [-6, 3]. BatchNorm: eps 1e-5, batch
statistics with the biased variance in training, running statistics in eval.

Tensors are NCHW and contiguous; weights are a dict keyed by the reference
model's state_dict names. Nothing here imports the program under test.

``precision`` says how every convolution's operands are held:
- ``"f32"``: float32 (the caller turns TF32 off);
- ``"bf16"``: both operands rounded to bfloat16, products summed by the
  library in float32 (the control of a float32 configuration);
- ``"fp8"``: both operands scaled per tensor onto float8 e4m3 and back, and
  the gradient arriving at the convolution onto float8 e5m2, so its data and
  weight gradients take fp8 operands too (the control of a bfloat16
  configuration); sums run in float32, as an fp8 tensor core's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

UPS = ("up4", "up3", "up2", "up1")
BN_EPS = 1e-5
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Gradient(torch.autograd.Function):
    """Identity whose backward rounds the gradient onto float8 e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, dy):
        return _round(dy, torch.float8_e5m2, _E5M2_MAX)


def block_channels(base: int, in_channels: int = 6) -> dict[str, tuple[int, int]]:
    """(in, out) channels of every ConvBlock."""
    c = [base << k for k in range(5)]
    return {
        "enc1": (in_channels, c[0]), "enc2": (c[0], c[1]), "enc3": (c[1], c[2]),
        "enc4": (c[2], c[3]), "bottleneck": (c[3], c[4]),
        "dec4": (2 * c[3], c[3]), "dec3": (2 * c[2], c[2]),
        "dec2": (2 * c[1], c[1]), "dec1": (2 * c[0], c[0]),
    }


def leaf_shapes(base: int, in_channels: int = 6) -> dict[str, tuple[int, ...]]:
    """Shape of every parameter, by state_dict name."""
    shapes: dict[str, tuple[int, ...]] = {}
    for name, (cin, cout) in block_channels(base, in_channels).items():
        shapes[f"{name}.block.0.weight"] = (cout, cin, 3, 3)
        shapes[f"{name}.block.3.weight"] = (cout, cout, 3, 3)
        for bn in (1, 4):
            shapes[f"{name}.block.{bn}.weight"] = (cout,)
            shapes[f"{name}.block.{bn}.bias"] = (cout,)
    for k, up in zip(range(4, 0, -1), UPS):
        cin, cout = base << k, base << (k - 1)
        shapes[f"{up}.weight"] = (cin, cout, 2, 2)
        shapes[f"{up}.bias"] = (cout,)
    for head in ("disparity_head", "logvar_head"):
        shapes[f"{head}.weight"] = (1, base, 1, 1)
        shapes[f"{head}.bias"] = (1,)
    return shapes


def bn_names(base: int, in_channels: int = 6) -> list[str]:
    """Prefixes of the BatchNorms (``enc1.block.1`` ...), in forward order."""
    return [f"{name}.block.{bn}" for name in block_channels(base, in_channels) for bn in (1, 4)]


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded onto float8 e4m3 (per-tensor scale); its gradient passes."""
    return x + (_round(x.detach(), torch.float8_e4m3fn, _E4M3_MAX) - x).detach()


def _operands(precision: str, *tensors: torch.Tensor) -> list[torch.Tensor]:
    if precision == "f32":
        return list(tensors)
    if precision == "bf16":
        return [t.to(torch.bfloat16) for t in tensors]
    if precision == "fp8":
        return [_fp8(t) for t in tensors]
    raise ValueError(f"precision must be f32, bf16 or fp8, got {precision!r}")


def _conv(x, w, precision, transposed=False):
    x, w = _operands(precision, x, w)
    y = F.conv_transpose2d(x, w, stride=2) if transposed else F.conv2d(
        x, w, padding=w.shape[-1] // 2)
    return _Fp8Gradient.apply(y) if precision == "fp8" and y.requires_grad else y.float()


def forward(p: dict[str, torch.Tensor], x: torch.Tensor, *, train: bool,
            precision: str = "f32", stats: dict | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N, H, W, C) float32 in [0, 1] -> (disparity, logvar), each (N, H, W)
    float32. ``train``: BatchNorm on the batch's statistics (else the
    running ones, ``<bn>.running_mean`` / ``.running_var`` in ``p``). With
    ``stats``, a dict, each BatchNorm's batch mean and unbiased variance are
    stored in it by name (the running statistics a fresh module would take
    with momentum 1)."""
    h = x.permute(0, 3, 1, 2).contiguous()

    def bn_relu(z, name):
        if train:
            if stats is not None:
                n = z.numel() // z.shape[1]
                mean = z.mean(dim=(0, 2, 3))
                stats[name] = (mean.detach(),
                               z.var(dim=(0, 2, 3), unbiased=n > 1).detach())
            y = F.batch_norm(z, None, None, p[f"{name}.weight"], p[f"{name}.bias"],
                             training=True, eps=BN_EPS)
        else:
            y = F.batch_norm(z, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                             p[f"{name}.weight"], p[f"{name}.bias"], training=False,
                             eps=BN_EPS)
        return F.relu(y)

    def block(name, z):
        z = bn_relu(_conv(z, p[f"{name}.block.0.weight"], precision), f"{name}.block.1")
        return bn_relu(_conv(z, p[f"{name}.block.3.weight"], precision), f"{name}.block.4")

    def up(name, z):
        y = _conv(z, p[f"{name}.weight"], precision, transposed=True)
        return y + p[f"{name}.bias"].view(1, -1, 1, 1)

    s1 = block("enc1", h)
    s2 = block("enc2", F.max_pool2d(s1, 2))
    s3 = block("enc3", F.max_pool2d(s2, 2))
    s4 = block("enc4", F.max_pool2d(s3, 2))
    b = block("bottleneck", F.max_pool2d(s4, 2))
    d = block("dec4", torch.cat([up("up4", b), s4], dim=1))
    d = block("dec3", torch.cat([up("up3", d), s3], dim=1))
    d = block("dec2", torch.cat([up("up2", d), s2], dim=1))
    d = block("dec1", torch.cat([up("up1", d), s1], dim=1))

    def head(name):
        return _conv(d, p[f"{name}.weight"], precision)[:, 0] + p[f"{name}.bias"]

    return F.softplus(head("disparity_head")), head("logvar_head").clamp(-6.0, 3.0)


def conv_macs(base: int, height: int, width: int, in_channels: int = 6) -> int:
    """Multiply-adds of one forward of one image: every convolution,
    transposed convolution and head, from the shapes alone."""
    macs = 0
    for name, (cin, cout) in block_channels(base, in_channels).items():
        level = {"enc1": 0, "dec1": 0, "enc2": 1, "dec2": 1, "enc3": 2, "dec3": 2,
                 "enc4": 3, "dec4": 3, "bottleneck": 4}[name]
        pixels = (height >> level) * (width >> level)
        macs += pixels * 9 * (cin * cout + cout * cout)
    for k in range(4, 0, -1):  # up-convolutions read level k's pixels
        pixels = (height >> k) * (width >> k)
        macs += pixels * 4 * (base << k) * (base << (k - 1))
    macs += 2 * height * width * base  # the two 1x1 heads
    return macs


def parameter_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape for a configuration file of this model (a
    reference module's part of the interface a configuration's
    ``reference`` key names)."""
    return leaf_shapes(cfg["base_channels"], cfg["in_channels"])


def forward_flops(cfg: dict) -> int:
    """FLOPs of one forward of one pair at the configuration's size, 2 a
    multiply-add."""
    return 2 * conv_macs(cfg["base_channels"], cfg["height"], cfg["width"], cfg["in_channels"])
