"""StereoUNet: 4-level encoder-decoder with dual disparity/log-variance heads.

Counterpart of ``stereo_depth_estimation_tpu/models/unet.py`` on its default
path (``skip_impl="concat"``, ``fused_block=False``, ``remat=False``):
ConvBlock = (Conv3x3 no-bias -> BatchNorm -> ReLU) x2; 6->32->64->128->256->512
channels at ``base_channels=32``; 2x2 max-pool down (``ops/pool.py``: the
CUDA kernels K2/K3 on the card); 2x2 stride-2 ConvTranspose
(with bias) up, then a skip concat; 1x1 ``softplus`` disparity head and 1x1
log-variance head clamped to [-6, 3], both in float32. 7,763,938 parameters at
base 32.

Parameter names are the reference PyTorch model's (``enc1.block.0.weight``,
``up4.weight``, ``disparity_head.weight``, ...), so a reference ``.pt``
state_dict loads as it is.

``forward`` takes and returns the JAX package's NHWC layout; inside, the NHWC
tensor is viewed as NCHW, which is the ``channels_last`` memory format, so no
copy is made, and the model runs channels_last throughout. BatchNorm is
``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1, biased variance to normalise,
unbiased variance into the running stats), the semantics the JAX package
re-implements. ``compute_dtype=torch.bfloat16`` runs the convolutions in bf16
under autocast while parameters and BatchNorm statistics stay float32.

Built with ``bn_group``, a ``torch.distributed`` group of more than one rank,
every BatchNorm is a ``MeshBatchNorm2d`` instead: its statistics are global
over the group's ranks, as the JAX BatchNorm's are over the mesh. Its
parameter and buffer names are ``nn.BatchNorm2d``'s, so checkpoints do not
change.

Built with ``spatial_group``, a ``SpatialGroup`` (``ops/halo.py``) of more
than one rank, the model runs on a height stripe of each image, as the JAX
model runs on a ``(data, spatial)`` mesh: every 3x3 convolution is a
``HaloConv2d``, which takes one row from each neighbouring stripe (zeros at
the image's top and bottom) and convolves with padding (0, 1). The pools,
the transposed convolutions (stride 2: each output row reads one input row),
the skip concatenations and the 1x1 heads are local to a stripe. With
``bn_group`` the world group, the BatchNorm statistics are global over data
rows and stripes. The parameter names stay ``nn.Conv2d``'s. Without a
spatial group none of this runs.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.halo import SpatialGroup
from ..ops.pool import max_pool_2x2


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks. The backward sums the incoming gradients
    over the ranks the same way: each rank's sums feed every rank's loss."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class MeshBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose training statistics are global over a group of ranks,
    computed as the JAX BatchNorm computes them
    (``stereo_depth_estimation_tpu/models/unet.py:64-79``): one all-reduce of
    the per-channel float32 sum and sum of squares and the element count,
    var = E[x^2] - E[x]^2, normalised in float32 and returned in the input's
    dtype; the unbiased factor n/(n-1) of the running variance takes the
    global n. Eval mode uses the running statistics and no collective.

    Not ``nn.SyncBatchNorm``: it refuses CPU tensors and gathers with
    ``all_gather``, which gloo does not run on CUDA tensors; this module
    needs only ``all_reduce``."""

    def __init__(self, num_features: int, group) -> None:
        super().__init__(num_features)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = self.num_features
        xf = x.float()
        local = torch.cat([
            xf.sum(dim=(0, 2, 3)),
            (xf * xf).sum(dim=(0, 2, 3)),
            xf.new_full((1,), xf.numel() // c),
        ])
        total = _AllReduceSum.apply(local, self.group)
        n = total[2 * c]
        mean = total[:c] / n
        var = total[c : 2 * c] / n - mean * mean
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            unbiased = var * (n / (n - 1.0).clamp(min=1.0))
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * unbiased)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * inv[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


def _batch_norm(channels: int, group) -> nn.BatchNorm2d:
    if group is not None and dist.get_world_size(group) > 1:
        return MeshBatchNorm2d(channels, group)
    return nn.BatchNorm2d(channels)


class HaloConv2d(nn.Conv2d):
    """3x3 convolution (no bias) of a height stripe: the stripe gets one row
    of each neighbouring stripe (``SpatialGroup.pad``), and the convolution
    pads only the width. The output stays channels_last."""

    def __init__(self, in_channels: int, out_channels: int, spatial: SpatialGroup) -> None:
        super().__init__(in_channels, out_channels, 3, padding=(0, 1), bias=False)
        self.spatial = spatial

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (N, C, h, W) channels_last is (N, h, W, C) in memory: the halo rows
        # are concatenated there and viewed back without a copy.
        padded = self.spatial.pad(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return super().forward(padded)


def _conv3x3(in_channels: int, out_channels: int,
             spatial: SpatialGroup | None) -> nn.Conv2d:
    if spatial is not None and spatial.size > 1:
        return HaloConv2d(in_channels, out_channels, spatial)
    return nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """(Conv3x3 no-bias -> BatchNorm -> ReLU) x2."""

    def __init__(self, in_channels: int, out_channels: int, bn_group=None,
                 spatial_group: SpatialGroup | None = None) -> None:
        super().__init__()
        self.block = nn.Sequential(
            _conv3x3(in_channels, out_channels, spatial_group),
            _batch_norm(out_channels, bn_group),
            nn.ReLU(inplace=True),
            _conv3x3(out_channels, out_channels, spatial_group),
            _batch_norm(out_channels, bn_group),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class StereoUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 6,
        out_channels: int = 1,
        base_channels: int = 32,
        compute_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        bn_group=None,
        spatial_group: SpatialGroup | None = None,
    ) -> None:
        """``generator`` (a CPU generator) re-draws every conv weight and bias
        from PyTorch's default distributions, so a seed fixes the weights.
        ``bn_group``: a ``torch.distributed`` group; with more than one rank
        the BatchNorm statistics are global over it (``MeshBatchNorm2d``).
        ``spatial_group``: with more than one rank the model runs on height
        stripes (``HaloConv2d``)."""
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.compute_dtype = compute_dtype
        c1 = base_channels
        c2, c3, c4, c5 = c1 * 2, c1 * 4, c1 * 8, c1 * 16
        self.enc1 = ConvBlock(in_channels, c1, bn_group, spatial_group)
        self.enc2 = ConvBlock(c1, c2, bn_group, spatial_group)
        self.enc3 = ConvBlock(c2, c3, bn_group, spatial_group)
        self.enc4 = ConvBlock(c3, c4, bn_group, spatial_group)
        self.bottleneck = ConvBlock(c4, c5, bn_group, spatial_group)
        self.up4 = nn.ConvTranspose2d(c5, c4, 2, stride=2)
        self.dec4 = ConvBlock(c4 + c4, c4, bn_group, spatial_group)
        self.up3 = nn.ConvTranspose2d(c4, c3, 2, stride=2)
        self.dec3 = ConvBlock(c3 + c3, c3, bn_group, spatial_group)
        self.up2 = nn.ConvTranspose2d(c3, c2, 2, stride=2)
        self.dec2 = ConvBlock(c2 + c2, c2, bn_group, spatial_group)
        self.up1 = nn.ConvTranspose2d(c2, c1, 2, stride=2)
        self.dec1 = ConvBlock(c1 + c1, c1, bn_group, spatial_group)
        # Both heads always exist (the reference model defines both).
        self.disparity_head = nn.Conv2d(c1, out_channels, 1)
        self.logvar_head = nn.Conv2d(c1, 1, 1)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device=resolve_device(device), memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
        weight and bias (kaiming_uniform with a=sqrt(5)), drawn from
        ``generator``; BatchNorm back to weight 1, bias 0, fresh stats."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                weight = module.weight
                fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
                bound = 1.0 / math.sqrt(fan_in)
                for p in (weight, module.bias):
                    if p is not None:
                        draw = torch.rand(p.shape, generator=generator)
                        p.copy_(draw * (2 * bound) - bound)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(
        self, x: torch.Tensor, return_uncertainty: bool = False
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """x: (N, H, W, in_channels), H and W divisible by 16 (on height
        stripes, each stripe's height). Train or eval BatchNorm follows
        ``self.training``.

        Returns disparity (N, H, W, out_channels), plus clamped logvar
        (N, H, W, 1) when ``return_uncertainty``, both float32."""
        h, w = x.shape[-3], x.shape[-2]
        if h % 16 or w % 16:
            raise ValueError(
                f"StereoUNet input height/width (a stripe's, on height stripes) must "
                f"be divisible by 16 (4 pool levels); got {h}x{w}."
            )
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last in memory
        if x.dtype != self.compute_dtype:
            x = x.to(self.compute_dtype)
        with torch.autocast(
            device_type=x.device.type,
            dtype=torch.bfloat16,
            enabled=self.compute_dtype == torch.bfloat16,
        ):
            s1 = self.enc1(x)
            s2 = self.enc2(max_pool_2x2(s1))
            s3 = self.enc3(max_pool_2x2(s2))
            s4 = self.enc4(max_pool_2x2(s3))
            b = self.bottleneck(max_pool_2x2(s4))
            d4 = self.dec4(torch.cat([self.up4(b), s4], dim=1))
            d3 = self.dec3(torch.cat([self.up3(d4), s3], dim=1))
            d2 = self.dec2(torch.cat([self.up2(d3), s2], dim=1))
            d1 = self.dec1(torch.cat([self.up1(d2), s1], dim=1))
            disp_pre = self.disparity_head(d1)
            logvar_pre = self.logvar_head(d1) if return_uncertainty else None
        # Head nonlinearities in float32 (disparity >= 0, logvar bounded).
        disparity = F.softplus(disp_pre.float()).permute(0, 2, 3, 1)
        if logvar_pre is None:
            return disparity
        logvar = logvar_pre.float().clamp(-6.0, 3.0).permute(0, 2, 3, 1)
        return disparity, logvar


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
