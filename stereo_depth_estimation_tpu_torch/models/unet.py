"""StereoUNet: 4-level encoder-decoder with dual disparity/log-variance heads.

Counterpart of ``stereo_depth_estimation_tpu/models/unet.py`` on its default
path (``skip_impl="concat"``, ``fused_block=False``, ``remat=False``):
ConvBlock = (Conv3x3 no-bias -> BatchNorm -> ReLU) x2; 6->32->64->128->256->512
channels at ``base_channels=32``; 2x2 max-pool down; 2x2 stride-2 ConvTranspose
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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device


class ConvBlock(nn.Module):
    """(Conv3x3 no-bias -> BatchNorm -> ReLU) x2."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
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
    ) -> None:
        """``generator`` (a CPU generator) re-draws every conv weight and bias
        from PyTorch's default distributions, so a seed fixes the weights."""
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.compute_dtype = compute_dtype
        c1 = base_channels
        c2, c3, c4, c5 = c1 * 2, c1 * 4, c1 * 8, c1 * 16
        self.enc1 = ConvBlock(in_channels, c1)
        self.enc2 = ConvBlock(c1, c2)
        self.enc3 = ConvBlock(c2, c3)
        self.enc4 = ConvBlock(c3, c4)
        self.bottleneck = ConvBlock(c4, c5)
        self.up4 = nn.ConvTranspose2d(c5, c4, 2, stride=2)
        self.dec4 = ConvBlock(c4 + c4, c4)
        self.up3 = nn.ConvTranspose2d(c4, c3, 2, stride=2)
        self.dec3 = ConvBlock(c3 + c3, c3)
        self.up2 = nn.ConvTranspose2d(c3, c2, 2, stride=2)
        self.dec2 = ConvBlock(c2 + c2, c2)
        self.up1 = nn.ConvTranspose2d(c2, c1, 2, stride=2)
        self.dec1 = ConvBlock(c1 + c1, c1)
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
        """x: (N, H, W, in_channels), H and W divisible by 16. Train or eval
        BatchNorm follows ``self.training``.

        Returns disparity (N, H, W, out_channels), plus clamped logvar
        (N, H, W, 1) when ``return_uncertainty``, both float32."""
        h, w = x.shape[-3], x.shape[-2]
        if h % 16 or w % 16:
            raise ValueError(
                f"StereoUNet input height/width must be divisible by 16 "
                f"(4 pool levels); got {h}x{w}."
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
            s2 = self.enc2(F.max_pool2d(s1, 2))
            s3 = self.enc3(F.max_pool2d(s2, 2))
            s4 = self.enc4(F.max_pool2d(s3, 2))
            b = self.bottleneck(F.max_pool2d(s4, 2))
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
