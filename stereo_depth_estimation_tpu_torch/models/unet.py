"""StereoUNet: 4-level encoder-decoder with dual disparity/log-variance heads.

Counterpart of ``stereo_depth_estimation_tpu/models/unet.py``: ConvBlock =
(Conv3x3 no-bias -> BatchNorm -> ReLU) x2; 6->32->64->128->256->512
channels at ``base_channels=32``; 2x2 max-pool down (``ops/pool.py``: the
CUDA kernels K2/K3 on the card); 2x2 stride-2 ConvTranspose
(with bias) up, then a skip concat; 1x1 ``softplus`` disparity head and 1x1
log-variance head clamped to [-6, 3], both in float32. 7,763,938 parameters at
base 32.
A fresh model is drawn from the JAX package's initialisers (truncated
LeCun-normal kernels, zero biases: ``StereoUNet.reset_parameters``).

Parameter names are the reference PyTorch model's (``enc1.block.0.weight``,
``up4.weight``, ``disparity_head.weight``, ...), so a reference ``.pt``
state_dict loads as it is.

``forward`` takes and returns the JAX package's NHWC layout; inside, the NHWC
tensor is viewed as NCHW, which is the ``channels_last`` memory format, so no
copy is made, and the model runs channels_last throughout. Every BatchNorm is
a ``MeshBatchNorm2d``, an ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1, biased
variance to normalise, unbiased variance into the running stats, the
semantics the JAX package re-implements) whose training statistics and the
ReLU after it run on the hand-written kernels BN1-BN4 (``ops/batchnorm.py``,
``_BatchNormReLU``); eval mode stays on cuDNN's BatchNorm. Its parameter and
buffer names are ``nn.BatchNorm2d``'s, so checkpoints do not change.
``compute_dtype=torch.bfloat16`` runs the convolutions in bf16 under
autocast while parameters and BatchNorm statistics stay float32. There a
convolution whose channel count is not a multiple of 8 leaves cuDNN's fast
tensor-core kernels (on an H100 the 1-channel heads' weight gradients ran
on ``wgrad2d_shmem_tiling``, a direct kernel, and enc1's 6-channel forward
took twice its time on 8), so the two that have one run on zero-padded
channels: the input is padded to 8 channels before the NCHW view and
enc1's first weight gets zero input channels at call time (autograd slices
its gradient back), and the heads' weights with zero rows form one 1x1
conv of 8 outputs over ``d1``. The padded products are exact zeros; parameters and
checkpoints do not change. ``padded_convs.launches`` counts those
convolutions (2 an eager bf16 forward, 0 in float32).

Built with ``bn_group``, a ``torch.distributed`` group of more than one rank,
the BatchNorm statistics are global over the group's ranks, as the JAX
BatchNorm's are over the mesh: the kernels' sums are all-reduced before the
statistics are formed from them.

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

``bn_stats_dtype`` (the JAX model's knob of that name, no CLI sets it):
the training batch mean and E[x^2] are reduced in that dtype, then cast to
float32 (``MeshBatchNorm2d``, var = E[x^2] - E[x]^2); running statistics
and the scale stay float32.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops import batchnorm
from ..ops.halo import SpatialGroup
from ..ops.loss import LossStats, heteroscedastic_laplace_nll
from ..ops.pool import max_pool_2x2


_STATS_DTYPES = (torch.float32, torch.bfloat16)
# cuDNN's 16-bit tensor-core convolutions take channel counts that are
# multiples of this; other counts are zero-padded up to it.
_CHANNEL_ALIGN = 8


def _channel_pad(channels: int, dtype: torch.dtype) -> int:
    """Zero channels that make ``channels`` a multiple of 8 for a 16-bit
    convolution; 0 in float32, which is left as it is."""
    return -channels % _CHANNEL_ALIGN if dtype.itemsize == 2 else 0


class PaddedConvCounter:
    """``launches`` counts the StereoUNet's convolutions run on zero-padded
    channels (enc1's first and the fused heads) in eager mode, and nothing
    else. A compiled graph runs them uncounted: a Python count read while
    tracing is a guard, and would compile the graph anew every call."""

    def __init__(self) -> None:
        self.launches = 0

    def count(self) -> None:
        if not torch.compiler.is_compiling():
            self.launches += 1


padded_convs = PaddedConvCounter()


def _bn_forward(z, gamma, beta, running, eps, momentum, bf16_stats, group, relu: bool):
    """Training BatchNorm (+ ReLU) of channels_last ``z`` on BN1 and BN2:
    (y, stats), stats = (mean, var, scale, n) as ``ops/batchnorm.py`` lays
    them out. BN1's second pass forms them and updates the ``running``
    buffers (running_mean, running_var, num_batches_tracked); with
    ``group`` the (2C + 1) sums are all-reduced first, so the statistics
    are the group's, and the epilogue runs alone on them."""
    if group is None:
        return batchnorm.bn_relu_forward(z, gamma, beta, *running, eps, momentum, bf16_stats,
                                         relu)
    total = batchnorm.bn_stats(z, bf16_stats)
    dist.all_reduce(total, group=group)
    stats = batchnorm.bn_moments(total, gamma, *running, eps, momentum)
    return batchnorm.bn_relu_fwd(z, stats, beta, relu), stats


def _bn_backward(dy, z, stats, beta, eps, group, relu: bool):
    """The textbook batch-statistic backward of ``_bn_forward`` on BN3 and
    BN4 (JAX ``_fcbr_bwd``): (dz, dgamma, dbeta). BN3's second pass forms
    BN4's coefficients and dgamma, dbeta; with ``group`` its two (C,) sums
    are all-reduced first, and dgamma and dbeta stay this rank's share, as
    autograd's are for a weight used on this rank."""
    # The incoming gradient's layout is autograd's; the kernels read rows.
    dy = dy.contiguous(memory_format=torch.channels_last if dy.ndim == 4
                       else torch.channels_last_3d)
    if group is None:
        dz, coef = batchnorm.bn_relu_backward(dy, z, stats, beta, eps, relu)
    else:
        local = batchnorm.bn_relu_bwd_sums(dy, z, stats, beta, relu)
        total = local.clone()
        dist.all_reduce(total, group=group)
        coef = batchnorm.bn_bwd_coefficients(total, local, stats, eps)
        dz = batchnorm.bn_relu_bwd_dx(dy, z, stats, beta, coef, relu)
    c = z.shape[1]
    return dz, coef[c:2 * c], coef[:c]


class _BatchNormReLU(torch.autograd.Function):
    """Training batch-statistic BatchNorm, and the ReLU after it if
    ``relu``, on the kernels of ``ops/batchnorm.py``: BN1 (which updates the
    ``running`` buffers), BN2; backward BN3, BN4; with ``group`` the
    all-reduces of the sums and the epilogues between them. It saves the
    BatchNorm input, the statistics and beta."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, num_batches_tracked, eps,
                momentum, bf16_stats, group, relu):
        y, stats = _bn_forward(x, gamma, beta, (running_mean, running_var, num_batches_tracked),
                               eps, momentum, bf16_stats, group, relu)
        ctx.save_for_backward(x, stats, beta)
        ctx.eps, ctx.group, ctx.relu = eps, group, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats, beta = ctx.saved_tensors
        dx, dgamma, dbeta = _bn_backward(dy, x, stats, beta, ctx.eps, ctx.group, ctx.relu)
        return dx, dgamma, dbeta, None, None, None, None, None, None, None, None


class MeshBatchNorm2d(nn.BatchNorm2d):
    """The model's BatchNorm. Its training statistics are computed as the
    JAX BatchNorm computes them (``stereo_depth_estimation_tpu/models/
    unet.py:64-79``): the per-channel sum and sum of squares reduced in
    ``stats_dtype`` (the JAX model's ``bn_stats_dtype``: float32 or
    bfloat16) and cast to float32, var = E[x^2] - E[x]^2, normalised in
    float32 and returned in the input's dtype. With ``group`` (several
    ranks) the sums and the element count are all-reduced, so the statistics
    are global over the group, and the unbiased factor n/(n-1) of the
    running variance takes the global n. Eval mode is ``nn.BatchNorm2d``'s:
    the running statistics, no collective.

    In training it runs on the BatchNorm kernels (``_BatchNormReLU``), which
    also update the running buffers, and ``forward_relu`` takes the ReLU that
    follows it into them. The input must be channels_last.

    Not ``nn.SyncBatchNorm``: it refuses CPU tensors and gathers with
    ``all_gather``, which gloo does not run on CUDA tensors; this module
    needs only ``all_reduce``."""

    def __init__(self, num_features: int, group=None,
                 stats_dtype: torch.dtype = torch.float32) -> None:
        if stats_dtype not in _STATS_DTYPES:
            raise ValueError(f"bn_stats_dtype must be float32 or bfloat16, got {stats_dtype}")
        super().__init__(num_features)
        self.group = group
        self.bf16_stats = stats_dtype == torch.bfloat16

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._train(x, relu=False) if self.training else super().forward(x)

    def forward_relu(self, x: torch.Tensor) -> torch.Tensor:
        """relu(self(x)), the ReLU taken into the kernels in training."""
        return self._train(x, relu=True) if self.training else F.relu(super().forward(x))

    def _train(self, x: torch.Tensor, relu: bool) -> torch.Tensor:
        return _BatchNormReLU.apply(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, self.num_batches_tracked, self.eps,
                                    self.momentum, self.bf16_stats, self.group, relu)


class MeshBatchNorm3d(MeshBatchNorm2d):
    """``MeshBatchNorm2d`` over (N, C, D, H, W) volumes: in training the
    kernels read a channels_last_3d volume as its (N*D*H*W, C) rows (an input
    in another layout is made channels_last_3d first); eval mode is
    ``nn.BatchNorm3d``'s. Parameter and buffer names are
    ``nn.BatchNorm3d``'s."""

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.dim() != 5:
            raise ValueError(f"expected 5D input (got {input.dim()}D input)")

    def _train(self, x: torch.Tensor, relu: bool) -> torch.Tensor:
        return super()._train(x.contiguous(memory_format=torch.channels_last_3d), relu)


class HaloConv2d(nn.Conv2d):
    """3x3 convolution (no bias) of a height stripe: the stripe gets one row
    of each neighbouring stripe (``SpatialGroup.pad``), and the convolution
    pads only the width. The output stays channels_last."""

    def __init__(self, in_channels: int, out_channels: int, spatial: SpatialGroup) -> None:
        super().__init__(in_channels, out_channels, 3, padding=(0, 1), bias=False)
        self.spatial = spatial

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
        # (N, C, h, W) channels_last is (N, h, W, C) in memory: the halo rows
        # are concatenated there and viewed back without a copy.
        x = self.spatial.pad(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return super()._conv_forward(x, weight, bias)


def _conv3x3(in_channels: int, out_channels: int,
             spatial: SpatialGroup | None) -> nn.Conv2d:
    if spatial is not None and spatial.size > 1:
        return HaloConv2d(in_channels, out_channels, spatial)
    return nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` (no bias), where ``x`` may carry zero channels past
    ``conv.in_channels`` (the model's padded input): the weight gets as many
    zero input channels, so its gradient is sliced back to its shape."""
    weight = conv.weight
    extra = x.shape[1] - weight.shape[1]
    if extra:
        weight = F.pad(weight, (0, 0, 0, 0, 0, extra))
        padded_convs.count()
    return conv._conv_forward(x, weight, None)


class ConvBlock(nn.Module):
    """(Conv3x3 no-bias -> BatchNorm -> ReLU) x2. ``forward(x, skip)`` of a
    decoder block concatenates the up-path and the skip tensors first. The
    modules are the reference's ``block.0`` ... ``block.5``."""

    def __init__(self, in_channels: int, out_channels: int, bn_group=None,
                 spatial_group: SpatialGroup | None = None, *,
                 bn_stats_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        group = bn_group if bn_group is not None and dist.get_world_size(bn_group) > 1 else None
        self.block = nn.Sequential(
            _conv3x3(in_channels, out_channels, spatial_group),
            MeshBatchNorm2d(out_channels, group, bn_stats_dtype),
            nn.ReLU(inplace=True),
            _conv3x3(out_channels, out_channels, spatial_group),
            MeshBatchNorm2d(out_channels, group, bn_stats_dtype),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        y = _bn_relu(self.block[1], self.block[2], _conv(self.block[0], x))
        return _bn_relu(self.block[4], self.block[5], _conv(self.block[3], y))


def _bn_relu(bn: MeshBatchNorm2d, relu: nn.ReLU, z: torch.Tensor) -> torch.Tensor:
    """relu(bn(z)); in training the BatchNorm takes the ReLU into its kernels
    (``forward_relu``), and the ``nn.ReLU`` module is skipped."""
    if bn.training:
        return bn.forward_relu(z)
    return relu(bn(z))


class _Head(nn.Conv2d):
    """A 1x1 head: the convolution in the compute dtype, then its bias added
    in float32. Fused into a bf16 convolution, the bias would be rounded
    with the output to bf16, which drops its part below the output's bf16
    spacing alike at every pixel (a mean logvar offset: ``head_rounding.py``
    measures it), while Inductor adds it in float32 and keeps the sum; with
    the add in float32 the eager and the compiled model compute the same
    head."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight, None) + self.bias.view(1, -1, 1, 1)


def _run_heads(heads: tuple[_Head, ...], x: torch.Tensor,
               dtype: torch.dtype) -> list[torch.Tensor]:
    """Each head of ``x``. Where their rows together are not a multiple of 8
    in a 16-bit ``dtype``, their weights and zero rows form one 1x1 conv
    that reads ``x`` once, split by head; each bias is added in float32
    after it, as ``_Head`` adds it."""
    rows = [head.out_channels for head in heads]
    extra = _channel_pad(sum(rows), dtype)
    if not extra:
        return [head(x) for head in heads]
    weight = F.pad(torch.cat([head.weight for head in heads]), (0, 0, 0, 0, 0, 0, 0, extra))
    padded_convs.count()
    parts = F.conv2d(x, weight).split([*rows, extra], dim=1)
    return [part + head.bias.view(1, -1, 1, 1) for part, head in zip(parts, heads)]


# The std of a unit normal truncated to [-2, 2] (flax ``variance_scaling``).
_TRUNCATED_NORMAL_STD = 0.87962566103423978


class StereoUNet(nn.Module):
    # What the train and eval steps ask of the model (parallel/train_step.py):
    # the forward's keyword arguments and ``step_loss`` on its outputs.
    step_kwargs = {"return_uncertainty": True}

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
        bn_stats_dtype: torch.dtype = torch.float32,
    ) -> None:
        """Every parameter is drawn as the JAX package draws a fresh model
        (``reset_parameters``), from ``generator`` (a CPU generator) if
        given, so a seed fixes the weights, else from torch's default one.
        ``bn_group``: a ``torch.distributed`` group; with more than one rank
        the BatchNorm statistics are global over it (``MeshBatchNorm2d``).
        ``spatial_group``: with more than one rank the model runs on height
        stripes (``HaloConv2d``). ``bn_stats_dtype``: the dtype of the
        training BatchNorm sums (module docstring)."""
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.compute_dtype = compute_dtype
        c1 = base_channels
        c2, c3, c4, c5 = c1 * 2, c1 * 4, c1 * 8, c1 * 16
        block = functools.partial(ConvBlock, bn_group=bn_group, spatial_group=spatial_group,
                                  bn_stats_dtype=bn_stats_dtype)
        self.enc1 = block(in_channels, c1)
        self.enc2 = block(c1, c2)
        self.enc3 = block(c2, c3)
        self.enc4 = block(c3, c4)
        self.bottleneck = block(c4, c5)
        self.up4 = nn.ConvTranspose2d(c5, c4, 2, stride=2)
        self.dec4 = block(c4 + c4, c4)
        self.up3 = nn.ConvTranspose2d(c4, c3, 2, stride=2)
        self.dec3 = block(c3 + c3, c3)
        self.up2 = nn.ConvTranspose2d(c3, c2, 2, stride=2)
        self.dec2 = block(c2 + c2, c2)
        self.up1 = nn.ConvTranspose2d(c2, c1, 2, stride=2)
        self.dec1 = block(c1 + c1, c1)
        # Both heads always exist (the reference model defines both).
        self.disparity_head = _Head(c1, out_channels, 1)
        self.logvar_head = _Head(c1, 1, 1)
        self.reset_parameters(generator)
        self.to(device=resolve_device(device), memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's initialisers (flax defaults, ``models/unet.py``:
        ``nn.Conv`` :365, ``ConvKernelParams`` :269, ``Conv1x1Params``
        :418-424, ``nn.ConvTranspose`` :479, ``BatchNorm`` :55-61). Every
        conv, transposed-conv and head weight is ``lecun_normal``: a normal
        truncated to [-2, 2], times 1/sqrt(fan_in)/0.8796..., so its std is
        1/sqrt(fan_in), with fan_in = input channels * kh * kw (a transposed
        conv's input channels are ``weight.shape[0]`` in PyTorch's layout).
        Every bias is 0; BatchNorm weight 1, bias 0, fresh running
        statistics. Drawn from ``generator`` (torch's default generator
        without one) on the CPU tensors of ``__init__``, so a seed gives one
        model on every device; the distribution is the JAX package's, the
        stream is not."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                weight = module.weight
                in_channels = weight.shape[0 if module.transposed else 1]
                fan_in = in_channels * weight.shape[2] * weight.shape[3]
                nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                weight.mul_(1.0 / math.sqrt(fan_in) / _TRUNCATED_NORMAL_STD)
                if module.bias is not None:
                    module.bias.zero_()
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
        if x.dtype != self.compute_dtype:
            x = x.to(self.compute_dtype)
        extra = _channel_pad(x.shape[-1], x.dtype)
        if extra:  # padded in NHWC, so the NCHW view stays channels_last
            x = F.pad(x, (0, extra))
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last in memory
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
            d4 = self.dec4(self.up4(b), s4)
            d3 = self.dec3(self.up3(d4), s3)
            d2 = self.dec2(self.up2(d3), s2)
            d1 = self.dec1(self.up1(d2), s1)
            heads = ((self.disparity_head, self.logvar_head) if return_uncertainty
                     else (self.disparity_head,))
            pre = _run_heads(heads, d1, self.compute_dtype)
        # Head nonlinearities in float32 (disparity >= 0, logvar bounded).
        disparity = F.softplus(pre[0].float()).permute(0, 2, 3, 1)
        if not return_uncertainty:
            return disparity
        logvar = pre[1].float().clamp(-6.0, 3.0).permute(0, 2, 3, 1)
        return disparity, logvar

    @staticmethod
    def step_loss(outputs: tuple[torch.Tensor, torch.Tensor], target: torch.Tensor,
                  mask: torch.Tensor) -> tuple[torch.Tensor, LossStats]:
        """The train and eval steps' loss: the masked Laplace NLL of the
        disparity and log-variance (``ops/loss.py``)."""
        disp, logvar = outputs
        return heteroscedastic_laplace_nll(disp[..., 0], logvar[..., 0], target, mask)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
