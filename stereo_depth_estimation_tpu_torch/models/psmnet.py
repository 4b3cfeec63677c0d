"""PSMNet, stacked hourglass: Chang & Chen, "Pyramid Stereo Matching Network",
CVPR 2018 (arXiv:1803.08669), as published in github.com/JiaRenChang/PSMNet
(``models/stackhourglass.py`` and ``models/submodule.py``), layer for layer.

- ``feature_extraction``: a 2D ResNet at stride 4 (``firstconv``, ``layer1``
  to ``layer4``, the last dilated), spatial pyramid pooling (four average
  pools, ``spp_pools``, each through a 1x1 convbn + ReLU and bilinearly
  upsampled), the concatenation to 10c channels and ``lastconv`` to c;
  run once for each view, as published: the two views' BatchNorm
  statistics and running updates stay apart.
- The concatenation cost volume (2c, D/4, H/4, W/4) on the hand-written
  kernel of ``ops/cost_volume.py``.
- ``dres0``, ``dres1`` and three stacked 3D hourglasses with the published
  cross-hourglass skips (``presqu``/``postsqu``; the third takes the first's
  ``pre``), three 3D classifiers whose outputs are summed cumulatively.
- For each output: trilinear upsampling to (D, H, W), a softmax over the
  disparities and the soft-argmin regression.

Every width is a multiple of ``channels`` (32, 64, 128, 320 at the published
``channels=32``: 5,224,768 parameters). Parameter and buffer names are the
published model's, with DataParallel's ``module.`` prefix stripped, so a
published checkpoint's state_dict loads as it is.

The port's choices, each a stated difference from the published code:

- It takes the StereoUNet's input: the train step's augmented (N, H, W, 6)
  NHWC tensor in [0, 1], views in channels 0:3 and 3:6, and normalises each
  view by ImageNet's mean and std as the published loader does. It returns
  (pred1, pred2, pred3) in training and pred3 in eval, each (N, H, W)
  float32.
- ``compute_dtype=torch.bfloat16`` runs the 2D and 3D convolutions, the
  transposed convolutions and the cost volume in bf16 under autocast;
  parameters and BatchNorm statistics stay float32. The trilinear
  upsampling, the softmax and the regression run in float32, as the
  StereoUNet's heads add their bias in float32.
- Every BatchNorm is a ``MeshBatchNorm2d`` or ``MeshBatchNorm3d``: in
  training BN1-BN4 (``ops/batchnorm.py``), with the ReLU that follows a
  convbn taken into the kernels; a 3D volume is read as channels_last_3d
  rows. Eval mode is PyTorch's BatchNorm.
- Activations are channels_last (2D) and channels_last_3d (3D) throughout.

Spans (``spans.py``), recorded only under a capture and never in code that
``torch.compile`` traces: ``psmnet.features`` (both views),
``psmnet.cost_volume``, ``psmnet.regularize`` (dres0/1, the hourglasses and
the classifiers) and ``psmnet.regression`` (upsampling, softmax and
regression of every output), all in the forward.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.cost_volume import cost_volume
from ..ops.loss import LossStats, weighted_smooth_l1
from ..spans import OFF, span
from .unet import MeshBatchNorm2d, MeshBatchNorm3d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _span(name: str):
    return OFF if torch.compiler.is_compiling() else span(name)


def _bn(bn: MeshBatchNorm2d, z: torch.Tensor, relu: bool) -> torch.Tensor:
    """BatchNorm of ``z``, then ReLU if ``relu``; in training on BN1-BN4
    with the ReLU in the kernels."""
    if bn.training:
        if z.ndim == 4:
            z = z.contiguous(memory_format=torch.channels_last)
        return bn.forward_relu(z) if relu else bn(z)
    y = bn(z)
    return F.relu(y) if relu else y


def _cbr(convbn: nn.Sequential, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """A published ``convbn`` / ``convbn_3d`` (conv, BatchNorm), then ReLU."""
    return _bn(convbn[1], convbn[0](x), relu)


def _convbn(cin: int, cout: int, kernel: int, stride: int, pad: int, dilation: int,
            group) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride=stride, padding=dilation if dilation > 1 else pad,
                  dilation=dilation, bias=False),
        MeshBatchNorm2d(cout, group))


def _convbn_3d(cin: int, cout: int, kernel: int, stride: int, pad: int,
               group) -> nn.Sequential:
    return nn.Sequential(nn.Conv3d(cin, cout, kernel, padding=pad, stride=stride, bias=False),
                         MeshBatchNorm3d(cout, group))


class BasicBlock(nn.Module):
    """The published residual block: convbn + ReLU, convbn, plus the
    (downsampled) input; no ReLU after the sum."""

    def __init__(self, inplanes: int, planes: int, stride: int, downsample, pad: int,
                 dilation: int, group) -> None:
        super().__init__()
        self.conv1 = nn.Sequential(_convbn(inplanes, planes, 3, stride, pad, dilation, group),
                                   nn.ReLU(inplace=True))
        self.conv2 = _convbn(planes, planes, 3, 1, pad, dilation, group)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _cbr(self.conv2, _cbr(self.conv1[0], x), relu=False)
        if self.downsample is not None:
            x = _cbr(self.downsample, x, relu=False)
        return out + x


class feature_extraction(nn.Module):  # noqa: N801 - the published name
    """The published 2D feature extractor at width ``c``: (N, 3, H, W) ->
    (N, c, H/4, W/4)."""

    def __init__(self, c: int, spp_pools: tuple[int, ...], group) -> None:
        super().__init__()
        self.inplanes = c
        self.firstconv = nn.Sequential(
            _convbn(3, c, 3, 2, 1, 1, group), nn.ReLU(inplace=True),
            _convbn(c, c, 3, 1, 1, 1, group), nn.ReLU(inplace=True),
            _convbn(c, c, 3, 1, 1, 1, group), nn.ReLU(inplace=True))
        self.layer1 = self._make_layer(c, 3, 1, 1, 1, group)
        self.layer2 = self._make_layer(2 * c, 16, 2, 1, 1, group)
        self.layer3 = self._make_layer(4 * c, 3, 1, 1, 1, group)
        self.layer4 = self._make_layer(4 * c, 3, 1, 1, 2, group)
        for k, pool in enumerate(spp_pools, start=1):
            setattr(self, f"branch{k}", nn.Sequential(
                nn.AvgPool2d((pool, pool), stride=(pool, pool)),
                _convbn(4 * c, c, 1, 1, 0, 1, group), nn.ReLU(inplace=True)))
        self.lastconv = nn.Sequential(
            _convbn(10 * c, 4 * c, 3, 1, 1, 1, group), nn.ReLU(inplace=True),
            nn.Conv2d(4 * c, c, kernel_size=1, padding=0, stride=1, bias=False))

    def _make_layer(self, planes: int, blocks: int, stride: int, pad: int, dilation: int,
                    group) -> nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes, kernel_size=1, stride=stride, bias=False),
                MeshBatchNorm2d(planes, group))
        layers = [BasicBlock(self.inplanes, planes, stride, downsample, pad, dilation, group)]
        self.inplanes = planes
        layers += [BasicBlock(planes, planes, 1, None, pad, dilation, group)
                   for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in (0, 2, 4):
            x = _cbr(self.firstconv[k], x)
        raw = self.layer2(self.layer1(x))
        skip = self.layer4(self.layer3(raw))
        size = skip.shape[-2:]
        branches = [F.interpolate(_cbr(branch[1], branch[0](skip)), size, mode="bilinear",
                                  align_corners=False)
                    for branch in (self.branch4, self.branch3, self.branch2, self.branch1)]
        feature = torch.cat([raw, skip, *branches], dim=1)
        return self.lastconv[2](_cbr(self.lastconv[0], feature))


class hourglass(nn.Module):  # noqa: N801 - the published name
    """The published 3D hourglass at ``inplanes``: two stride-2 convbn_3d
    down, two transposed convolutions up, with the cross-hourglass skips."""

    def __init__(self, inplanes: int, group) -> None:
        super().__init__()
        c2 = 2 * inplanes
        self.conv1 = nn.Sequential(_convbn_3d(inplanes, c2, 3, 2, 1, group),
                                   nn.ReLU(inplace=True))
        self.conv2 = _convbn_3d(c2, c2, 3, 1, 1, group)
        self.conv3 = nn.Sequential(_convbn_3d(c2, c2, 3, 2, 1, group), nn.ReLU(inplace=True))
        self.conv4 = nn.Sequential(_convbn_3d(c2, c2, 3, 1, 1, group), nn.ReLU(inplace=True))
        self.conv5 = nn.Sequential(
            nn.ConvTranspose3d(c2, c2, kernel_size=3, padding=1, output_padding=1, stride=2,
                               bias=False),
            MeshBatchNorm3d(c2, group))
        self.conv6 = nn.Sequential(
            nn.ConvTranspose3d(c2, inplanes, kernel_size=3, padding=1, output_padding=1,
                               stride=2, bias=False),
            MeshBatchNorm3d(inplanes, group))

    def forward(self, x, presqu, postsqu):
        out = _cbr(self.conv1[0], x)
        pre = _cbr(self.conv2, out, relu=postsqu is None)
        if postsqu is not None:
            pre = F.relu(pre + postsqu, inplace=True)
        out = _cbr(self.conv4[0], _cbr(self.conv3[0], pre))
        post = F.relu(_cbr(self.conv5, out, relu=False) + (pre if presqu is None else presqu),
                      inplace=True)
        return _cbr(self.conv6, post, relu=False), pre, post


def _classifier(c: int, group) -> nn.Sequential:
    return nn.Sequential(_convbn_3d(c, c, 3, 1, 1, group), nn.ReLU(inplace=True),
                         nn.Conv3d(c, 1, kernel_size=3, padding=1, stride=1, bias=False))


def _memory_format(t: torch.Tensor) -> torch.Tensor:
    if t.ndim == 4:
        return t.contiguous(memory_format=torch.channels_last)
    if t.ndim == 5:
        return t.contiguous(memory_format=torch.channels_last_3d)
    return t


class PSMNet(nn.Module):
    # What the train and eval steps ask of the model (parallel/train_step.py):
    # the forward's keyword arguments and ``step_loss`` on its outputs.
    step_kwargs: dict = {}

    def __init__(
        self,
        max_disparity: int = 192,
        channels: int = 32,
        spp_pools: tuple[int, ...] = (64, 32, 16, 8),
        compute_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        bn_group=None,
    ) -> None:
        """The published stackhourglass PSMNet at width ``channels`` (32 is
        the published network). ``max_disparity`` must be a multiple of 16
        (the volume's depth, max_disparity / 4, is halved twice), and an
        input's height and width multiples of 16 whose quarter is at least
        the largest of ``spp_pools``. The weights are the published
        initialisation (``reset_parameters``) drawn from ``generator`` (a
        CPU generator) if given. ``bn_group``: a ``torch.distributed`` group;
        with more than one rank the BatchNorm statistics are global over
        it."""
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if max_disparity % 16:
            raise ValueError(f"max_disparity must be a multiple of 16, got {max_disparity}")
        if len(spp_pools) != 4:
            raise ValueError(f"spp_pools takes four pool sizes, got {spp_pools}")
        self.max_disparity = max_disparity
        self.spp_pools = tuple(spp_pools)
        self.compute_dtype = compute_dtype
        group = bn_group if bn_group is not None and dist.get_world_size(bn_group) > 1 else None
        c = channels
        self.feature_extraction = feature_extraction(c, self.spp_pools, group)
        self.dres0 = nn.Sequential(_convbn_3d(2 * c, c, 3, 1, 1, group), nn.ReLU(inplace=True),
                                   _convbn_3d(c, c, 3, 1, 1, group), nn.ReLU(inplace=True))
        self.dres1 = nn.Sequential(_convbn_3d(c, c, 3, 1, 1, group), nn.ReLU(inplace=True),
                                   _convbn_3d(c, c, 3, 1, 1, group))
        self.dres2 = hourglass(c, group)
        self.dres3 = hourglass(c, group)
        self.dres4 = hourglass(c, group)
        self.classif1 = _classifier(c, group)
        self.classif2 = _classifier(c, group)
        self.classif3 = _classifier(c, group)
        # Not in the state_dict: the published model holds no such buffers.
        self.register_buffer("image_mean", torch.tensor(IMAGENET_MEAN).view(3, 1, 1),
                             persistent=False)
        self.register_buffer("image_std", torch.tensor(IMAGENET_STD).view(3, 1, 1),
                             persistent=False)
        self.register_buffer("disparities", torch.arange(max_disparity, dtype=torch.float32)
                             .view(max_disparity, 1, 1), persistent=False)
        self.reset_parameters(generator)
        self.to(device=resolve_device(device))
        self._apply(_memory_format)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The published initialisation (``stackhourglass.py``): a Conv2d
        weight ~ N(0, 2 / (k * k * out)), a Conv3d weight ~ N(0, 2 / (k^3 *
        out)); BatchNorm weight 1, bias 0, fresh running statistics; a
        ConvTranspose3d keeps PyTorch's default (kaiming-uniform, a =
        sqrt(5)), which the published ``isinstance`` checks leave as it is.
        Drawn from ``generator`` (torch's default generator without one)."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Conv3d)):
                n = math.prod(module.kernel_size) * module.out_channels
                module.weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
            elif isinstance(module, nn.ConvTranspose3d):
                nn.init.kaiming_uniform_(module.weight, a=math.sqrt(5), generator=generator)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def _view(self, x: torch.Tensor) -> torch.Tensor:
        """One (N, 3, H, W) view in [0, 1], normalised by ImageNet's mean and
        std in float32, channels_last."""
        return _memory_format((x.float() - self.image_mean) / self.image_std)

    def _regularize(self, cost: torch.Tensor) -> tuple[torch.Tensor, ...]:
        cost0 = _cbr(self.dres0[2], _cbr(self.dres0[0], cost))
        cost0 = _cbr(self.dres1[2], _cbr(self.dres1[0], cost0), relu=False) + cost0
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = self.classif1[2](_cbr(self.classif1[0], out1))
        cost2 = self.classif2[2](_cbr(self.classif2[0], out2)) + cost1
        cost3 = self.classif3[2](_cbr(self.classif3[0], out3)) + cost2
        return cost1, cost2, cost3

    def _regress(self, cost: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(N, 1, D/4, H/4, W/4) -> (N, H, W) float32: trilinear to (D, H, W),
        softmax over the disparities, their expectation."""
        cost = F.interpolate(cost.float(), size=(self.max_disparity, h, w), mode="trilinear",
                             align_corners=False)
        prob = F.softmax(cost[:, 0], dim=1)
        return (prob * self.disparities).sum(dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor | tuple[torch.Tensor, ...]:
        """x: (N, H, W, 6) -> (pred1, pred2, pred3) in training, pred3 in
        eval, each (N, H, W) float32."""
        h, w = x.shape[1], x.shape[2]
        if h % 16 or w % 16 or min(h, w) // 4 < max(self.spp_pools):
            raise ValueError(
                f"PSMNet input height and width must be multiples of 16 whose quarter is at "
                f"least the largest pool {max(self.spp_pools)}; got {h}x{w}")
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last in memory
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            with _span("psmnet.features"):
                left = self.feature_extraction(self._view(x[:, :3]))
                right = self.feature_extraction(self._view(x[:, 3:]))
            with _span("psmnet.cost_volume"):
                cost = cost_volume(left, right, self.max_disparity // 4)
            with _span("psmnet.regularize"):
                costs = self._regularize(cost)
        with _span("psmnet.regression"):
            if not self.training:
                return self._regress(costs[-1], h, w)
            return tuple(self._regress(c, h, w) for c in costs)

    def step_loss(self, outputs, target: torch.Tensor,
                  mask: torch.Tensor) -> tuple[torch.Tensor, LossStats]:
        """The train and eval steps' loss: 0.5, 0.7 and 1.0 times the masked
        mean smooth L1 of the three outputs (eval: the one output), over
        valid pixels below ``max_disparity`` (``ops/loss.py``)."""
        return weighted_smooth_l1(outputs, target, mask, self.max_disparity)
