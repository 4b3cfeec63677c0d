"""PSMNet, stacked hourglass, as published (github.com/JiaRenChang/PSMNet,
``models/stackhourglass.py`` and ``models/submodule.py``; Chang & Chen,
CVPR 2018, arXiv:1803.08669) in plain ``torch.nn``, float32, with the
published module names. The tests hold the port's ``models/psmnet.py`` to
it. It imports nothing of the port and nothing of JAX.

Written to the published code, widths as multiples of ``channels`` (32 is the
published network) and the pyramid's pools as ``spp_pools`` (the published
(64, 32, 16, 8)), so that a tiny cut runs on the CPU. Departures from the
published code:

- The input contract: ``forward`` takes the port's (N, H, W, 6) NHWC tensor
  in [0, 1], the left view in channels 0:3 and the right in 3:6, and
  normalises each view by ImageNet's mean and std, which the published
  data loader does before its ``forward(left, right)``
  (``published_forward``).
- The mask of ``loss``: finite targets with 0 < t < max disparity. The port
  marks invalid pixels 0; the published ``main.py`` masks t < maxdisp only.
- Both upsamplings (the pyramid's bilinear one and the regression's
  trilinear one) pass ``align_corners=False``: the default of
  ``F.upsample`` since PyTorch 0.4.0, which the published code relies on
  without naming it.
- ``disparityregression`` keeps its grid as a module constant on the
  input's device (the published one calls ``.cuda()``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OUTPUT_WEIGHTS = (0.5, 0.7, 1.0)


def convbn(in_planes, out_planes, kernel_size, stride, pad, dilation):
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, kernel_size=kernel_size, stride=stride,
                  padding=dilation if dilation > 1 else pad, dilation=dilation, bias=False),
        nn.BatchNorm2d(out_planes))


def convbn_3d(in_planes, out_planes, kernel_size, stride, pad):
    return nn.Sequential(
        nn.Conv3d(in_planes, out_planes, kernel_size=kernel_size, padding=pad, stride=stride,
                  bias=False),
        nn.BatchNorm3d(out_planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, downsample, pad, dilation):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(inplanes, planes, 3, stride, pad, dilation),
                                   nn.ReLU(inplace=True))
        self.conv2 = convbn(planes, planes, 3, 1, pad, dilation)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = self.conv1(x)
        out = self.conv2(out)
        if self.downsample is not None:
            x = self.downsample(x)
        out += x
        return out


class disparityregression(nn.Module):  # noqa: N801 - the published name
    def __init__(self, maxdisp):
        super().__init__()
        self.maxdisp = maxdisp

    def forward(self, x):
        disp = torch.arange(self.maxdisp, dtype=x.dtype, device=x.device)
        return torch.sum(x * disp.view(1, self.maxdisp, 1, 1), 1)


class feature_extraction(nn.Module):  # noqa: N801 - the published name
    def __init__(self, channels=32, spp_pools=(64, 32, 16, 8)):
        super().__init__()
        c = channels
        self.inplanes = c
        self.firstconv = nn.Sequential(convbn(3, c, 3, 2, 1, 1), nn.ReLU(inplace=True),
                                       convbn(c, c, 3, 1, 1, 1), nn.ReLU(inplace=True),
                                       convbn(c, c, 3, 1, 1, 1), nn.ReLU(inplace=True))
        self.layer1 = self._make_layer(BasicBlock, c, 3, 1, 1, 1)
        self.layer2 = self._make_layer(BasicBlock, 2 * c, 16, 2, 1, 1)
        self.layer3 = self._make_layer(BasicBlock, 4 * c, 3, 1, 1, 1)
        self.layer4 = self._make_layer(BasicBlock, 4 * c, 3, 1, 1, 2)
        p1, p2, p3, p4 = spp_pools
        self.branch1 = nn.Sequential(nn.AvgPool2d((p1, p1), stride=(p1, p1)),
                                     convbn(4 * c, c, 1, 1, 0, 1), nn.ReLU(inplace=True))
        self.branch2 = nn.Sequential(nn.AvgPool2d((p2, p2), stride=(p2, p2)),
                                     convbn(4 * c, c, 1, 1, 0, 1), nn.ReLU(inplace=True))
        self.branch3 = nn.Sequential(nn.AvgPool2d((p3, p3), stride=(p3, p3)),
                                     convbn(4 * c, c, 1, 1, 0, 1), nn.ReLU(inplace=True))
        self.branch4 = nn.Sequential(nn.AvgPool2d((p4, p4), stride=(p4, p4)),
                                     convbn(4 * c, c, 1, 1, 0, 1), nn.ReLU(inplace=True))
        self.lastconv = nn.Sequential(convbn(10 * c, 4 * c, 3, 1, 1, 1), nn.ReLU(inplace=True),
                                      nn.Conv2d(4 * c, c, kernel_size=1, padding=0, stride=1,
                                                bias=False))

    def _make_layer(self, block, planes, blocks, stride, pad, dilation):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, kernel_size=1, stride=stride,
                          bias=False),
                nn.BatchNorm2d(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, pad, dilation)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, 1, None, pad, dilation))
        return nn.Sequential(*layers)

    def forward(self, x):
        output = self.firstconv(x)
        output = self.layer1(output)
        output_raw = self.layer2(output)
        output = self.layer3(output_raw)
        output_skip = self.layer4(output)
        size = (output_skip.size()[2], output_skip.size()[3])
        branches = [F.interpolate(b(output_skip), size, mode="bilinear", align_corners=False)
                    for b in (self.branch1, self.branch2, self.branch3, self.branch4)]
        output_feature = torch.cat((output_raw, output_skip, branches[3], branches[2],
                                    branches[1], branches[0]), 1)
        return self.lastconv(output_feature)


class hourglass(nn.Module):  # noqa: N801 - the published name
    def __init__(self, inplanes):
        super().__init__()
        self.conv1 = nn.Sequential(convbn_3d(inplanes, inplanes * 2, 3, 2, 1),
                                   nn.ReLU(inplace=True))
        self.conv2 = convbn_3d(inplanes * 2, inplanes * 2, 3, 1, 1)
        self.conv3 = nn.Sequential(convbn_3d(inplanes * 2, inplanes * 2, 3, 2, 1),
                                   nn.ReLU(inplace=True))
        self.conv4 = nn.Sequential(convbn_3d(inplanes * 2, inplanes * 2, 3, 1, 1),
                                   nn.ReLU(inplace=True))
        self.conv5 = nn.Sequential(
            nn.ConvTranspose3d(inplanes * 2, inplanes * 2, kernel_size=3, padding=1,
                               output_padding=1, stride=2, bias=False),
            nn.BatchNorm3d(inplanes * 2))
        self.conv6 = nn.Sequential(
            nn.ConvTranspose3d(inplanes * 2, inplanes, kernel_size=3, padding=1,
                               output_padding=1, stride=2, bias=False),
            nn.BatchNorm3d(inplanes))

    def forward(self, x, presqu, postsqu):
        out = self.conv1(x)
        pre = self.conv2(out)
        if postsqu is not None:
            pre = F.relu(pre + postsqu, inplace=True)
        else:
            pre = F.relu(pre, inplace=True)
        out = self.conv3(pre)
        out = self.conv4(out)
        if presqu is not None:
            post = F.relu(self.conv5(out) + presqu, inplace=True)
        else:
            post = F.relu(self.conv5(out) + pre, inplace=True)
        out = self.conv6(post)
        return out, pre, post


def _classifier(c):
    return nn.Sequential(convbn_3d(c, c, 3, 1, 1), nn.ReLU(inplace=True),
                         nn.Conv3d(c, 1, kernel_size=3, padding=1, stride=1, bias=False))


class PSMNet(nn.Module):
    def __init__(self, maxdisp=192, channels=32, spp_pools=(64, 32, 16, 8)):
        super().__init__()
        c = channels
        self.maxdisp = maxdisp
        self.feature_extraction = feature_extraction(c, spp_pools)
        self.dres0 = nn.Sequential(convbn_3d(2 * c, c, 3, 1, 1), nn.ReLU(inplace=True),
                                   convbn_3d(c, c, 3, 1, 1), nn.ReLU(inplace=True))
        self.dres1 = nn.Sequential(convbn_3d(c, c, 3, 1, 1), nn.ReLU(inplace=True),
                                   convbn_3d(c, c, 3, 1, 1))
        self.dres2 = hourglass(c)
        self.dres3 = hourglass(c)
        self.dres4 = hourglass(c)
        self.classif1 = _classifier(c)
        self.classif2 = _classifier(c)
        self.classif3 = _classifier(c)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                n = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
                m.weight.data.normal_(0, math.sqrt(2.0 / n))
            elif isinstance(m, nn.Conv3d):
                n = m.kernel_size[0] * m.kernel_size[1] * m.kernel_size[2] * m.out_channels
                m.weight.data.normal_(0, math.sqrt(2.0 / n))
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.weight.data.fill_(1)
                m.bias.data.zero_()

    def published_forward(self, left, right):
        """The published ``forward(left, right)`` on normalised views."""
        refimg_fea = self.feature_extraction(left)
        targetimg_fea = self.feature_extraction(right)
        n, c, h, w = refimg_fea.shape
        cost = refimg_fea.new_zeros(n, 2 * c, self.maxdisp // 4, h, w)
        for i in range(self.maxdisp // 4):
            if i > 0:
                cost[:, :c, i, :, i:] = refimg_fea[:, :, :, i:]
                cost[:, c:, i, :, i:] = targetimg_fea[:, :, :, :-i]
            else:
                cost[:, :c, i, :, :] = refimg_fea
                cost[:, c:, i, :, :] = targetimg_fea
        cost = cost.contiguous()

        cost0 = self.dres0(cost)
        cost0 = self.dres1(cost0) + cost0
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, pre2, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, pre3, post3 = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = self.classif1(out1)
        cost2 = self.classif2(out2) + cost1
        cost3 = self.classif3(out3) + cost2

        size = [self.maxdisp, left.size()[2], left.size()[3]]
        regression = disparityregression(self.maxdisp)
        if self.training:
            cost1 = F.interpolate(cost1, size, mode="trilinear", align_corners=False)
            cost2 = F.interpolate(cost2, size, mode="trilinear", align_corners=False)
            pred1 = regression(F.softmax(torch.squeeze(cost1, 1), dim=1))
            pred2 = regression(F.softmax(torch.squeeze(cost2, 1), dim=1))
        cost3 = F.interpolate(cost3, size, mode="trilinear", align_corners=False)
        pred3 = regression(F.softmax(torch.squeeze(cost3, 1), dim=1))
        if self.training:
            return pred1, pred2, pred3
        return pred3

    def forward(self, x):
        """x: (N, H, W, 6) in [0, 1] -> the published outputs."""
        x = x.permute(0, 3, 1, 2)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
        return self.published_forward((x[:, :3] - mean) / std, (x[:, 3:] - mean) / std)


def loss(preds, target, maxdisp):
    """The published loss: 0.5, 0.7 and 1.0 times the mean smooth L1 of the
    three outputs over the mask (finite, 0 < t < maxdisp)."""
    mask = torch.isfinite(target) & (target > 0) & (target < maxdisp)
    return sum(w * F.smooth_l1_loss(p[mask], target[mask], reduction="mean")
               for w, p in zip(OUTPUT_WEIGHTS, preds))
