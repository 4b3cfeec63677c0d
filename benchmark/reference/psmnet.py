"""PSMNet, stacked hourglass, as plain PyTorch functions over a dict of
float32 tensors: the published model (github.com/JiaRenChang/PSMNet,
``models/stackhourglass.py`` and ``models/submodule.py``; Chang & Chen, CVPR
2018, arXiv:1803.08669) and its training step (``main.py``: the weighted
smooth L1, Adam).

Weights are keyed by the published state_dict names (DataParallel's
``module.`` stripped); every width is a multiple of the configuration's
``channels`` (32 is the published network), the pyramid's pools are its
``spp_pools`` and the regression runs over ``max_disparity`` disparities.
Tensors are NCHW / NCDHW and contiguous. Nothing here imports the program
under test.

The published code's input is two normalised views; here ``forward`` takes
the (N, H, W, 6) tensor in [0, 1] the program's step augments (left view in
channels 0:3, right in 3:6) and normalises each view by ImageNet's mean and
std, as the published loader does. Both upsamplings pass
``align_corners=False``, the published code's default since PyTorch 0.4.0.
The loss masks finite targets with 0 < t < max disparity (the program marks
invalid pixels 0; the published mask is t < maxdisp).

``precision`` holds every 2D and 3D convolution's and transposed
convolution's operands as ``unet.py`` describes (``"f32"``, ``"bf16"``,
``"fp8"``); the cost volume, BatchNorm, upsampling, softmax and regression
stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import augment
from .unet import _Fp8Gradient, _operands

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OUTPUT_WEIGHTS = (0.5, 0.7, 1.0)
_BLOCKS = (("layer1", 1, 3, 1, 1), ("layer2", 2, 16, 2, 1), ("layer3", 4, 3, 1, 1),
           ("layer4", 4, 3, 1, 2))  # name, width / c, blocks, stride, dilation


# The layers: (name, kind, in, out, kernel, stride, padding, dilation), kind
# "2d", "3d" (convolutions, a BatchNorm at "<name-prefix>.1" unless the name
# ends in the bare conv) or "t3d" (transposed). Listed once, in the
# published order, for the shapes and the FLOPs.


def _feature_layers(c: int) -> list[tuple]:
    f = "feature_extraction."
    out = [(f"{f}firstconv.{k}.0", "2d", 3 if k == 0 else c, c, 3, 2 if k == 0 else 1, 1, 1)
           for k in (0, 2, 4)]
    inplanes = c
    for name, mult, blocks, stride, dilation in _BLOCKS:
        planes = mult * c
        pad = dilation
        for b in range(blocks):
            cin, s = (inplanes, stride) if b == 0 else (planes, 1)
            out.append((f"{f}{name}.{b}.conv1.0.0", "2d", cin, planes, 3, s, pad, dilation))
            out.append((f"{f}{name}.{b}.conv2.0", "2d", planes, planes, 3, 1, pad, dilation))
            if b == 0 and (stride != 1 or inplanes != planes):
                out.append((f"{f}{name}.0.downsample.0", "2d", inplanes, planes, 1, stride, 0,
                            1))
        inplanes = planes
    for k in range(1, 5):
        out.append((f"{f}branch{k}.1.0", "2d", 4 * c, c, 1, 1, 0, 1))
    out.append((f"{f}lastconv.0.0", "2d", 10 * c, 4 * c, 3, 1, 1, 1))
    out.append((f"{f}lastconv.2", "2d", 4 * c, c, 1, 1, 0, 1))
    return out


def _volume_layers(c: int) -> list[tuple]:
    out = [("dres0.0.0", "3d", 2 * c, c, 3, 1, 1, 1), ("dres0.2.0", "3d", c, c, 3, 1, 1, 1),
           ("dres1.0.0", "3d", c, c, 3, 1, 1, 1), ("dres1.2.0", "3d", c, c, 3, 1, 1, 1)]
    for h in ("dres2", "dres3", "dres4"):
        out += [(f"{h}.conv1.0.0", "3d", c, 2 * c, 3, 2, 1, 1),
                (f"{h}.conv2.0", "3d", 2 * c, 2 * c, 3, 1, 1, 1),
                (f"{h}.conv3.0.0", "3d", 2 * c, 2 * c, 3, 2, 1, 1),
                (f"{h}.conv4.0.0", "3d", 2 * c, 2 * c, 3, 1, 1, 1),
                (f"{h}.conv5.0", "t3d", 2 * c, 2 * c, 3, 2, 1, 1),
                (f"{h}.conv6.0", "t3d", 2 * c, c, 3, 2, 1, 1)]
    for k in (1, 2, 3):
        out += [(f"classif{k}.0.0", "3d", c, c, 3, 1, 1, 1),
                (f"classif{k}.2", "3d", c, 1, 3, 1, 1, 1)]
    return out


def _bare(name: str) -> bool:
    """A convolution with no BatchNorm after it."""
    return name.endswith("lastconv.2") or (name.startswith("classif") and name.endswith(".2"))


def parameter_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape by published state_dict name, in the
    published order."""
    c = cfg["channels"]
    shapes: dict[str, tuple[int, ...]] = {}
    for name, kind, cin, cout, k, *_ in _feature_layers(c) + _volume_layers(c):
        if kind == "2d":
            shapes[f"{name}.weight"] = (cout, cin, k, k)
        elif kind == "3d":
            shapes[f"{name}.weight"] = (cout, cin, k, k, k)
        else:
            shapes[f"{name}.weight"] = (cin, cout, k, k, k)
        if not _bare(name):
            bn = name[: name.rindex(".")] + ".1"
            shapes[f"{bn}.weight"] = (cout,)
            shapes[f"{bn}.bias"] = (cout,)
    return shapes


def bn_names(cfg: dict) -> list[str]:
    """Prefixes of every BatchNorm, by published name."""
    return [n[: -len(".weight")] for n, s in parameter_shapes(cfg).items()
            if len(s) == 1 and n.endswith(".weight")]


def _spatial(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The input spatial size of each layer: (H, W) or (D, H, W)."""
    h, w = cfg["height"], cfg["width"]
    d4, h4, w4 = cfg["max_disparity"] // 4, h // 4, w // 4
    out = {}
    for name, *_ in _feature_layers(cfg["channels"]):
        if "firstconv.0" in name:
            out[name] = (h, w)
        elif "firstconv" in name or "layer1" in name or "layer2.0.conv1" in name \
                or "layer2.0.downsample" in name:
            out[name] = (h // 2, w // 2)
        else:
            out[name] = (h4, w4)
    for k, pool in enumerate(cfg["spp_pools"], start=1):
        out[f"feature_extraction.branch{k}.1.0"] = (h4 // pool, w4 // pool)
    for name, *_ in _volume_layers(cfg["channels"]):
        scale = 1
        if any(s in name for s in (".conv2.", ".conv3.", ".conv6.")):
            scale = 2
        elif any(s in name for s in (".conv4.", ".conv5.")):
            scale = 4
        out[name] = (d4 // scale, h4 // scale, w4 // scale)
    return out


def forward_flops(cfg: dict) -> int:
    """FLOPs of one forward of one pair, 2 a multiply-add: every 2D and 3D
    convolution (over its output) and transposed convolution (over its
    input), both views' feature extractors; the rest is left out, as
    ``torch.utils.flop_counter`` leaves it."""
    spatial = _spatial(cfg)
    macs = 0
    for name, kind, cin, cout, k, stride, *_ in _feature_layers(cfg["channels"]):
        ih, iw = spatial[name]
        macs += 2 * (ih // stride) * (iw // stride) * cin * cout * k * k  # two views
    for name, kind, cin, cout, k, stride, *_ in _volume_layers(cfg["channels"]):
        d, h, w = spatial[name]
        if kind == "3d":
            d, h, w = d // stride, h // stride, w // stride
        macs += d * h * w * cin * cout * k ** 3
    return 2 * macs


def cost_volume_bytes(cfg: dict, batch: int, itemsize: int) -> int:
    """The cost-volume kernel's bytes one way for a batch: the forward writes
    the (2C, D/4, H/4, W/4) volume and reads the two (C, H/4, W/4) feature
    maps a pair; the backward reads the former and writes the latter."""
    c, d4 = cfg["channels"], cfg["max_disparity"] // 4
    hw = (cfg["height"] // 4) * (cfg["width"] // 4)
    return batch * itemsize * (2 * c * d4 * hw + 2 * c * hw)


def _conv(x, w, precision, stride=1, padding=0, dilation=1, transposed=False):
    x, w = _operands(precision, x, w)
    if transposed:
        y = F.conv_transpose3d(x, w, stride=stride, padding=padding, output_padding=1)
    elif w.ndim == 5:
        y = F.conv3d(x, w, stride=stride, padding=padding)
    else:
        y = F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation)
    return _Fp8Gradient.apply(y) if precision == "fp8" and y.requires_grad else y.float()


def cost_volume(left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
    """The published loop of slice copies."""
    n, c, h, w = left.shape
    slices = []
    for i in range(depth):
        zeros = left.new_zeros(n, c, h, i)
        slices.append(torch.cat([torch.cat([zeros, left[:, :, :, i:]], dim=3),
                                 torch.cat([zeros, right[:, :, :, :w - i]], dim=3)], dim=1))
    return torch.stack(slices, dim=2)


def forward(p: dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, train: bool,
            precision: str = "f32"):
    """x: (N, H, W, 6) float32 in [0, 1] -> (pred1, pred2, pred3) with
    ``train`` (BatchNorm on the batch's statistics), else pred3 (running
    statistics, ``<bn>.running_mean`` / ``.running_var`` in ``p``); each (N,
    H, W) float32."""
    c, maxdisp = cfg["channels"], cfg["max_disparity"]
    layers = {name: rest for name, *rest in _feature_layers(c) + _volume_layers(c)}

    def bn(z, name, relu):
        if train:
            y = F.batch_norm(z, None, None, p[f"{name}.weight"], p[f"{name}.bias"],
                             training=True, eps=BN_EPS)
        else:
            y = F.batch_norm(z, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                             p[f"{name}.weight"], p[f"{name}.bias"], training=False,
                             eps=BN_EPS)
        return F.relu(y) if relu else y

    def conv(z, name):
        kind, _, _, _, stride, padding, dilation = layers[name]
        return _conv(z, p[f"{name}.weight"], precision, stride, padding, dilation,
                     transposed=kind == "t3d")

    def cbr(z, name, relu=True):
        return bn(conv(z, name), name[: name.rindex(".")] + ".1", relu)

    def features(v):
        f = "feature_extraction."
        for k in (0, 2, 4):
            v = cbr(v, f"{f}firstconv.{k}.0")
        outs = {}
        for name, _, blocks, _, _ in _BLOCKS:
            for b in range(blocks):
                out = cbr(cbr(v, f"{f}{name}.{b}.conv1.0.0"), f"{f}{name}.{b}.conv2.0", False)
                if f"{f}{name}.{b}.downsample.0" in layers:
                    v = cbr(v, f"{f}{name}.{b}.downsample.0", False)
                v = out + v
            outs[name] = v
        size = outs["layer4"].shape[-2:]
        branches = []
        for k, pool in enumerate(cfg["spp_pools"], start=1):
            b = cbr(F.avg_pool2d(outs["layer4"], pool, pool), f"{f}branch{k}.1.0")
            branches.append(F.interpolate(b, size, mode="bilinear", align_corners=False))
        feature = torch.cat([outs["layer2"], outs["layer4"], *branches[::-1]], dim=1)
        return conv(cbr(feature, f"{f}lastconv.0.0"), f"{f}lastconv.2")

    def hourglass(h, z, presqu, postsqu):
        out = cbr(z, f"{h}.conv1.0.0")
        pre = cbr(out, f"{h}.conv2.0", False)
        pre = F.relu(pre if postsqu is None else pre + postsqu)
        out = cbr(cbr(pre, f"{h}.conv3.0.0"), f"{h}.conv4.0.0")
        post = F.relu(cbr(out, f"{h}.conv5.0", False) + (pre if presqu is None else presqu))
        return cbr(post, f"{h}.conv6.0", False), pre, post

    img = x.permute(0, 3, 1, 2)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    left, right = features((img[:, :3] - mean) / std), features((img[:, 3:] - mean) / std)
    cost = cost_volume(left, right, maxdisp // 4)
    cost0 = cbr(cbr(cost, "dres0.0.0"), "dres0.2.0")
    cost0 = cbr(cbr(cost0, "dres1.0.0"), "dres1.2.0", False) + cost0
    out1, pre1, post1 = hourglass("dres2", cost0, None, None)
    out1 = out1 + cost0
    out2, _, post2 = hourglass("dres3", out1, pre1, post1)
    out2 = out2 + cost0
    out3, _, _ = hourglass("dres4", out2, pre1, post2)
    out3 = out3 + cost0
    cost1 = conv(cbr(out1, "classif1.0.0"), "classif1.2")
    cost2 = conv(cbr(out2, "classif2.0.0"), "classif2.2") + cost1
    cost3 = conv(cbr(out3, "classif3.0.0"), "classif3.2") + cost2
    disparities = torch.arange(maxdisp, dtype=torch.float32, device=x.device).view(1, -1, 1, 1)

    def regress(cost_k):
        up = F.interpolate(cost_k, [maxdisp, x.shape[1], x.shape[2]], mode="trilinear",
                           align_corners=False)
        return torch.sum(F.softmax(up[:, 0], dim=1) * disparities, 1)

    if not train:
        return regress(cost3)
    return regress(cost1), regress(cost2), regress(cost3)


def loss_sums(preds, target: torch.Tensor,
              max_disparity: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(0.5, 0.7 and 1.0 times the smooth L1 (beta 1) of the three outputs,
    summed over the finite targets with 0 < t < max disparity; the count of
    those targets)."""
    mask = torch.isfinite(target) & (target > 0) & (target < max_disparity)
    t = torch.where(mask, target, torch.zeros_like(target))
    weighted = sum(w * torch.where(mask, F.smooth_l1_loss(pred, t, reduction="none"),
                                   torch.zeros_like(t)).sum()
                   for w, pred in zip(OUTPUT_WEIGHTS, preds))
    return weighted, mask.sum()


def loss(preds, target: torch.Tensor, max_disparity: float) -> torch.Tensor:
    """0.5, 0.7 and 1.0 times the mean smooth L1 (beta 1) of the three
    outputs over the finite targets with 0 < t < max disparity."""
    weighted, count = loss_sums(preds, target, max_disparity)
    return weighted / count.clamp(min=1)


def run(p0: dict[str, torch.Tensor], images_u8: torch.Tensor, targets: torch.Tensor,
        cfg: dict, batch: int, generator: torch.Generator, aug: dict | None, lr: float,
        weight_decay: float, steps: int = 3, precision: str = "f32") -> dict:
    """``steps`` train steps from the parameters ``p0``, as ``train.run``
    takes them for the StereoUNet: step k's batch is rows ``perm[k B:(k +
    1) B]`` of one ``randperm`` drawn first from the step's generator, each
    step then draws its augmentation (``augment.augment``; none with ``aug``
    None, the images / 255), then the forward, the weighted smooth L1, the
    backward and Adam(W) (betas (0.9, 0.999), eps 1e-8, decoupled decay).
    Returns each step's loss, each leaf's norm of the first step's gradient
    and of the change over the steps, the first step's gradients, its three
    outputs (``first_preds``) and its loss's weighted sum and count of
    targets (``first_sums``)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    perm = torch.randperm(images_u8.shape[0], generator=generator, device=images_u8.device)
    losses, first_grad = [], {}
    for k in range(steps):
        rows = perm[k * batch:(k + 1) * batch]
        raw = images_u8.index_select(0, rows)
        x = augment.augment(generator, raw, aug) if aug is not None else raw.float() / 255.0
        preds = forward(params, x, cfg, train=True, precision=precision)
        weighted, count = loss_sums(preds, targets.index_select(0, rows).float(),
                                    cfg["max_disparity"])
        value = weighted / count.clamp(min=1)
        grads = torch.autograd.grad(value, list(params.values()))
        losses.append(float(value.detach()))
        if k == 0:
            first_preds = tuple(pred.detach() for pred in preds)
            first_sums = (float(weighted.detach()), float(count))
        del x, preds, value, weighted
        with torch.no_grad():
            t = k + 1
            for (name, p), g in zip(params.items(), grads):
                if k == 0:
                    first_grad[name] = g.detach().clone()
                m[name].lerp_(g, 1 - b1)
                v2[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.mul_(1 - lr * weight_decay)
                denom = (v2[name].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[name], denom, value=-lr / (1 - b1 ** t))
        del grads
    change = {k: float((params[k].detach() - p0[k]).norm()) for k in params}
    return {"loss": losses, "grad": {k: float(g.norm()) for k, g in first_grad.items()},
            "change": change, "first_grad": first_grad, "first_preds": first_preds,
            "first_sums": first_sums}
