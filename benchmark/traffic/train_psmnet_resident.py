"""PSMNet training over a payload held on the device, one step a call.

The port's ``make_device_data_train_step`` over ``create_train_state`` with a
``PSMNet`` (``models/psmnet.py``): each call gathers its batch by the pass's
``randperm``, augments it (K1, gray means, noise and clamp), runs the
forward in the configuration's training dtype (two feature-extractor calls,
the cost-volume kernel, the 3D hourglasses, BN1-BN4 on 2D maps and 3D
volumes, the float32 regression of three outputs), the weighted smooth L1,
the backward and Adam (``make_adamw``). The weights are the published
initialisation drawn from the seed (``weights``). Set-up, the checked steps,
the window are ``train_device_resident``'s ``Cell``; the reference is
``reference/psmnet.py``'s ``run``. The targets lie in (0, max_disparity] of
the configuration, a share of them invalid (0). The step is host-bound (the
gate's launches), so the mix names its rate ``pretrain_pairs_per_s``
(``rate_metric``). A traced run's ``split`` sorts the convolution kernels
into the 3D stack's and the 2D extractor's (``conv_ms``).

The numbers are ``compare.train_numbers``' ``change_gap``; over the first
checked step's loss (``LossStats``) against the reference's the larger
relative gap of its weighted smooth-L1 sum and of its count of targets
(``sum_gap``), which a step that leaves part of its batch out of the loss
halves; and over the first step's three outputs against the reference's
the largest mean absolute gap (``disp_mae``) and the largest absolute mean
gap (``disp_bias``), in disparities. With targets spread over the whole
disparity range the smooth L1's gradient is a sum of terms of either sign,
so bfloat16 moves the median leaf's gradient by 14-33% (the reference's own
bf16 convolutions by 16%; on an H100) and the gradient numbers part
bfloat16 from neither fp8 nor half the batch; the outputs' mean |gap| parts
fp8, and their mean gap shows an output shifted by one disparity inside
bfloat16's own gap. Left out, as they part nothing here: ``loss_gap`` (the
three steps' losses part by up to 1.5% in bfloat16, more than in fp8,
0.4-0.9%, as the noisy gradients' Adam steps, lr * g / |g|, go their own
ways), ``grad_gap`` (a worst leaf: 0.15-0.62 over 28 sound runs against
0.68-1.0 under the half-batch fault) and ``grad_diff_median`` (sound up to
0.33 over 70 runs, half batch from 0.39, fp8 0.28-0.37).
"""

from __future__ import annotations

import math

import torch

from .. import compare, inputs, tracing
from ..reference import psmnet
from .common import Phases, strict_f32, sync
from .train_device_resident import FAULTS, SPAN_UNIT, WINDOW
from .train_device_resident import Cell as ResidentCell

__all__ = ["Cell", "FAULTS", "NUMBERS", "SPAN_UNIT", "TINY_MIX", "WINDOW", "MODEL_CLASS"]

NUMBERS = ("change_gap", "sum_gap", "disp_mae", "disp_bias")
TINY_MIX = {"batch": 4, "payload_pairs": 24, "trace_units": 1}
MODEL_CLASS = "stereo_depth_estimation_tpu_torch.models.psmnet.PSMNet"


def weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter by published name, drawn on the device from ``seed``
    (one normal and one uniform draw): the published init (a Conv2d or Conv3d weight ~ N(0,
    2 / (k^d * out)), a ConvTranspose3d weight uniform on +-1 / sqrt(fan_in)
    with fan_in = out * 27, PyTorch's default; BatchNorm weight 1, bias 0)."""
    shapes = psmnet.parameter_shapes(cfg)
    g = inputs.generator(device, seed)
    convs = {n: s for n, s in shapes.items() if len(s) > 1}
    normal = torch.randn(sum(math.prod(s) for s in convs.values()), generator=g, device=device)
    uniform = torch.rand(normal.shape, generator=g, device=device) * 2.0 - 1.0
    out, offset = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = (torch.ones if name.endswith(".weight") else torch.zeros)(
                shape, device=device)
            continue
        n = math.prod(shape)
        if ".conv5." in name or ".conv6." in name:  # the transposed convolutions
            bound = 1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))
            out[name] = uniform[offset:offset + n].view(shape) * bound
        else:
            std = math.sqrt(2.0 / (math.prod(shape[2:]) * shape[0]))
            out[name] = normal[offset:offset + n].view(shape) * std
        offset += n
    return out


def psmnet_numbers(got: dict, want: dict) -> dict[str, float]:
    """``NUMBERS`` of the side ``got`` against the reference ``want``: the
    change gap; the first step's loss sum and target count (``first_sums``),
    the larger relative gap; and over the first step's three outputs the
    largest mean absolute gap (``disp_mae``) and the largest absolute mean
    gap (``disp_bias``), in disparities, infinite where the shapes differ."""
    gaps = [(g.float() - w) if g.shape == w.shape else None
            for g, w in zip(got["first_preds"], want["first_preds"])]
    return {"change_gap": compare.train_numbers(got, want)["change_gap"],
            "sum_gap": max(abs(a - b) / b for a, b in zip(got["first_sums"],
                                                           want["first_sums"])),
            "disp_mae": max(math.inf if d is None else float(d.abs().mean()) for d in gaps),
            "disp_bias": max(math.inf if d is None else abs(float(d.mean())) for d in gaps)}


def conv_ms(events, units: int) -> dict[str, float]:
    """Device ms a unit of the convolution kernels (``tracing``'s ``conv``
    group) among profiler ``events``, by the rank of the operator that
    launched them: ``conv3d`` under one over 5-D tensors (the 3D stack's
    convolutions and transposed convolutions, forward, dgrad and wgrad),
    ``conv2d`` under one over 4-D tensors (the feature extractor's)."""
    us = {"conv3d": 0.0, "conv2d": 0.0}
    for e in events:
        took = sum(k.duration for k in e.kernels if tracing.group_of(k.name) == "conv")
        if not took:
            continue
        rank = max((len(s) for s in e.input_shapes if s and isinstance(s[0], int)), default=0)
        key = {5: "conv3d", 4: "conv2d"}.get(rank)
        if key is not None:
            us[key] += took
    return {k: 1e-3 * v / units for k, v in us.items()}


def state_dict(p: dict[str, torch.Tensor], cfg: dict) -> dict[str, torch.Tensor]:
    """``p`` with every BatchNorm's fresh buffers, as the port's module holds
    them."""
    sd = dict(p)
    for name in psmnet.bn_names(cfg):
        c = p[f"{name}.weight"].shape[0]
        device = p[f"{name}.weight"].device
        sd[f"{name}.running_mean"] = torch.zeros(c, device=device)
        sd[f"{name}.running_var"] = torch.ones(c, device=device)
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return sd


class Cell(ResidentCell):
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device) -> None:
        # The port's modules first: a program without PSMNet fails here, at once.
        from stereo_depth_estimation_tpu_torch.models.psmnet import PSMNet
        from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
        from stereo_depth_estimation_tpu_torch.parallel.train_step import (
            create_train_state, make_adamw, make_device_data_train_step)

        if device.type == "cpu":
            # PyTorch's CPU oneDNN convolutions corrupt the heap now and then
            # on this network when they run multi-threaded (torch 2.13): a
            # CPU run (the tiny cells of the CPU tests) takes the native ones.
            torch.backends.mkldnn.enabled = False
        self.phases = Phases(device)
        self.cfg, self.mix, self.device = cfg, mix, device
        self.batch = mix["batch"]
        data_seed, weight_seed, self.step_seed = inputs.sub_seeds(seed, 3)
        g = inputs.generator(device, data_seed)
        h, w, n = cfg["height"], cfg["width"], mix["payload_pairs"]
        self.images = inputs.stereo_u8(g, n, h, w)
        self.targets = inputs.disparity(g, n, h, w, float(cfg["max_disparity"]),
                                        mix["invalid_share"])
        self.p0 = weights(cfg, weight_seed, device)
        self.phases.mark("data and weights")
        model = PSMNet(max_disparity=cfg["max_disparity"], channels=cfg["channels"],
                       spp_pools=tuple(cfg["spp_pools"]),
                       compute_dtype=getattr(torch, cfg["compute_dtype"]["train"]),
                       device=device)
        model.load_state_dict(state_dict(self.p0, cfg))
        optimizer = make_adamw(model.parameters(), mix["lr"], mix["weight_decay"])
        self.state = create_train_state(model, optimizer, seed=self.step_seed)
        self.step = make_device_data_train_step(self.images, self.targets, self.batch,
                                                AugmentConfig(**mix["augment"]))
        self.phases.mark("program")
        self.program = self._first_steps()
        self.phases.mark("checked steps")
        self.ref = None

    def _first_steps(self) -> dict:
        """``ResidentCell._first_steps``, the first step's outputs
        (``first_preds``), taken where the model returns them, and its loss's
        weighted sum and count of targets (``first_sums``, its ``LossStats``)."""
        kept: list = []
        sums: list = []
        step = self.step

        def keep(module, args, outputs) -> None:
            if not kept:
                kept.append(tuple(o.detach().clone() for o in outputs))

        def first_sums(state):
            state, stats = step(state)
            if not sums:
                sums.append((float(stats.nll_sum), float(stats.valid_count)))
            return state, stats

        hook = self.state.model.register_forward_hook(keep)
        self.step = first_sums
        try:
            program = super()._first_steps()
        finally:
            hook.remove()
            self.step = step
        program["first_preds"] = kept[0]
        program["first_sums"] = sums[0]
        return program

    def split(self, units: int) -> dict[str, float]:
        """``conv_ms`` over ``units`` more steps under a capture that records
        the operators' shapes; the port's spans recorded meanwhile are set
        aside, so the span metrics read the traced stretch alone."""
        from torch.profiler import ProfilerActivity, profile

        from stereo_depth_estimation_tpu_torch import spans

        sync(self.device)
        with spans.set_aside(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                        record_shapes=True) as prof:
            for _ in range(units):
                self.unit()
            sync(self.device)
        return conv_ms(prof.events(), units)

    def numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        return psmnet_numbers(self.program, self.ref)

    def control_numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        return psmnet_numbers(self.reference(self.cfg["control_precision"]["train"]), self.ref)

    def reference(self, precision: str) -> dict:
        with strict_f32():
            return psmnet.run(
                self.p0, self.images, self.targets, self.cfg, self.batch,
                inputs.generator(self.device, self.step_seed), self.mix["augment"],
                self.mix["lr"], self.mix["weight_decay"], self.mix["checked_steps"], precision)
