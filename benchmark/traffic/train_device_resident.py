"""Training over a payload held on the device, one step a call.

The port's ``make_device_data_train_step`` over ``create_train_state``: each
call gathers its batch by the pass's ``randperm``, augments it (K1, gray
means, noise and clamp), runs the StereoUNet forward in the configuration's
training dtype (K2 pools, BatchNorm, ReLU), the masked Laplace NLL, the
backward (K3) and AdamW. Set-up builds that one object and drives it from
the seed through its first ``checked_steps`` steps, which the reference
follows; the window continues the same object.

A mix with a ``compile`` key (``{"mode": ..., "backend": ...}``, the
trainer's ``--compile-mode`` and ``--compile-backend``) runs the model
through ``torch.compile`` as the trainer's ``--compile`` does; the checked
steps compile it. A mix with a ``rate_metric`` key reports the window's
pairs a second under that name, the cell's own end-to-end metric, in place
of ``train_pairs_per_s``.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import compare, inputs
from ..reference import train as reference_train
from .common import Phases, strict_f32, sync

FAULTS = ("unchanged", "half_batch", "altered")
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_diff_median")
TINY_MIX = {"batch": 4, "payload_pairs": 24, "trace_units": 1}
WINDOW = False  # the checked steps are set-up's: the readings need no window
MODEL_CLASS = "stereo_depth_estimation_tpu_torch.models.unet.StereoUNet"
SPAN_UNIT = "train.step"


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device) -> None:
        from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet
        from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
        from stereo_depth_estimation_tpu_torch.parallel.train_step import (
            CompileOptions, create_train_state, make_adamw, make_device_data_train_step)

        self.phases = Phases(device)
        self.cfg, self.mix, self.device = cfg, mix, device
        self.batch = mix["batch"]
        data_seed, weight_seed, self.step_seed = inputs.sub_seeds(seed, 3)
        g = inputs.generator(device, data_seed)
        h, w, n = cfg["height"], cfg["width"], mix["payload_pairs"]
        self.images = inputs.stereo_u8(g, n, h, w)
        self.targets = inputs.disparity(g, n, h, w, mix["max_disparity"], mix["invalid_share"])
        self.p0 = inputs.weights(cfg, weight_seed, device)
        self.phases.mark("data and weights")
        model = StereoUNet(in_channels=cfg["in_channels"], base_channels=cfg["base_channels"],
                           compute_dtype=getattr(torch, cfg["compute_dtype"]["train"]),
                           device=device)
        model.load_state_dict(inputs.state_dict(self.p0, cfg))
        optimizer = make_adamw(model.parameters(), mix["lr"], mix["weight_decay"])
        compile_options = None
        if "compile" in mix:
            # A model compiled earlier in this process (a test's, a reading's
            # with another fault planted) must not serve this one.
            torch._dynamo.reset()
            compile_options = CompileOptions(**mix["compile"])
        self.state = create_train_state(model, optimizer, seed=self.step_seed,
                                        compile=compile_options)
        self.step = make_device_data_train_step(self.images, self.targets, self.batch,
                                                AugmentConfig(**mix["augment"]))
        self.phases.mark("program")
        self.program = self._first_steps()
        self.phases.mark("checked steps")
        self.ref = None

    def _first_steps(self) -> dict:
        """The checked steps: each loss, the first gradient per leaf (from
        AdamW's first moment after one step) and each leaf's change."""
        model, optimizer = self.state.model, self.state.optimizer
        names, params = zip(*model.named_parameters())
        beta1 = optimizer.param_groups[0]["betas"][0]
        losses = []
        for k in range(self.mix["checked_steps"]):
            self.state, stats = self.step(self.state)
            losses.append(stats.nll_sum / stats.valid_count)
            if k == 0:
                first = {n: optimizer.state[p]["exp_avg"] / (1.0 - beta1)
                         for n, p in zip(names, params)}
                grad = torch.stack([g.norm() for g in first.values()])
        change = torch.stack([(p.detach() - self.p0[n]).norm() for n, p in zip(names, params)])
        sync(self.device)
        return {"loss": [float(v) for v in losses], "grad": dict(zip(names, grad.tolist())),
                "change": dict(zip(names, change.tolist())), "first_grad": first}

    def unit(self) -> None:
        self.state, _ = self.step(self.state)

    def window(self, seconds: float) -> tuple[dict, int, int]:
        nll, steps = [], 0
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.state, stats = self.step(self.state)
            nll.append(stats.nll_sum)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(nll))).sum()) * self.batch
        pairs = steps * self.batch
        self.window_units, self.window_s = steps, elapsed
        rate = self.mix.get("rate_metric", "train_pairs_per_s")
        return {rate: pairs / elapsed}, pairs, failed

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        del self.state, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> dict:
        with strict_f32():
            return reference_train.run(
                self.p0, self.images, self.targets, self.batch,
                inputs.generator(self.device, self.step_seed), self.mix["augment"],
                self.mix["lr"], self.mix["weight_decay"], self.mix["checked_steps"], precision)

    def numbers(self) -> dict[str, float]:
        """The program's numbers against the float32 reference."""
        self.ref = self.ref or self.reference("f32")
        return compare.train_numbers(self.program, self.ref)

    def control_numbers(self) -> dict[str, float]:
        """The reference one precision below the configuration's, put in the
        program's place."""
        self.ref = self.ref or self.reference("f32")
        low = self.reference(self.cfg["control_precision"]["train"])
        return compare.train_numbers(low, self.ref)
