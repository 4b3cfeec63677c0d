"""A toy traffic kind for the benchmark's CPU tests: ``ToyNet``, standing in
for a program's model, over seeded batches held on the device, closed loop;
each sampled batch's output against the reference ``toy2``."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import compare, inputs
from ..reference import toy2
from .common import Phases, Sampler, closed_loop, strict_f32

FAULTS = ("altered",)
NUMBERS = ("out_gap",)
TINY_MIX = {"batch": 2, "checked_batches": 2}
WINDOW = True
MODEL_CLASS = "benchmark.traffic.toy_batches.ToyNet"
SPAN_UNIT = None


class ToyNet(nn.Module):
    def __init__(self, in_channels: int, hidden: int) -> None:
        super().__init__()
        self.layer1 = nn.Conv2d(in_channels, hidden, 1)
        self.layer2 = nn.Conv2d(hidden, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer2(torch.relu(self.layer1(x)))[:, 0]


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device) -> None:
        self.phases = Phases(device)
        self.cfg, self.mix, self.device = cfg, mix, device
        data_seed, weight_seed, self.sample_seed = inputs.sub_seeds(seed, 3)
        self.batches = torch.rand(
            (mix["distinct_batches"], mix["batch"], cfg["in_channels"], cfg["height"],
             cfg["width"]), generator=inputs.generator(device, data_seed), device=device)
        g = inputs.generator(device, weight_seed)
        shapes = toy2.parameter_shapes(cfg)
        self.p = {n: torch.randn(s, generator=g, device=device) / math.sqrt(math.prod(s[1:]))
                  for n, s in shapes.items()}
        self.phases.mark("data and weights")
        self.model = ToyNet(cfg["in_channels"], cfg["hidden"]).to(device)
        self.model.load_state_dict(self.p)
        self.phases.mark("program")
        self.kept: list = []
        self.ref = None

    def _run(self, i: int) -> np.ndarray:
        with torch.no_grad():
            return self.model(self.batches[i % len(self.batches)]).cpu().numpy()

    def unit(self) -> None:
        self._run(0)

    def window(self, seconds: float) -> tuple[dict, int, int]:
        sampler = Sampler(self.sample_seed, self.mix["checked_batches"], seconds)
        times, elapsed = closed_loop(self._run, seconds, sampler)
        self.kept = sampler.kept
        self.window_units, self.window_s = len(times), elapsed
        failed = self.mix["batch"] * sum(not np.isfinite(o).all() for _, o in self.kept)
        return {"toy_batches_per_s": len(times) / elapsed}, len(times) * self.mix["batch"], failed

    def release(self) -> None:
        del self.model

    def reference(self, precision: str) -> list:
        with strict_f32(), torch.no_grad():
            return [toy2.forward(self.p, self.batches[i % len(self.batches)], precision)
                    .cpu().numpy() for i, _ in self.kept]

    def numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        return {"out_gap": max(compare.output_gap(o, r)
                               for (_, o), r in zip(self.kept, self.ref))}

    def control_numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        low = self.reference(self.cfg["control_precision"]["serve"])
        return {"out_gap": max(compare.output_gap(a, b) for a, b in zip(low, self.ref))}
