"""Offline prediction: the predict CLI's loop without PNG decode and file
writes, closed loop.

For each batch: a seeded uint8 (B, H, W, 6) host batch ->
``torch.from_numpy(batch).to(device)`` -> ``make_predict_fn(model)`` (eval
mode, the configuration's serving dtype, eager) -> ``.cpu().numpy()`` of
the disparity and the log-variance.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import compare, inputs
from ..reference import frame as reference_frame
from .common import Phases, Sampler, closed_loop, strict_f32, sync

FAULTS = ("half_batch", "altered")
NUMBERS = ("disp_gap", "logvar_gap")
TINY_MIX = {"batch": 3, "distinct_batches": 2, "checked_batches": 2}
WINDOW = True
MODEL_CLASS = "stereo_depth_estimation_tpu_torch.models.unet.StereoUNet"
SPAN_UNIT = None  # the predict loop records no unit span


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device) -> None:
        from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet
        from stereo_depth_estimation_tpu_torch.parallel.train_step import make_predict_fn

        self.phases = Phases(device)
        self.cfg, self.mix, self.device = cfg, mix, device
        self.batch = mix["batch"]
        data_seed, weight_seed, self.sample_seed = inputs.sub_seeds(seed, 3)
        raw = inputs.stereo_u8(inputs.generator(device, data_seed),
                               mix["distinct_batches"] * self.batch, cfg["height"], cfg["width"])
        raw = raw.cpu().numpy()
        self.batches = [raw[i * self.batch:(i + 1) * self.batch]
                        for i in range(mix["distinct_batches"])]
        self.state_dict = inputs.serving_weights(cfg, mix, weight_seed, device)
        self.phases.mark("batches and weights")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        model = StereoUNet(in_channels=cfg["in_channels"], base_channels=cfg["base_channels"],
                           compute_dtype=getattr(torch, cfg["compute_dtype"]["serve"]),
                           device=device).eval()
        model.load_state_dict(self.state_dict)
        self.predict_fn = make_predict_fn(model)
        self.phases.mark("program")
        for i in range(mix["warmup_batches"]):
            self._run(i)
        self.phases.mark("warm-up")
        self._next = 0
        self.kept: list = []
        self.ref = None

    def _run(self, i: int):
        disp, logvar = self.predict_fn(
            torch.from_numpy(self.batches[i % len(self.batches)]).to(self.device))
        return disp.cpu().numpy(), logvar.cpu().numpy()

    def unit(self) -> None:
        self._next += 1
        self._run(self._next)

    def window(self, seconds: float) -> tuple[dict, int, int]:
        sampler = Sampler(self.sample_seed, self.mix["checked_batches"], seconds)
        times, elapsed = closed_loop(self._run, seconds, sampler)
        self.kept = sampler.kept
        self.window_units, self.window_s = len(times), elapsed
        pairs = len(times) * self.batch
        failed = self.batch * sum(not (np.isfinite(o[0]).all() and np.isfinite(o[1]).all())
                                  for _, o in self.kept)
        return {"predict_pairs_per_s": pairs / elapsed}, pairs, failed

    def release(self) -> None:
        del self.predict_fn
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> list:
        out = []
        with strict_f32(), torch.no_grad():
            for i, _ in self.kept:
                batch = torch.from_numpy(self.batches[i % len(self.batches)]).to(self.device)
                out.append(reference_frame.predict(self.state_dict, batch, precision))
        return out

    def numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        return compare.serving_numbers([o for _, o in self.kept], self.ref, views=False)

    def control_numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        low = self.reference(self.cfg["control_precision"]["serve"])
        return compare.serving_numbers(low, self.ref, views=False)
