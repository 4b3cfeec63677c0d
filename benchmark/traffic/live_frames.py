"""The live viewer: one viewer, closed loop, unpaced.

``LiveDepthEngine.process`` on seeded BGR uint8 capture pairs held on the
host, the next pair as soon as the last returns: upload, scale, rectify at
capture size, resize to the model size, the StereoUNet in eval mode and the
uint8 views, back on the host. Each frame's latency is the host clock
around that call.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from .. import compare, inputs
from ..reference import frame as reference_frame
from ..spec import HERE
from .common import Phases, Sampler, closed_loop, strict_f32, sync

FAULTS = ("altered",)
NUMBERS = ("disp_gap", "logvar_gap", "view_gap")
TINY_MIX = {"distinct_frames": 3, "checked_frames": 3, "warmup_frames": 1}
WINDOW = True
MODEL_CLASS = "stereo_depth_estimation_tpu_torch.models.unet.StereoUNet"
SPAN_UNIT = "live.frame"


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device) -> None:
        from stereo_depth_estimation_tpu_torch.live.depth_live_dl import LiveDepthEngine
        from stereo_depth_estimation_tpu_torch.ops.remap import Rectifier

        self.phases = Phases(device)
        self.cfg, self.mix, self.device = cfg, mix, device
        frame_seed, weight_seed, self.sample_seed = inputs.sub_seeds(seed, 3)
        with np.load(HERE / "data" / mix["calibration"]) as f:
            self.calib = {k: f[k] for k in f.files}
        ch, cw = mix["capture_hw"]
        raw = torch.randint(0, 256, (mix["distinct_frames"], 2, ch, cw, 3), dtype=torch.uint8,
                            generator=inputs.generator(device, frame_seed), device=device)
        raw = raw.cpu().numpy()
        self.frames = [(raw[i, 0], raw[i, 1]) for i in range(raw.shape[0])]
        self.state_dict = inputs.serving_weights(cfg, mix, weight_seed, device)
        self.phases.mark("frames and weights")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.engine = LiveDepthEngine((cfg["width"], cfg["height"]),
                                      Rectifier.from_calibration(self.calib, device), device,
                                      cfg["base_channels"], compile=None)
        self.engine.model.load_state_dict(self.state_dict)
        self.phases.mark("program")
        for i in range(mix["warmup_frames"]):
            self.engine.process(*self.frames[i % len(self.frames)])
        self.phases.mark("warm-up")
        self._next = 0
        self.kept: list = []
        self.ref = None

    def _pair(self, i: int):
        return self.frames[i % len(self.frames)]

    def unit(self) -> None:
        self._next += 1
        self.engine.process(*self._pair(self._next))

    def window(self, seconds: float) -> tuple[dict, int, int]:
        sampler = Sampler(self.sample_seed, self.mix["checked_frames"], seconds)
        times, elapsed = closed_loop(lambda i: self.engine.process(*self._pair(i)),
                                     seconds, sampler)
        frames = len(times)
        self.kept = sampler.kept
        self.window_units = frames
        self.window_s = elapsed
        ms = np.asarray(times) * 1e3
        failed = sum(not (np.isfinite(o[0]).all() and np.isfinite(o[1]).all())
                     for _, o in self.kept)
        return ({"live_frame_ms_p50": float(np.percentile(ms, 50)),
                 "live_frame_ms_p95": float(np.percentile(ms, 95))}, frames, failed)

    def split(self, frames: int) -> dict[str, float]:
        """Median milliseconds of each stage of ``process``, host clock, with
        a synchronise after each."""
        spans: dict[str, list[float]] = {k: [] for k in ("upload", "preprocess", "forward",
                                                         "download")}
        e = self.engine
        for i in range(frames):
            sync(self.device)
            t0 = time.perf_counter()
            up = e.upload(*self._pair(i))
            sync(self.device)
            t1 = time.perf_counter()
            views = e.preprocess(*up)
            sync(self.device)
            t2 = time.perf_counter()
            out = e.forward(*views)
            sync(self.device)
            t3 = time.perf_counter()
            e.download(*out)
            t4 = time.perf_counter()
            for k, (a, b) in zip(spans, ((t0, t1), (t1, t2), (t2, t3), (t3, t4))):
                spans[k].append((b - a) * 1e3)
        return {k: statistics.median(v) for k, v in spans.items()}

    def release(self) -> None:
        del self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> list:
        maps = reference_frame.maps(self.calib, self.device)
        hw = (self.cfg["height"], self.cfg["width"])
        with strict_f32(), torch.no_grad():
            return [reference_frame.live_frame(self.state_dict, maps, *self._pair(i), hw,
                                               precision) for i, _ in self.kept]

    def numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        return compare.serving_numbers([o for _, o in self.kept], self.ref, views=True)

    def control_numbers(self) -> dict[str, float]:
        self.ref = self.ref or self.reference("f32")
        low = self.reference(self.cfg["control_precision"]["serve"])
        return compare.serving_numbers(low, self.ref, views=True)
