"""What the traffic kinds share: synchronising, strict float32 for the
reference, and the seeded instants at which a closed loop keeps an output
for the check."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def strict_f32():
    """float32 products without TF32, as the reference computes them."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Phases(dict):
    """Seconds of each phase of a cell's set-up, by name."""

    def __init__(self, device: torch.device) -> None:
        super().__init__()
        self.device = device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self[name] = now - self.t
        self.t = now


class Sampler:
    """Keeps the output of the first unit that starts at or after each of
    ``count`` instants drawn from ``seed`` over the window, so the sample is
    spread over the window whatever the rate."""

    def __init__(self, seed: int, count: int, seconds: float) -> None:
        self.instants = sorted(np.random.default_rng(seed).random(count) * seconds)
        self.kept: list = []

    def offer(self, elapsed: float, key, make_output) -> None:
        if self.instants and elapsed >= self.instants[0]:
            while self.instants and elapsed >= self.instants[0]:
                self.instants.pop(0)
            self.kept.append((key, make_output()))


def closed_loop(unit, seconds: float, sampler: Sampler) -> tuple[list[float], float]:
    """Calls ``unit(i)`` (returning its output) back to back until
    ``seconds`` have passed; returns each call's host seconds and the
    window's.
    ``unit`` ends holding its output on the host, so each time is the
    whole unit's."""
    times = []
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        out = unit(i)
        t1 = time.perf_counter()
        times.append(t1 - t)
        sampler.offer(t - t0, i, lambda: out)
        i += 1
        if t1 - t0 >= seconds:
            if not sampler.kept:  # a window shorter than its first instant
                sampler.kept.append((i - 1, out))
            return times, t1 - t0
