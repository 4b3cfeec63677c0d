"""Tiny cells for the benchmark's CPU tests: the cells' own configurations,
mixes and limits, cut to base 4 at 32x48 and a handful of pairs."""

from __future__ import annotations

import pytest

from benchmark import harness, spec
from benchmark.reference.unet import conv_macs

CELLS = ("train-240x320-b128", "live-240x320-b1", "train-96x128-b256", "predict-240x320-b30")
TINY_MIX = {
    "train_device_resident": {"batch": 4, "payload_pairs": 24, "trace_units": 1},
    "predict_batches": {"batch": 3, "distinct_batches": 2, "checked_batches": 2},
    "live_frames": {"distinct_frames": 3, "checked_frames": 3, "warmup_frames": 1},
}


def tiny_parts(cell: str) -> tuple[dict, dict, dict, dict]:
    """The cell's parts at base 4, 32x48. The train step runs in float32
    here, where the port and the reference agree to round-off, so the
    cell's limits judge only what a test plants."""
    entry, cfg, mix, limits = harness.parts(spec.benchmark(), cell)
    cfg = dict(cfg, base_channels=4, height=32, width=48,
               forward_flops=2 * conv_macs(4, 32, 48),
               compute_dtype=dict(cfg["compute_dtype"], train="float32"))
    return entry, cfg, dict(mix, **TINY_MIX[mix["kind"]]), limits


@pytest.fixture(params=CELLS)
def cell_name(request) -> str:
    return request.param
