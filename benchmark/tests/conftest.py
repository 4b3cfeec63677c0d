"""Tiny cells for the benchmark's CPU tests: every cell of BENCHMARK.json,
with its configuration cut to the file's ``tiny`` sizes and its mix to its
kind's ``TINY_MIX``."""

from __future__ import annotations

import pytest

from benchmark import harness, spec

BENCH = spec.benchmark()
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def kind_of(cell: str):
    return spec.kind(spec.mix(spec.cell(BENCH, cell)["traffic"])["kind"])


def tiny_config(cfg: dict) -> dict:
    """The configuration at its ``tiny`` sizes. The train step runs in
    float32 here, where the port and the reference agree to round-off, so a
    cell's limits judge only what a test plants."""
    return dict(cfg, **cfg["tiny"], compute_dtype=dict(cfg["compute_dtype"], train="float32"))


def tiny_parts(cell: str) -> tuple[dict, dict, dict, dict]:
    entry, cfg, mix, limits = harness.parts(BENCH, cell)
    return entry, tiny_config(cfg), dict(mix, **spec.kind(mix["kind"]).TINY_MIX), limits


@pytest.fixture(params=CELLS)
def cell_name(request) -> str:
    return request.param
