"""A run with the timed path broken underneath, and the control in the
program's place, must come out not correct; a sound run must come out
correct. Tiny cells on the CPU, the harness's look for a card skipped."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import compare, faults, harness, spec

from .conftest import BENCH, CELLS, kind_of, tiny_parts


def _run(cell: str) -> dict:
    return harness.run_cell(BENCH, cell, 2**31 + 11, 0.3, False, torch.device("cpu"),
                            time.perf_counter(), tiny_parts(cell))


def test_a_sound_run_is_correct(cell_name) -> None:
    result = _run(cell_name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end(BENCH, cell_name)}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in kind_of(c).FAULTS])
def test_a_planted_fault_is_not_correct(cell, fault) -> None:
    with faults.planted(fault, kind_of(cell)):
        result = _run(cell)
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct(cell_name) -> None:
    _, cfg, mix, limits = tiny_parts(cell_name)
    cell = spec.kind(mix["kind"]).Cell(cfg, mix, 2**31 + 12, torch.device("cpu"))
    cell.window(0.2)
    cell.release()
    correct, checks = compare.judge(cell.control_numbers(), limits)
    assert not correct, checks
