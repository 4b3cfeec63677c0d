"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``limits/<cell>.json``).

Training (steps 1-3 from the same weights, batches and random draws):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient, leaf by leaf, as the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf; the worst leaf;
- ``change_gap``: the same for the change of the parameters over the three
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move under AdamW by round-off alone);
- ``grad_diff_median``: the first gradient's difference, leaf by leaf: the
  norm of the program's gradient less the reference's, over the same floor;
  the median leaf. The loss (a mean over every pixel) and norm gaps (second
  order in a random error) average a lower precision's rounding away, and
  the worst leaf's difference is a deep leaf's, which the backward through
  the batch-statistic BatchNorms leaves about half noise even in bfloat16;
  the median leaf reads the precision, steadily from seed to seed.
Serving (every sampled frame or batch):
- ``disp_gap``, ``logvar_gap``: the largest absolute gap over the largest
  magnitude of the reference's output;
- ``view_gap``: the mean gap of the uint8 views, in levels.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

ROUND_OFF_LEAF = 1e-3


def _leaf_gap(got: dict, want: dict, names) -> float:
    floor = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], floor) for n in names)


def train_numbers(got: dict, want: dict) -> dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    names = list(want["grad"])
    floor = statistics.median(want["grad"].values())
    moved = [n for n in names if want["grad"][n] >= ROUND_OFF_LEAF * floor]
    diff = {n: float((got["first_grad"][n] - want["first_grad"][n]).norm()) for n in names}
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(got["grad"], want["grad"], names),
        "change_gap": _leaf_gap(got["change"], want["change"], moved),
        "grad_diff_median": statistics.median(diff[n] / max(want["grad"][n], floor)
                                              for n in names),
    }


def output_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def view_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    return float(np.abs(got.astype(np.int32) - want.astype(np.int32)).mean())


def serving_numbers(got: list, want: list, views: bool) -> dict[str, float]:
    """Worst over the sampled outputs, each (disparity, logvar[, left view,
    right view])."""
    out = {
        "disp_gap": max(output_gap(g[0], w[0]) for g, w in zip(got, want)),
        "logvar_gap": max(output_gap(g[1], w[1]) for g, w in zip(got, want)),
    }
    if views:
        out["view_gap"] = max(view_gap(a, b) for g, w in zip(got, want)
                              for a, b in zip(g[2:4], w[2:4]))
    return out


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at most
    its limit; a number without a limit fails."""
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
