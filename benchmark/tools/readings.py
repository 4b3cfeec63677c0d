"""The readings a cell's limits are set from, on the card, in one process:

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

For every seed, the program's numbers against the float32 reference after
set-up and a window of ``--seconds`` at the cell's own load (none where
the kind's ``WINDOW`` is false: training, whose checked steps are
set-up's); for each control seed, the reference one precision below the
configuration's in the program's place; for each fault seed, the program
with each of the kind's faults planted (its ``FAULTS``, ``faults.py``). One
JSON line each, on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def _detail(got: dict, want: dict) -> dict:
    """A training side's look: each step's relative loss gap, and the three
    worst leaves of the first gradient and of the change, with the gap and
    the reference's norm."""
    import statistics

    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]}
    out["leaves"] = {n: [got["grad"][n], want["grad"][n], got["change"][n], want["change"][n],
                         float((got["first_grad"][n] - want["first_grad"][n]).norm())]
                     for n in want["grad"]}
    out["loss"] = [got["loss"], want["loss"]]
    for key in ("grad", "change"):
        floor = statistics.median(want[key].values())
        gaps = sorted(((abs(got[key][n] - want[key][n]) / max(want[key][n], floor), n,
                        want[key][n]) for n in want[key]), reverse=True)
        out[key] = [[n, gap, norm] for gap, n, norm in gaps[:3]] + [["median", floor]]
    return out


def readings(cell_name: str, seed: int, seconds: float, device, control: bool = False,
             fault: str | None = None, detail: bool = False) -> dict:
    import contextlib

    import torch

    from benchmark import faults, harness, spec

    _, cfg, mix, _ = harness.parts(spec.benchmark(), cell_name)
    kind = spec.kind(mix["kind"])
    t0 = time.perf_counter()
    with faults.planted(fault, kind) if fault else contextlib.nullcontext():
        cell = kind.Cell(cfg, mix, seed, device)
        if seconds > 0:
            cell.window(seconds)
        cell.release()
        out = {"cell": cell_name, "seed": seed, "side": fault or "program",
               "numbers": cell.numbers()}
        if detail and hasattr(cell, "program"):
            out["detail"] = _detail(cell.program, cell.ref)
    if control:
        out["control"] = cell.control_numbers()
        if detail and hasattr(cell, "program"):
            out["control_detail"] = _detail(cell.reference(
                cfg["control_precision"]["train"]), cell.ref)
    out["seconds"] = time.perf_counter() - t0
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--fault-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--detail", action="store_true",
                        help="training: each step's loss gap and the worst leaves")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, spec

    device = torch.device(args.device)
    _, _, mix, _ = harness.parts(spec.benchmark(), args.workload)
    kind = spec.kind(mix["kind"])
    seconds = args.seconds if kind.WINDOW else 0.0
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, seconds, device,
                                  control=seed in args.control_seeds, detail=args.detail)),
              flush=True)
    for seed in args.fault_seeds:
        for fault in kind.FAULTS:
            print(json.dumps(readings(args.workload, seed, seconds, device, fault=fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
