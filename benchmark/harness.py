"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the check against the reference, and the result line.

The last line on standard output is the result, one JSON object; the lines
before it on standard error end with each number compared beside its
limit. A run that cannot finish prints no result and exits non-zero: no
card, too few cards, an error, or a banned module loaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from . import compare, guard, spec, tracing


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def trace_record(cell, trace: dict, cfg: dict, mix: dict, e2e: dict) -> dict:
    """What a per-layer reader reads: the traced stretch, the window's
    end-to-end values, the configuration and the mix."""
    import torch

    record = dict(trace)
    record.update(cfg=cfg, mix=mix, window=e2e, tf32=bool(torch.backends.cudnn.allow_tf32),
                  window_units=cell.window_units, window_elapsed_s=cell.window_s)
    if hasattr(cell, "split"):
        record["split_ms"] = cell.split(mix["split_frames"])
    return record


def parts(bench: dict, cell_name: str) -> tuple[dict, dict, dict, dict]:
    """The cell's entry, configuration, traffic mix and limits, by name."""
    entry = spec.cell(bench, cell_name)
    return (entry, spec.config(bench, entry["config"]), spec.mix(entry["traffic"]),
            spec.limits(cell_name))


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, cell_parts: tuple | None = None) -> dict:
    """Everything after the look for a card: the result's fields, with the
    numbers compared under ``checks``. ``cell_parts`` stands in for the
    cell's files (``parts``)."""
    import torch

    entry, cfg, mix, limits = cell_parts or parts(bench, cell_name)
    t_cell = time.perf_counter()
    cell = spec.kind(mix["kind"]).Cell(cfg, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {setup_s:.3f} s, of which {t_cell - t_start:.3f} s before the cell "
          "(interpreter, imports, CUDA) and in the cell " + ", ".join(
              f"{name} {sec:.3f} s" for name, sec in cell.phases.items()), file=sys.stderr)
    e2e, attempted, failed = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = None
    if trace:
        traced = tracing.trace_units(cell.unit, mix["trace_units"])
        record = trace_record(cell, traced, cfg, mix, e2e)
    cell.release()
    numbers = cell.numbers()
    correct, checks = compare.judge(numbers, limits)
    values = {"setup_s": setup_s, **e2e}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if record is None:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, cell_name)}
    else:
        metrics = {}
        for m in spec.per_layer(bench, cell_name):
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    result = {
        "correct": bool(correct and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": entry["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if record is not None:
        result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    result["checks"] = checks
    return result


def main(args, t_start: float) -> int:
    import torch

    bench = spec.benchmark()
    entry = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); {found} found. "
              "The benchmark runs on the card only.", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, t_start)
    banned = guard.banned_modules()
    if banned:
        print("modules that the benchmark may not load were loaded: " + ", ".join(banned),
              file=sys.stderr)
        return 3
    print(f"card: {_card_line()}; cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}; "
          f"torch {torch.__version__}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
