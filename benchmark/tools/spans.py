"""The program's spans in a cell's traced stretch, on the card, in one process:

    python3 -m benchmark.tools.spans --workload <cell> --seed <n> [--seconds 10] \\
        [--out <file>.json]

After set-up and a window of ``--seconds`` (spans off), four traced
stretches of the mix's ``trace_units`` units, as ``--trace 1`` takes them
(``tracing.profile``), alternately with the spans recording and with them
made no-ops. Reports, as one JSON object on standard output (and in
``--out``):

- ``off_ns_per_span``: host ns a loop pass with a span takes with no
  capture recording (``empty_loop_ns``: the pass without);
- ``on_us_per_span``: host us a loop pass takes inside a capture, with a
  bare ``record_function`` and with a span;
- ``device_rows_named_after_spans``: rows of the device list that
  ``tracing.split_events`` builds that carry a span's name (the profiler's
  device-side annotation rows must all be dropped), and ``annotation_rows``,
  those the capture held before the split;
- ``units``: the unit spans in the store, against ``trace_units``;
- ``ms_per_unit``: the window's host ms a unit, and each traced stretch's,
  spans on and off, with its device busy share;
- ``stages``: each span's mean and median host and device ms a unit;
- ``metrics``: the span metrics of ``BENCHMARK.json`` that the cell lists.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def off_ns_per_span(n: int = 200_000) -> tuple[float, float]:
    """Host ns a loop pass takes with a disabled span in it, and without."""
    from stereo_depth_estimation_tpu_torch.spans import span

    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("train.step"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        pass
    return (t1 - t0) / n, (time.perf_counter_ns() - t1) / n


def on_us_per_span(n: int = 2000) -> dict:
    """Host us a loop pass takes inside a capture of the host and the card:
    with a bare ``record_function``, and with a span (that and two events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_depth_estimation_tpu_torch.spans import reset, span

    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for name, enter in (("record_function", torch.profiler.record_function),
                            ("span", span)):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with enter("train.step"):
                    pass
            out[name] = (time.perf_counter_ns() - t0) / n / 1e3
    reset()
    return out


def traced(cell, units: int, spans_on: bool) -> tuple[list, float, dict, list]:
    """One traced stretch: its events, host seconds, reduction and device
    rows."""
    from benchmark import tracing
    from stereo_depth_estimation_tpu_torch import spans

    spans.reset()
    made = spans._Span
    if not spans_on:
        spans._Span = lambda name: spans.OFF
    try:
        events, host_s = tracing.profile(cell.unit, units)
    finally:
        spans._Span = made
    device, host, step = tracing.split_events(events)
    return events, host_s, tracing.reduce(device, host, step, host_s, units), device


def stages(records: list, unit: str) -> dict:
    from benchmark import program_spans

    out = {}
    for name in dict.fromkeys(r.name for r in records):
        row = {}
        for field in ("host_ms", "device_ms"):
            sums = program_spans.per_unit(records, unit, (name,), field)
            if sums is not None:
                row[field] = {"mean": statistics.fmean(sums), "median": statistics.median(sums)}
        out[name] = row
    return out


def check(cell_name: str, seed: int, seconds: float, device=None) -> dict:
    import torch
    from torch.autograd import DeviceType

    from benchmark import harness, spec
    from stereo_depth_estimation_tpu_torch import spans

    bench = spec.benchmark()
    _, cfg, mix, _ = harness.parts(bench, cell_name)
    device = device or torch.device("cuda", 0)
    cell = spec.kind(mix["kind"]).Cell(cfg, mix, seed, device)
    off_ns = off_ns_per_span()
    cell.window(seconds)
    on_us = on_us_per_span()
    units, unit = mix["trace_units"], spec.kind(mix["kind"]).SPAN_UNIT
    stretches, store = [], None
    for spans_on in (True, False, True, False):
        events, host_s, rec, device_rows = traced(cell, units, spans_on)
        records = spans.records()
        stretches.append({"spans": spans_on, "ms_per_unit": 1e3 * host_s / units,
                          "busy_pct": 100.0 * rec["busy_s"] / rec["window_s"],
                          "stored": len(records)})
        if spans_on and store is None:  # the readers read the store as it is now
            store, first_events, first_device = records, events, device_rows
            metrics = {m["name"]: spec.reader(m["name"])({}) for m in bench["per_layer"]
                       if m["source"] == "program_span" and cell_name in m["workloads"]}
    names = {r.name for r in store}
    return {
        "cell": cell_name, "seed": seed, "card": harness._card_line(),
        "torch": torch.__version__,
        "off_ns_per_span": off_ns[0], "empty_loop_ns": off_ns[1], "on_us_per_span": on_us,
        "annotation_rows": sum(e.name in names and e.device_type == DeviceType.CUDA
                               for e in first_events),
        "device_rows_named_after_spans": sum(n in names for _, _, n in first_device),
        "units": {"stored": sum(r.name == unit for r in store), "trace_units": units,
                  "dropped": spans.dropped()},
        "ms_per_unit": {"window": 1e3 * cell.window_s / cell.window_units,
                        "window_units": cell.window_units, "traced": stretches},
        "stages": stages(store, unit),
        "metrics": metrics,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = check(args.workload, args.seed, args.seconds)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
