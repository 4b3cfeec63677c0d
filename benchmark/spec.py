"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic mix and kind, its limits and the readers of its
per-layer metrics. A later cell, configuration, mix or metric is a new file
and a new entry; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return load_json(ROOT / entry["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    """The traffic mix: a data file naming its kind and its parameters."""
    return load_json(HERE / "traffic" / f"{name}.json")


def kind(name: str):
    """The traffic kind's code, ``traffic/<kind>.py``."""
    return importlib.import_module(f"benchmark.traffic.{name}")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read(record) -> float | None``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    module_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in metric_name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
