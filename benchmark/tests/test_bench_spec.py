"""BENCHMARK.json and the files it names: every cell finds its parts by name,
and every name and shape keeps to the format BENCHMARK.json follows."""

from __future__ import annotations

import importlib
import json
import math
import re

import pytest

from benchmark import faults, spec

from .conftest import BENCH

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command() -> None:
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cell_names_are_unique_and_few_cells_take_four_chips() -> None:
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_a_cell_finds_its_parts_by_name(entry) -> None:
    cfg = spec.config(BENCH, entry["config"])
    mix = spec.mix(entry["traffic"])
    kind = spec.kind(mix["kind"])
    assert hasattr(kind, "Cell")
    assert kind.FAULTS and set(kind.FAULTS) <= set(faults.NAMES)
    assert set(kind.TINY_MIX) <= set(mix)  # a tiny mix cuts the mix's own keys
    assert isinstance(kind.WINDOW, bool) and "." in kind.MODEL_CLASS  # module.Class
    assert kind.SPAN_UNIT is None or NAME.match(kind.SPAN_UNIT)
    limits = spec.limits(entry["name"])
    assert set(limits) == set(kind.NUMBERS)
    for number in limits.values():
        assert 0 < number["limit"] < math.inf
    assert cfg["name"] == entry["config"]
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    ends = {m["name"] for m in spec.end_to_end(BENCH, entry["name"])}
    assert "setup_s" in ends and len(ends) >= 2
    assert spec.per_layer(BENCH, entry["name"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_a_config_is_the_published_width(entry) -> None:
    """The parameters and FLOPs the file states are its reference's own, at
    the file's sizes and at its tiny cut."""
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert entry["file"].startswith("benchmark/configs/")
    assert entry["reduced"] == cfg["reduced"]
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    shapes = ref.parameter_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"]
    assert ref.forward_flops(cfg) == cfg["forward_flops"]
    assert set(cfg["tiny"]) - {"forward_flops"} <= set(cfg)
    assert ref.forward_flops(dict(cfg, **cfg["tiny"])) == cfg["tiny"]["forward_flops"]
    assert len(entry["source"]) <= 200


def test_every_metric_is_well_formed() -> None:
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert BENCH["end_to_end"][0]["name"] == "setup_s"
    moved = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moved and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 0 < len(m["layer"]) <= 200
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            reported = {e["name"] for e in spec.end_to_end(BENCH, cell)}
            assert m["moves"] in reported


def test_a_roofline_or_mfu_is_a_percent() -> None:
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


@pytest.mark.parametrize("moved", [m["name"] for m in BENCH["end_to_end"]][1:])
def test_per_layer_reports_follow_the_workloads_key(moved) -> None:
    """A listed metric goes to the cells it lists; one without a list to
    every cell that reports the end-to-end metric it moves."""
    fake = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "x", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": moved}])
    for w in BENCH["workloads"]:
        got = {m["name"] for m in spec.per_layer(fake, w["name"])}
        listed = {m["name"] for m in BENCH["per_layer"] if w["name"] in m["workloads"]}
        moves = moved in {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
        assert got == listed | ({"x"} if moves else set()), w["name"]


def test_every_file_under_the_benchmark_is_named_from_name_characters() -> None:
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    json.dumps(BENCH)
