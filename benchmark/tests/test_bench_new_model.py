"""A model's cell comes in as new files and entries alone: a copy of the
benchmark takes the toy two-layer model of ``toy/`` (its reference,
configuration, traffic kind and mix, limits, per-layer metric and the
entries for ``BENCHMARK.json``), with no file of the copy edited and the
entries appended, and its spec, sound-run, planted-fault and control tests
pass there unedited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import spec

TOY = Path(__file__).resolve().parent / "toy"
TOY_CELL = "toy2layer"


def add_toy(root: Path) -> None:
    """Copies the benchmark to ``root`` and adds the toy there as new files
    and appended entries."""
    shutil.copytree(spec.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for src in TOY.rglob("*"):
        if src.is_file() and src.name != "entries.json" and "__pycache__" not in src.parts:
            dst = root / "benchmark" / src.relative_to(TOY)
            assert not dst.exists(), f"{dst} would be edited, not added"
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in json.loads((TOY / "entries.json").read_text()).items():
        bench[key] = bench[key] + entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")


def test_a_new_model_comes_in_as_new_files_and_entries_alone(tmp_path) -> None:
    root = tmp_path / "checkout"
    add_toy(root)
    before = {p.relative_to(spec.ROOT): p.read_bytes() for p in spec.HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
    old, new = spec.benchmark(), json.loads((root / "BENCHMARK.json").read_text())
    for key, value in old.items():
        assert new[key][:len(value)] == value if isinstance(value, list) else new[key] == value
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_spec.py", "benchmark/tests/test_bench_faults.py",
         "-k", f"test_bench_spec or {TOY_CELL}"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {line.split(" PASSED")[0].split("::")[-1] for line in out.stdout.splitlines()
              if " PASSED" in line}
    assert {f"test_a_cell_finds_its_parts_by_name[{TOY_CELL}]",
            "test_a_config_is_the_published_width[toy-2layer]",
            f"test_a_sound_run_is_correct[{TOY_CELL}]",
            f"test_a_planted_fault_is_not_correct[{TOY_CELL}-altered]",
            f"test_the_control_is_not_correct[{TOY_CELL}]"} <= passed, out.stdout[-4000:]
