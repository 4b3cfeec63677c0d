"""The import check, and the card check of ``run.py``."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import guard, spec


def test_the_import_check_compares_whole_top_level_names() -> None:
    assert guard.banned_modules(["stereo_depth_estimation_tpu.ops.loss"]) == [
        "stereo_depth_estimation_tpu.ops.loss"]
    assert guard.banned_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                 "optax", "orbax.checkpoint", "chip_smoke", "bench",
                                 "augment_timing"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
         "orbax.checkpoint", "chip_smoke", "bench", "augment_timing"])
    assert guard.banned_modules(["stereo_depth_estimation_tpu_torch.ops.loss",
                                 "stereo_depth_estimation_tpu_torch", "jaxtyping",
                                 "benchmark.harness", "bench_x"]) == []


def test_a_run_loads_no_banned_module() -> None:
    """Everything a run imports, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, faults, readers, guard, spec\n"
        "for w in spec.benchmark()['workloads']: spec.kind(spec.mix(w['traffic'])['kind'])\n"
        "import stereo_depth_estimation_tpu_torch.live.depth_live_dl\n"
        "import stereo_depth_estimation_tpu_torch.parallel.train_step\n"
        "print(guard.banned_modules())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path) -> None:
    cell = spec.benchmark()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "card" in out.stderr
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result: {line}")
