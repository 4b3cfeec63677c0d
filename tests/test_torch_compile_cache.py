"""The compile cache across processes (``--aot-cache``), on the CPU.

Two processes run the trainer CLI with ``--compile`` (Inductor, C++ kernels
built with g++) and ``--aot-cache <dir>``, each with an empty Inductor cache
directory of its own. The first compiles and saves its artifacts to the
blob; the second loads them, so every graph hits Inductor's FX-graph cache:
it reports ``aot-cache`` with nonzero ``fxgraph_cache_hit`` and no miss, and
trains to the same metrics (the same compiled code on the same data).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
from test_torch_data import make_dataset

REPO = Path(__file__).resolve().parent.parent

_CHILD = textwrap.dedent("""
    import json, sys
    root, repo = sys.argv[1], sys.argv[2]
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(2)
    from stereo_depth_estimation_tpu_torch.training import trainer
    summary = trainer.main([
        "--dataset-root", f"{root}/data", "--height", "32", "--width", "48",
        "--epochs", "1", "--batch-size", "4", "--val-fraction", "0", "--device", "cpu",
        "--compute-dtype", "float32", "--base-channels", "4", "--num-workers", "0",
        "--no-augment", "--preview-samples", "0", "--log-every-batches", "0",
        "--mlflow-tracking-uri", f"{root}/mlruns", "--output-dir", f"{root}/outputs",
        "--compile", "--aot-cache", f"{root}/aot",
    ])
    print("RESULT " + json.dumps({"cache": summary["compile_cache"],
                                  "epochs": summary["epochs"]}), flush=True)
""")


def _run(root: Path, name: str) -> dict:
    env = {**os.environ, "TORCHINDUCTOR_CACHE_DIR": str(root / f"inductor_{name}")}
    done = subprocess.run([sys.executable, "-c", _CHILD, str(root), str(REPO)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    line = next(s for s in done.stdout.splitlines() if s.startswith("RESULT "))
    return json.loads(line.removeprefix("RESULT "))


def test_second_process_loads_the_first_ones_compile_artifacts(tmp_path) -> None:
    make_dataset(tmp_path / "data", scenes=(("scene_a", 8),))  # 8 train: 2 steps
    first_run = _run(tmp_path, "first")
    first = first_run["cache"]["train step"]
    assert first["source"] == "compiled" and first["fxgraph_cache_miss"] > 0
    blobs = list((tmp_path / "aot").glob("aot_*.bin"))
    assert len(blobs) == 1 and (tmp_path / "aot").stat().st_mode & 0o777 == 0o700
    second = _run(tmp_path, "second")
    report = second["cache"]["train step"]
    assert report["source"] == "aot-cache", report
    assert report["fxgraph_cache_hit"] > 0 and report["fxgraph_cache_miss"] == 0
    assert list((tmp_path / "aot").glob("aot_*.bin")) == blobs
    print(f"compile: first process {first['seconds']:.1f} s, second {report['seconds']:.1f} s")
    # Both start from the seed's weights on the same data and run the same code.
    np.testing.assert_equal(first_run["epochs"][0]["train_mae"], second["epochs"][0]["train_mae"])
