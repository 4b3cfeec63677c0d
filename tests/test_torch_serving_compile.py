"""The port's compiled serving forwards (``--compile``) and their compile
cache, held against the eager port and the JAX CLIs on the CPU.

Evaluate, predict and the live viewer run with ``--compile
--compile-backend aot_eager`` (the graph Inductor would take, run by
PyTorch's own kernels) and ``--aot-cache <dir>``: each pass is one graph
with no recompile, a ragged tail batch and a hot reload included, and its
output equals the eager run's (aot_eager runs the same aten ops in the same
order: equal in practice, held to 1e-6) and the JAX CLI's at the serving
tests' tolerances (tests/test_torch_serving.py: metrics within 1e-4
relative, npz files within a float16 ulp plus 1e-4; tests/test_torch_live.py:
readouts within 1e-5 relative). One case runs Inductor in two processes,
each with an empty Inductor cache of its own: the second loads the predict
graph from the first one's blob.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_live import BASE as LIVE_BASE
from test_torch_live import MODEL_WH, _calibration, _live_argv, _write_frames
from test_torch_serving import (
    BASE,
    HW,
    METRIC_RTOL,
    _assert_npz_close,
    _common,
    jax_variables,
    write_checkpoint,
    write_dataset,
)
from torch._dynamo.utils import counters

from stereo_depth_estimation_tpu.eval import evaluate as jax_evaluate
from stereo_depth_estimation_tpu.eval import predict as jax_predict
from stereo_depth_estimation_tpu.live import depth_live_dl as jax_live
from stereo_depth_estimation_tpu_torch.eval import evaluate, predict
from stereo_depth_estimation_tpu_torch.live import depth_live_dl
from stereo_depth_estimation_tpu_torch.ops import remap
from stereo_depth_estimation_tpu_torch.parallel import CompileOptions

REPO = Path(__file__).resolve().parent.parent
COMPILED_TOL = 1e-6  # aot_eager against eager: the same aten ops in the same order
COMPILE = ("--compile", "--compile-backend", "aot_eager")
METRICS = ("mae", "rmse", "nll", "sigma", "loss")


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("serving_compile")
    write_dataset(root / "data")  # 8 samples at 40x56
    write_checkpoint(root / "model.pt", jax_variables(BASE, HW, seed=1), epoch=3)
    rng = np.random.default_rng(2)
    for side in ("left", "right"):
        (root / side).mkdir()
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)).save(
                root / side / f"frame_{i:03d}.png")
    return root


def graphs() -> int:
    """Dynamo's count of the graphs this process compiled; a recompile of
    a graph counts too."""
    return int(counters["stats"]["unique_graphs"])


def fresh_graphs() -> int:
    """``graphs()`` after forgetting every compiled graph, so that what
    follows compiles its own (Dynamo would otherwise reuse an earlier
    test's graph of the same code where its guards hold)."""
    torch._dynamo.reset()
    return graphs()


def _evaluate_argv(root: Path, *extra: str) -> list[str]:
    # 8 samples at batch 3: two full batches and a ragged tail of 2.
    return _common(root, "--dataset-root", str(root / "data"), "--split", "all",
                   "--batch-size", "3", "--num-workers", "0", *extra)


def test_compiled_evaluate_is_one_graph_equal_to_eager_and_jax(root, tmp_path) -> None:
    want = jax_evaluate.evaluate(jax_evaluate.build_parser().parse_args(
        _evaluate_argv(root, "--aot-cache", "off", "--mesh-devices", "1")))
    eager = evaluate.main(_evaluate_argv(root, "--device", "cpu"))
    before = fresh_graphs()
    got = evaluate.main(_evaluate_argv(root, "--device", "cpu", *COMPILE,
                                       "--aot-cache", str(tmp_path / "aot")))
    assert graphs() - before == 1  # the ragged tail is padded: no second shape
    assert got.pop("compile_cache")["eval step"]["source"] in ("compiled", "compiled-unsaved")
    assert got.keys() == eager.keys() == want.keys()
    assert got["samples"] == 8 and got["valid_pixels"] == want["valid_pixels"] > 0
    for key in METRICS:
        np.testing.assert_allclose(got[key], eager[key], rtol=COMPILED_TOL, err_msg=key)
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)


def test_evaluate_pads_its_tail_batch(root, monkeypatch) -> None:
    """Every batch reaches the eval step at the batch size, the tail's
    padding rows flagged invalid."""
    seen = []
    real = evaluate.make_eval_step

    def spy(mesh=None):
        step = real(mesh)

        def call(state, batch):
            seen.append((len(batch["input"]), int(batch["valid_mask"].sum())))
            return step(state, batch)

        return call

    monkeypatch.setattr(evaluate, "make_eval_step", spy)
    evaluate.main(_evaluate_argv(root, "--device", "cpu"))
    assert seen == [(3, 3), (3, 3), (3, 2)]


def test_compiled_predict_is_one_graph_equal_to_eager_and_jax(root, tmp_path) -> None:
    pairs = ["--left-dir", str(root / "left"), "--right-dir", str(root / "right"),
             "--batch-size", "2"]  # 5 pairs: a padded tail of 1
    jax_predict.predict(jax_predict.build_parser().parse_args(_common(
        root, *pairs, "--predictions-dir", str(tmp_path / "jax"), "--aot-cache", "off")))
    predict.main(_common(root, *pairs, "--predictions-dir", str(tmp_path / "eager"),
                         "--device", "cpu"))
    before = fresh_graphs()
    got = predict.main(_common(root, *pairs, "--predictions-dir", str(tmp_path / "compiled"),
                               "--device", "cpu", *COMPILE))
    assert graphs() - before == 1
    assert got["pairs"] == 5
    assert got["compile_cache"]["predict"]["source"] in ("compiled", "compiled-unsaved")
    # --aot-cache auto: the cache sits under the predictions directory
    # (aot_eager generates no code, so there is no blob to save).
    assert (tmp_path / "compiled" / ".aot_cache").is_dir()
    names = sorted(p.name for p in (tmp_path / "compiled").glob("*.npz"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.npz")) and len(names) == 5
    for name in names:
        _assert_npz_close(tmp_path / "compiled" / name, tmp_path / "jax" / name)
        a, b = np.load(tmp_path / "compiled" / name), np.load(tmp_path / "eager" / name)
        for key in a.files:  # float16 files of float32 outputs within 1e-6
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")


@pytest.fixture(scope="module")
def live_ckpt(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("live_compile")
    write_checkpoint(root / "model.pt",
                     jax_variables(LIVE_BASE, (MODEL_WH[1], MODEL_WH[0]), seed=7), epoch=5)
    return root / "model.pt"


def test_compiled_live_cli_readouts_equal_jax(live_ckpt, tmp_path) -> None:
    _write_frames(tmp_path / "frames", 3)
    calib = tmp_path / "stereo_calib.npz"
    np.savez_compressed(calib, **_calibration())
    extra = ["--calibration", str(calib), "--ema-alpha", "0.5"]
    jax_live.main(_live_argv(live_ckpt, tmp_path / "frames", tmp_path / "jax", *extra,
                             "--aot-cache", "off"))
    before = fresh_graphs()
    depth_live_dl.main(_live_argv(live_ckpt, tmp_path / "frames", tmp_path / "port", *extra,
                                  "--device", "cpu", *COMPILE,
                                  "--aot-cache", str(tmp_path / "aot")))
    assert graphs() - before == 1
    assert (tmp_path / "aot").is_dir()
    for i in range(2):
        got = json.loads((tmp_path / "port" / f"readout_{i:05d}.json").read_text())
        want = json.loads((tmp_path / "jax" / f"readout_{i:05d}.json").read_text())
        got.pop("fps"), want.pop("fps")
        assert got.keys() == want.keys() and got["center_depth_m"] is not None
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-5), key


@pytest.mark.parametrize("rectify", [True, False], ids=["rectified", "raw"])
def test_compiled_engine_equals_eager_across_a_hot_reload(live_ckpt, tmp_path, rectify) -> None:
    """The compiled engine (one program: scale, rectify, resize, forward,
    views) against the eager engine on the same frames; then the checkpoint
    is replaced and reloaded through the watcher: no recompile, and its
    output equals a fresh eager engine loaded with the new weights."""
    calib = _calibration() if rectify else None

    def engine(**kwargs):
        return depth_live_dl.LiveDepthEngine(
            MODEL_WH, remap.Rectifier.from_calibration(calib, "cpu") if rectify else None,
            device="cpu", base_channels=LIVE_BASE, **kwargs)

    local = tmp_path / "last.pt"
    local.write_bytes(live_ckpt.read_bytes())
    eager, compiled = engine(), engine(compile=CompileOptions(backend="aot_eager"),
                                       compile_cache=tmp_path / "aot")
    eager.load_checkpoint(local)
    compiled.load_checkpoint(local)
    frames = _write_frames(tmp_path / "frames", 3)
    before = fresh_graphs()
    for frame in frames[:2]:
        _assert_frames_equal(compiled.process(*frame), eager.process(*frame))
    assert compiled.compile_cache.reports["live frame"]["source"] in (
        "compiled", "compiled-unsaved")

    watcher = depth_live_dl.CheckpointWatcher(compiled, local, poll_sec=0.0)
    write_checkpoint(local, jax_variables(LIVE_BASE, (MODEL_WH[1], MODEL_WH[0]), seed=9), 6)
    now = time.time_ns() + 10**9
    os.utime(local, ns=(now, now))
    watcher.maybe_reload()
    assert compiled.loaded_epoch == 6
    fresh = engine()
    fresh.load_checkpoint(local)
    reloaded = compiled.process(*frames[2])
    _assert_frames_equal(reloaded, fresh.process(*frames[2]))
    assert not np.allclose(reloaded[0], eager.process(*frames[2])[0])
    assert graphs() - before == 1  # the reload recompiled nothing


def _assert_frames_equal(got, want) -> None:
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=COMPILED_TOL)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


def test_compiled_evaluate_on_a_spatial_mesh_equals_eager(root) -> None:
    """Two ranks as a 1 x 2 (data x spatial) mesh, each compiling its stripe's
    eval graph with the halo exchanges in it, score what the eager mesh
    scores."""
    argv = _evaluate_argv(root, "--device", "cpu", "--mesh-devices", "2",
                          "--spatial-devices", "2")
    eager = evaluate.main(argv)
    got = evaluate.main(argv + [*COMPILE, "--aot-cache", "off"])
    assert got.keys() == eager.keys()
    for key in ("samples", "valid_pixels"):
        assert got[key] == eager[key]
    for key in METRICS:
        np.testing.assert_allclose(got[key], eager[key], rtol=COMPILED_TOL, err_msg=key)


_CHILD = textwrap.dedent("""
    import json, sys
    root, repo = sys.argv[1], sys.argv[2]
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(2)
    from stereo_depth_estimation_tpu_torch.eval import predict
    result = predict.main([
        "--left-dir", f"{root}/left", "--right-dir", f"{root}/right",
        "--checkpoint", f"{root}/model.pt", "--height", "32", "--width", "48",
        "--base-channels", "4", "--batch-size", "2", "--device", "cpu",
        "--predictions-dir", f"{root}/out", "--compile", "--aot-cache", f"{root}/aot",
    ])
    print("RESULT " + json.dumps(result["compile_cache"]), flush=True)
""")


def _predict_process(root: Path, name: str) -> dict:
    env = {**os.environ, "TORCHINDUCTOR_CACHE_DIR": str(root / f"inductor_{name}")}
    done = subprocess.run([sys.executable, "-c", _CHILD, str(root), str(REPO)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    line = next(s for s in done.stdout.splitlines() if s.startswith("RESULT "))
    return json.loads(line.removeprefix("RESULT "))["predict"]


def test_second_predict_process_loads_the_graph_from_the_blob(root, tmp_path) -> None:
    """Inductor (C++ kernels built with g++) in two processes, each with an
    empty Inductor cache of its own: the first compiles and saves the blob,
    the second loads every graph from it."""
    for name in ("left", "right", "model.pt"):
        os.symlink(root / name, tmp_path / name)
    first = _predict_process(tmp_path, "first")
    assert first["source"] == "compiled" and first["fxgraph_cache_miss"] > 0
    second = _predict_process(tmp_path, "second")
    assert second["source"] == "aot-cache", second
    assert second["fxgraph_cache_hit"] > 0 and second["fxgraph_cache_miss"] == 0
    print(f"predict compile: first process {first['seconds']:.1f} s, "
          f"second {second['seconds']:.1f} s")
