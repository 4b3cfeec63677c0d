"""The port's trainer CLI held against the JAX trainer on the CPU.

Both trainers run on the same tiny FoundationStereo-layout dataset with the
same flags (CPU, streamed batches, no augmentation, float32, base 4, 32x48)
from the same ``--init-checkpoint`` .pt, so they see the same split, the same
batches in the same order (``epoch_indices``) and the same padded tail.

Their epoch and step metrics agree to rtol 1e-4. The reason for any gap at
all is AdamW's first updates, lr * g / (|g| + eps): where |g| is below ~1e-6
the two frameworks' float noise in g decides the update (ROADMAP Queue 3);
over the 6 steps here the measured gap is ~2e-5 relative.
"""

import json
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_data import make_dataset

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.models.compat import export_torch_state_dict
from stereo_depth_estimation_tpu.parallel.train_step import make_predict_fn as jax_predict_fn
from stereo_depth_estimation_tpu.training.checkpoint import load_model_variables as jax_load
from stereo_depth_estimation_tpu.training.config import parse_args as jax_parse_args
from stereo_depth_estimation_tpu.training.trainer import train as jax_train
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import state_dict_from_jax
from stereo_depth_estimation_tpu_torch.ops.loss import LossStats
from stereo_depth_estimation_tpu_torch.parallel import train_step as P
from stereo_depth_estimation_tpu_torch.parallel.mesh import Mesh
from stereo_depth_estimation_tpu_torch.parallel.train_step import make_predict_fn
from stereo_depth_estimation_tpu_torch.training import checkpoint, trainer
from stereo_depth_estimation_tpu_torch.training.config import parse_args

BASE, HW = 4, (32, 48)
RTOL = 1e-4
# The port's own flags, with their defaults: the network to train (--model)
# and PSMNet's disparity range.
PORT_ONLY = {"model": "stereounet", "max_disparity": 192}


def _flags(root: Path, *extra: str) -> list[str]:
    return [
        "--dataset-root", str(root / "data"), "--height", str(HW[0]), "--width", str(HW[1]),
        "--epochs", "2", "--batch-size", "4", "--val-fraction", "0.25", "--device", "cpu",
        "--compute-dtype", "float32", "--aot-cache", "off", "--base-channels", str(BASE),
        "--preview-samples", "0", "--log-every-batches", "2", "--num-workers", "0", *extra,
    ]


def _metrics(uri: Path, run_id: str) -> dict[str, list[tuple[int, float]]]:
    """The run's metrics from its MLflow FileStore tree: key -> [(step, value)]."""
    out = {}
    for path in uri.glob(f"*/{run_id}/metrics/*"):
        rows = [line.split() for line in path.read_text().splitlines()]
        out[path.name] = [(int(step), float(value)) for _, value, step in rows]
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("trainer")
    make_dataset(root / "data", scenes=(("scene_a", 12),))  # 9 train, 3 val
    model = StereoUNet(base_channels=BASE, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, root / "init.pt")
    return root


@pytest.fixture(scope="module")
def runs(root):
    common = _flags(root, "--device-resident", "off", "--no-augment",
                    "--init-checkpoint", str(root / "init.pt"))
    jax_summary = jax_train(jax_parse_args(
        common + ["--mesh-devices", "1", "--mlflow-tracking-uri", str(root / "jax_runs"),
                  "--output-dir", str(root / "jax_out")]
    ))
    port_summary = trainer.main(
        common + ["--mlflow-tracking-uri", str(root / "port_runs"),
                  "--output-dir", str(root / "port_out")]
    )
    return {
        "jax": (jax_summary, _metrics(root / "jax_runs", jax_summary["run_id"])),
        "port": (port_summary, _metrics(root / "port_runs", port_summary["run_id"])),
    }


def test_epoch_and_step_metrics_match_jax_trainer(runs) -> None:
    (jax_summary, jax_metrics), (port_summary, port_metrics) = runs["jax"], runs["port"]
    assert port_metrics.keys() == jax_metrics.keys()
    assert {"train_loss_step", "train_mae", "val_mae", "val_sigma"} <= port_metrics.keys()
    for key, expected in jax_metrics.items():
        if key == "epoch_seconds":
            continue
        got = port_metrics[key]
        assert [s for s, _ in got] == [s for s, _ in expected], key
        np.testing.assert_allclose([v for _, v in got], [v for _, v in expected],
                                   rtol=RTOL, err_msg=key)
    assert port_summary["global_step"] == jax_summary["global_step"] == 2 * 3
    assert port_summary["device_resident"] == "off"
    assert port_summary["best_epoch"] == jax_summary["best_epoch"]
    np.testing.assert_allclose(port_summary["best_val_mae"], jax_summary["best_val_mae"],
                               rtol=RTOL)


def test_checkpoints_and_params_follow_the_jax_trainer(runs, root) -> None:
    (jax_summary, _), (port_summary, _) = runs["jax"], runs["port"]
    ckpt = Path(port_summary["checkpoints_dir"])
    assert (ckpt / "best.pt").exists()
    last = torch.load(ckpt / "last.pt", weights_only=False)
    assert {"optimizer_state_dict", "generator_state", "train_step"} <= last.keys()
    jax_last = json.loads(
        (Path(jax_summary["checkpoints_dir"]) / "last" / "meta.json").read_text()
    )
    assert checkpoint.load_checkpoint_meta(ckpt / "last.pt")["epoch"] == jax_last["epoch"] == 2
    assert last["config"].keys() == jax_last["config"].keys() | PORT_ONLY.keys()
    assert last["metrics"].keys() == jax_last["metrics"].keys()
    assert last["metrics"]["resume_carry"] == pytest.approx(
        jax_last["metrics"]["resume_carry"], rel=RTOL
    )
    params = {p.name for p in (root / "port_runs").glob(f"*/{port_summary['run_id']}/params/*")}
    jax_params = {p.name for p in (root / "jax_runs").glob(f"*/{jax_summary['run_id']}/params/*")}
    assert params == jax_params


def test_last_pt_loads_in_jax_and_predicts_the_same(runs) -> None:
    port_summary, _ = runs["port"]
    last = Path(port_summary["checkpoints_dir"]) / "last.pt"
    jmodel = JaxUNet(base_channels=BASE)
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, *HW, 6)), train=False,
                           return_uncertainty=True)
    variables, meta = jax_load(last, template)
    assert meta["epoch"] == 2 and not meta["missing_keys"] and not meta["unexpected_keys"]

    inputs = np.random.default_rng(9).integers(0, 256, (3, *HW, 6), dtype=np.uint8)
    jdisp, jlogvar = jax_predict_fn(jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(inputs)
    )
    fresh = StereoUNet(base_channels=BASE, device="cpu")
    loaded = checkpoint.load_model_variables(last, fresh)
    assert loaded["epoch"] == 2 and not loaded["missing_keys"] and not loaded["unexpected_keys"]
    disp, logvar = make_predict_fn(fresh)(torch.from_numpy(inputs))
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), atol=1e-4)
    trained_disp, _ = make_predict_fn(port_summary["state"].model)(torch.from_numpy(inputs))
    assert torch.equal(trained_disp, disp)


def test_resume_continues_global_step_and_lr_schedule(root, tmp_path) -> None:
    """Two epochs in one run, and one epoch plus a resumed second, end in
    the same weights, AdamW state and learning rate: resume restores the
    optimizer's step count (the schedule's position) and the generator, and
    carries the global step."""
    flags = _flags(root, "--lr-schedule", "cosine", "--lr-warmup-steps", "2",
                   "--mlflow-tracking-uri", str(tmp_path / "runs"))
    whole = trainer.main(flags + ["--output-dir", str(tmp_path / "whole")])
    first = trainer.main(flags + ["--output-dir", str(tmp_path / "first"), "--epochs", "1"])
    last = Path(first["checkpoints_dir"]) / "last.pt"
    resumed = trainer.main(flags + ["--output-dir", str(tmp_path / "resumed"), "--resume", str(last)])
    assert first["global_step"] == 3 and resumed["global_step"] == whole["global_step"] == 6
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == 6
    for (key, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), key
    for pa, pb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert all(torch.equal(pa[k], pb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert float(a.optimizer.param_groups[0]["lr"]) == float(b.optimizer.param_groups[0]["lr"])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    with pytest.raises(ValueError, match="mutually exclusive"):
        trainer.main(flags + ["--resume", str(last), "--init-checkpoint", str(root / "init.pt")])


@pytest.mark.parametrize("window_gb", ["4", "1e-4"], ids=["pinned", "rotating"])
def test_device_resident_training_on_the_packed_cache(root, tmp_path, window_gb) -> None:
    summary = trainer.main(_flags(
        root, "--packed-cache-root", str(tmp_path / "packed"), "--device-resident", "on",
        "--hbm-window-gb", window_gb, "--mlflow-tracking-uri", str(tmp_path / "runs"),
        "--output-dir", str(tmp_path / "out"), "--preview-samples", "2",
    ))
    # 9 train samples of 32x48x8 bytes: pinned -> 2 steps of 4; a 1e-4 GB
    # budget holds two 4-sample windows -> 3 windows of 1 step.
    steps = 2 if window_gb == "4" else 3
    assert summary["global_step"] == 2 * steps
    assert summary["device_resident"] == ("pinned" if window_gb == "4" else "rotating")
    for epoch in summary["epochs"]:
        assert all(np.isfinite(epoch[k]) for k in ("train_mae", "val_mae", "val_nll"))
    assert (tmp_path / "packed" / "train" / "meta.json").exists()
    previews = list(Path(summary["checkpoints_dir"]).parent.rglob("mlflow_previews/*/*.png"))
    assert len(previews) == 2 * 2


_JOIN = ["--multihost", "--coordinator-address", "localhost:1234", "--num-processes", "2"]


# --spatial-devices, refused before the height-sharding slice: with two
# ranks (--mesh-devices 2) it makes a 1 x 2 mesh, which trains what one rank
# trains on the same global batches (no augmentation, float32, streamed);
# one rank does not factor into two stripes, which raises ValueError before
# any rank starts (tests/test_torch_spatial.py holds the steps themselves).
@pytest.mark.parametrize("argv", [
    ["--mesh-devices", "2", "--spatial-devices", "2"], ["--spatial-devices", "2"],
], ids=lambda a: a[0].lstrip("-"))
def test_flags_without_a_mechanism_raise(root, tmp_path, argv) -> None:
    flags = _flags(root, "--epochs", "1", "--no-augment",
                   "--mlflow-tracking-uri", str(tmp_path / "runs"))
    if "--mesh-devices" not in argv:
        with pytest.raises(ValueError, match="1 rank\\(s\\) do not factor into spatial=2"):
            trainer.train(parse_args(flags + argv + ["--output-dir", str(tmp_path / "out")]))
        assert not (tmp_path / "out").exists()
        return
    two = trainer.main(flags + argv + ["--output-dir", str(tmp_path / "two")])
    one = trainer.main(flags + ["--mesh-devices", "1", "--output-dir", str(tmp_path / "one")])
    assert "state" not in two and two["global_step"] == one["global_step"] == 3
    for a, b in zip(two["epochs"], one["epochs"]):
        for key in ("train_nll", "train_mae", "val_mae", "val_nll", "val_sigma"):
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL, err_msg=key)


_AUTO = "<output-dir>/.aot_cache"


# The compile flags, refused before the compiled slice: each command line is
# accepted, and reaches torch.compile with its mode and backend ("xla" is
# Inductor) and the compile cache with its directory; or, without
# --compile, neither (the eager step has nothing to compile or cache).
@pytest.mark.parametrize("argv,compiled,cache_dir", [
    (["--multihost", "--aot-cache-multihost", "--compile"], ("default", "inductor"), _AUTO),
    (["--coordinator-address", "localhost:1234", *_JOIN[:1], *_JOIN[3:], "--process-id", "1",
      "--compile"], ("default", "inductor"), None),
    (["--process-id", "1", *_JOIN, "--aot-cache", "some/dir"], None, None),
    (["--compile"], ("default", "inductor"), _AUTO),
    (["--compile", "--compile-mode", "max-autotune"], ("max-autotune", "inductor"), _AUTO),
    (["--compile", "--compile-backend", "aot_eager", "--compile-mode", "reduce-overhead"],
     ("reduce-overhead", "aot_eager"), _AUTO),
    (["--compile", "--aot-cache", "some/dir"], ("default", "inductor"), "some/dir"),
    (["--compile", "--aot-cache-multihost"], ("default", "inductor"), _AUTO),
    (["--compile", "--aot-cache", "off"], ("default", "inductor"), None),
    (["--compile-mode", "max-autotune", "--compile-backend", "inductor"], None, None),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_compile_flags_reach_torch_compile_and_the_cache(
        argv, compiled, cache_dir, monkeypatch, tmp_path) -> None:
    seen = []

    def spy(module, **kwargs):
        seen.append((kwargs["mode"], kwargs["backend"], kwargs["fullgraph"]))
        return module

    monkeypatch.setattr(torch, "compile", spy)
    cfg = parse_args(["--device", "cpu", "--output-dir", str(tmp_path), *argv])
    trainer.check_supported(cfg, torch.device("cpu"))
    model = StereoUNet(base_channels=BASE, device="cpu")
    state = P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4),
                                 compile=trainer.compile_options_from(cfg))
    assert seen == ([] if compiled is None else [(*compiled, True)])
    assert (state.compiled is None) == (compiled is None)
    world = 2 if cfg.multihost else 1
    mesh = Mesh(torch.device("cpu"), world_size=world, rank=world - 1)
    cache = trainer.compile_cache_from(cfg, mesh, verbose=False)
    if cache_dir is None:
        assert cache is None
    else:
        want = tmp_path / ".aot_cache" if cache_dir == _AUTO else Path(cache_dir).resolve()
        assert cache.cache_dir == want and cache.path.parent == want


def test_accepted_jax_flags_and_augment_impl_names() -> None:
    for argv in (["--aot-cache", "off"], ["--aot-cache", "auto"], ["--mesh-devices", "1"], []):
        trainer.check_supported(parse_args(argv), torch.device("cpu"))
    impl = {name: trainer.augment_config_from(parse_args(["--augment-impl", name])).impl
            for name in ("auto", "pallas", "xla")}
    assert impl == {"auto": "auto", "pallas": "kernel", "xla": "plain"}
    assert trainer.augment_config_from(parse_args(["--no-augment"])) is None


def _jax_fields(cfg) -> dict:
    port = asdict(cfg)
    assert {k: port.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return port


def test_parse_args_matches_jax_config() -> None:
    assert _jax_fields(parse_args([])) == asdict(jax_parse_args([]))
    argv = ["--epochs", "3", "--lr-schedule", "cosine", "--no-augment", "--augment-impl", "xla",
            "--packed-cache-root", "p", "--device-resident", "on", "--hbm-window-gb", "2.5",
            "--resume", "r.pt", "--compute-dtype", "float32", "--input-precision", "float32"]
    assert _jax_fields(parse_args(argv)) == asdict(jax_parse_args(argv))


def test_device_auto_is_the_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    for device in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.train(parse_args(["--device", device]))
    with pytest.raises(ValueError, match="--device"):
        trainer.train(parse_args(["--device", "tpu"]))


def test_non_finite_loss_raises_at_the_log_cadence() -> None:
    def nan_step(state, batch):
        return state, LossStats(*(torch.tensor(v) for v in (float("nan"), 1.0, 1.0, 1.0, 10.0)))

    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.run_train_epoch(nan_step, object(), iter([{}, {}]), run=None,
                                global_step=0, log_every_batches=2)


def test_init_checkpoint_takes_a_jax_export(tmp_path) -> None:
    """A .pt as the JAX package's training/export.py writes it (torch-layout
    tensors, no BatchNorm step counters) initialises the port's model."""
    jmodel = JaxUNet(base_channels=BASE)
    variables = jmodel.init(jax.random.key(4), jnp.zeros((1, *HW, 6)), train=False,
                            return_uncertainty=True)
    exported = {k: torch.from_numpy(v.copy())
                for k, v in export_torch_state_dict(variables).items()}
    torch.save({"epoch": 5, "model_state_dict": exported, "config": {}, "metrics": {}},
               tmp_path / "export.pt")
    model = StereoUNet(base_channels=BASE, device="cpu")
    meta = checkpoint.load_model_variables(tmp_path / "export.pt", model)
    assert meta["epoch"] == 5 and not meta["missing_keys"] and not meta["unexpected_keys"]
    ours = model.state_dict()
    for key, value in state_dict_from_jax(variables).items():
        assert torch.equal(ours[key], value), key
