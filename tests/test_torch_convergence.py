"""The port's scripts held against the JAX package's on the CPU: the
synthetic stereo generator (byte for byte), the rescale CLI (against JAX's
``rescale_resolution_transfer``), and the convergence harness's ``card``
mode at a tiny size (its artifact, its resume, its refusals)."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.models.compat import (
    rescale_resolution_transfer as jax_rescale,
)
from stereo_depth_estimation_tpu_torch.models.compat import state_dict_from_jax
from stereo_depth_estimation_tpu_torch.scripts import (
    convergence_run,
    make_synth_dataset,
    rescale_transfer,
)

ROOT = Path(__file__).resolve().parent.parent


def _jax_script(name: str):
    """``scripts/<name>.py``, the JAX package's script, as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SYNTH = _jax_script("make_synth_dataset")
GEN_ARGS = dict(n_samples=6, n_scenes=2, hw=(48, 64), max_disparity=9.6)


def _tree(root: Path) -> dict[str, bytes]:
    """Every file under ``root`` but the meta, by relative path."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.name != "synth_meta.json"}


def _meta(root: Path) -> dict:
    meta = json.loads((root / "synth_meta.json").read_text())
    meta.pop("elapsed_seconds")
    return meta


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_is_byte_identical_to_the_jax_script(tmp_path, seed) -> None:
    JAX_SYNTH.generate(tmp_path / "jax", seed=seed, **GEN_ARGS)
    meta = make_synth_dataset.generate(tmp_path / "port", seed=seed, **GEN_ARGS)
    want = _tree(tmp_path / "jax")
    assert len(want) == 3 * 6
    assert _tree(tmp_path / "port") == want
    assert _meta(tmp_path / "port") == _meta(tmp_path / "jax")
    assert meta["samples"] == 6


def test_a_partial_tree_resumes_to_the_same_bytes(tmp_path) -> None:
    JAX_SYNTH.generate(tmp_path / "jax", seed=1, **GEN_ARGS)
    port = tmp_path / "port"
    make_synth_dataset.generate(port, seed=1, **GEN_ARGS)
    scene0 = port / "scene_000" / "dataset" / "data"
    # A frame cut short (its right view never written) and a frame lost
    # whole; a complete frame must be kept as it is, not rendered again.
    (scene0 / "right" / "rgb" / "000001.png").unlink()
    for sub in make_synth_dataset.SUBDIRS:
        (port / "scene_001" / "dataset" / "data" / sub / "000002.png").unlink()
    kept = scene0 / "left" / "rgb" / "000000.png"
    kept.write_bytes(b"complete frames are skipped")
    make_synth_dataset.main(["--out", str(port), "--samples", "6", "--scenes", "2",
                             "--height", "48", "--width", "64",
                             "--max-disparity", "9.6", "--seed", "1"])
    got = _tree(port)
    assert got.pop("scene_000/dataset/data/left/rgb/000000.png") == b"complete frames are skipped"
    want = _tree(tmp_path / "jax")
    want.pop("scene_000/dataset/data/left/rgb/000000.png")
    assert got == want
    assert _meta(port) == _meta(tmp_path / "jax")


@pytest.mark.parametrize("seed,hw,n_sprites", [
    (0, (48, 64), 4), (7, (240, 320), 10), (11, (31, 45), 1), (5, (64, 32), 0),
])
def test_render_stereo_frame_matches_jax(seed, hw, n_sprites) -> None:
    want = JAX_SYNTH.render_stereo_frame(np.random.default_rng(seed), hw, 48.0, n_sprites)
    got = make_synth_dataset.render_stereo_frame(
        np.random.default_rng(seed), hw, 48.0, n_sprites)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- rescale CLI ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_variables():
    """JAX init variables whose parameters are redrawn from a seed (the init
    has zero biases, which a rescale leaves as they are)."""
    variables = JaxUNet(base_channels=4).init(
        jax.random.key(3), jnp.zeros((1, 32, 48, 6)), train=False, return_uncertainty=True)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), variables["params"])
    return {"params": params, "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}


@pytest.mark.parametrize("given", ["file", "checkpoints dir"])
def test_rescale_cli_matches_jax_rescale(tmp_path, jax_variables, given) -> None:
    source = state_dict_from_jax(jax_variables)
    ckpt_dir = tmp_path / "outputs" / "run1" / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    torch.save({"model_state_dict": source, "epoch": 7}, ckpt_dir / "best.pt")
    arg = ckpt_dir / "best.pt" if given == "file" else ckpt_dir
    target = rescale_transfer.main([
        "--checkpoint", str(arg), "--from-width", "128", "--to-width", "320",
        "--out", str(tmp_path / "rescaled"), "--base-channels", "4"])
    assert target == tmp_path / "rescaled" / "rescaled.pt"

    saved = torch.load(target, weights_only=False)
    assert saved["epoch"] == 7
    assert saved["config"] == {"rescale_width_ratio": 2.5, "source_checkpoint": str(arg)}
    got = saved["model_state_dict"]
    want = state_dict_from_jax({
        "params": jax_rescale(jax_variables["params"], 320 / 128),
        "batch_stats": jax_variables["batch_stats"],
    })
    heads = {"disparity_head.weight", "disparity_head.bias", "logvar_head.bias"}
    assert want.keys() <= got.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
        if key not in heads:
            assert torch.equal(got[key], source[key]), key  # bitwise untouched
    for key in heads:
        assert not torch.equal(got[key], source[key]), key


# --- convergence harness, card mode -----------------------------------------

def _card(work: Path, docs: Path, *extra: str) -> dict:
    return convergence_run.main([
        "card", "--device", "cpu", "--height", "48", "--width", "64", "--batch-size", "4",
        "--samples", "24", "--workdir", str(work), "--docs-dir", str(docs), *extra])


@pytest.fixture(scope="module")
def card_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("card")
    result = _card(root / "work", root / "docs", "--epochs", "2")
    return root, result


def test_card_artifact_has_the_jax_artifacts_keys(card_run) -> None:
    root, result = card_run
    artifact = json.loads((root / "docs" / "card_metrics.json").read_text())
    jax_artifact = json.loads((ROOT / "docs" / "convergence" / "tpu_metrics_long.json")
                              .read_text())
    assert jax_artifact.keys() < artifact.keys()
    assert {"device", "pairs_per_second"} <= artifact.keys()
    assert jax_artifact["config"].keys() <= artifact["config"].keys()
    assert artifact["series"].keys() == jax_artifact["series"].keys()
    assert artifact["device"] == {"name": "cpu", "power_limit": None, "count": 1}
    assert artifact["config"]["seed"] == 42
    assert artifact["config"]["initialiser"] == convergence_run.INITIALISER
    assert artifact["config"]["init_checkpoint"] is None
    assert artifact["series"]["epoch"] == [1, 2]
    assert all(np.isfinite(v) for key in convergence_run.METRIC_KEYS
               for v in artifact["series"][key])
    assert artifact["best_val_mae"] == min(artifact["series"]["val_mae"])
    assert result["summary"]["global_step"] == 2 * (22 // 4)  # 24 samples: 22 train
    assert artifact["pairs_per_second"] > 0
    for name in ("card_preview_first_epoch.png", "card_preview_last_epoch.png"):
        assert (root / "docs" / name).stat().st_size > 0


def test_card_series_equals_the_tracked_epoch_records(card_run) -> None:
    root, _ = card_run
    series = json.loads((root / "docs" / "card_metrics.json").read_text())["series"]
    (metrics,) = (root / "work" / "tracking").rglob("metrics.jsonl")
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    epochs = [r for r in records if "epoch_seconds" in r]
    assert series["epoch"] == [r["step"] for r in epochs]
    for key in convergence_run.METRIC_KEYS:
        assert series[key] == [round(r[key], 5) for r in epochs], key


def test_card_resume_merges_the_epochs_and_keeps_the_first_preview(tmp_path, card_run) -> None:
    root, _ = card_run
    work, docs = tmp_path / "work", tmp_path / "docs"
    first = _card(work, docs, "--epochs", "1")
    first_preview = (docs / "card_preview_first_epoch.png").read_bytes()
    last_pt = Path(first["summary"]["checkpoints_dir"]) / "last.pt"
    resumed = _card(work, docs, "--epochs", "2", "--resume-from", str(last_pt))
    assert resumed["series"]["epoch"] == [1, 2]
    assert resumed["series"]["val_mae"][0] == first["series"]["val_mae"][0]
    assert resumed["config"]["resumed_from"] == str(last_pt)
    assert [e["epoch"] for e in resumed["summary"]["epochs"]] == [2]
    assert (docs / "card_preview_first_epoch.png").read_bytes() == first_preview
    # The resumed run trains as the uninterrupted one did: the train state
    # (weights, AdamW, the random stream) carries over whole.
    whole = json.loads((root / "docs" / "card_metrics.json").read_text())["series"]
    assert resumed["series"] == whole


@pytest.mark.parametrize("extra,seed", [((), 42), (("--seed", "43"), 43)])
def test_card_seed_reaches_the_trainer(tmp_path, monkeypatch, extra, seed) -> None:
    seen = []

    def fake_train(cfg):
        seen.append(cfg)
        raise StopIteration  # the run itself is the card_run fixture's

    monkeypatch.setattr(convergence_run, "train", fake_train)
    with pytest.raises(StopIteration):
        _card(tmp_path / "work", tmp_path / "docs", "--epochs", "1", *extra)
    assert [cfg.seed for cfg in seen] == [seed]


def test_card_refuses_the_jax_packages_docs(tmp_path) -> None:
    for docs in (ROOT / "docs" / "convergence", ROOT / "docs" / "convergence" / "sub"):
        with pytest.raises(ValueError, match="JAX package"):
            _card(tmp_path / "work", docs, "--epochs", "1")
    assert not (tmp_path / "work").exists()  # refused before any work


def test_card_without_device_flag_needs_cuda(tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convergence_run.main(["card", "--samples", "24", "--epochs", "1",
                              "--workdir", str(tmp_path / "work"),
                              "--docs-dir", str(tmp_path / "docs")])
    assert not (tmp_path / "work").exists()
