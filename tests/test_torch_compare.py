"""The convergence harness's ``compare`` mode on the CPU: the port's trainer
against the JAX package's, run as a child process, from one ``init.pt`` on
the same generated scenes, batches and batch order (base 4, 32x48, 16
samples, 2 epochs of 3 steps).

Epoch 1's val MAE agrees to rtol 1e-4, the tolerance of
``tests/test_torch_trainer.py``; the first step, taken from the same weights
on the same batch, to 1e-5. Later steps part by AdamW's first updates where
a gradient is within float noise of 0 (ROADMAP Queue 3).
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import rescale_resolution_transfer
from stereo_depth_estimation_tpu_torch.scripts import convergence_run

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--base-channels", "4", "--height", "32", "--width", "48", "--samples", "16",
         "--batch-size", "4"]


def _compare(root: Path, *extra: str) -> dict:
    return convergence_run.main(["compare", *SMALL, "--workdir", str(root / "work"),
                                 "--docs-dir", str(root / "docs"), *extra])


@pytest.fixture(scope="module")
def compared(tmp_path_factory):
    root = tmp_path_factory.mktemp("compare")
    result = _compare(root, "--device", "cpu", "--epochs", "2")
    artifact = json.loads((root / "docs" / "compare_jax.json").read_text())
    return root, result, artifact


def test_compare_artifact_has_the_jax_compare_keys(compared) -> None:
    _, result, artifact = compared
    jax_artifact = json.loads((ROOT / "docs" / "convergence" / "compare.json").read_text())
    assert result == artifact
    assert jax_artifact.keys() < artifact.keys()
    assert {"init", "split", "device", "seconds", "steps"} <= artifact.keys()
    assert jax_artifact["protocol"].keys() <= artifact["protocol"].keys()
    for side in ("reference", "this_framework"):
        assert artifact[side].keys() == jax_artifact[side].keys()
        assert artifact[side]["epoch"] == [1, 2]
        assert all(np.isfinite(v) for key in convergence_run.METRIC_KEYS
                   for v in artifact[side][key])
    assert artifact["device"] == {"reference": "cpu", "this_framework": {
        "name": "cpu", "power_limit": None, "count": 1}}
    assert "--no-augment" in artifact["protocol"]["flags"]
    assert not any(str(ROOT) in flag for flag in artifact["protocol"]["flags"])


def test_compare_both_trainers_start_from_one_init_on_one_split(compared) -> None:
    root, _, artifact = compared
    sha = hashlib.sha256((root / "work" / "init.pt").read_bytes()).hexdigest()
    assert artifact["init"] == {"sha256": sha, "rescaled_from_width": None,
                                "reference": sha, "this_framework": sha}
    assert artifact["split"] == {"reference": [12, 4], "this_framework": [12, 4]}


def test_compare_epoch_one_and_the_first_step_agree(compared) -> None:
    _, _, artifact = compared
    ref, ours = artifact["reference"], artifact["this_framework"]
    np.testing.assert_allclose(ours["val_mae"][0], ref["val_mae"][0], rtol=1e-4)
    steps = artifact["steps"]
    assert steps["step"] == list(range(1, 7))
    np.testing.assert_allclose(steps["this_framework_train_loss"][0],
                               steps["reference_train_loss"][0], rtol=1e-5)


def test_compare_series_and_deltas_follow_the_tracked_records(compared) -> None:
    root, _, artifact = compared
    for side, name in (("jax", "reference"), ("port", "this_framework")):
        (metrics,) = (root / "work" / f"{side}_tracking").rglob("metrics.jsonl")
        records = [json.loads(line) for line in metrics.read_text().splitlines()]
        epochs = [r for r in records if "epoch_seconds" in r]
        for key in convergence_run.METRIC_KEYS:
            assert artifact[name][key] == [round(r[key], 5) for r in epochs], (side, key)
        assert artifact["steps"][f"{name}_train_loss"] == [
            r["train_loss_step"] for r in records if "epoch_seconds" not in r]
    ref, ours = artifact["reference"], artifact["this_framework"]
    for key in convergence_run.METRIC_KEYS:
        assert artifact["delta_ours_minus_ref"][key] == [
            round(a - b, 5) for a, b in zip(ours[key], ref[key])]
    np.testing.assert_allclose(artifact["relative_abs_delta"]["val_mae"], [
        abs(a - b) / b for a, b in zip(ours["val_mae"], ref["val_mae"])], atol=1e-7)
    steps = artifact["steps"]
    apart = [s for s, r in zip(steps["step"], steps["relative_abs_delta"]) if r > 1e-4]
    assert steps["first_step_apart_over_1e-4"] == (apart[0] if apart else None)


def test_compare_raises_with_the_output_of_a_failing_jax_child(tmp_path, monkeypatch) -> None:
    """A JAX trainer that cannot import JAX (as on a host without it) fails
    the run; the error carries its output and the port's side never runs."""
    blocked = tmp_path / "no_jax"
    (blocked / "jax").mkdir(parents=True)
    (blocked / "jax" / "__init__.py").write_text(
        'raise ImportError("no JAX on this host")\n')
    monkeypatch.setenv("PYTHONPATH", str(blocked))
    with pytest.raises(RuntimeError, match="(?s)JAX child jax_trainer exited with 1.*no JAX on this host"):
        _compare(tmp_path, "--device", "cpu", "--epochs", "1")
    assert "no JAX on this host" in (tmp_path / "work" / "jax_trainer.log").read_text()
    assert not (tmp_path / "work" / "port_tracking").exists()
    assert not (tmp_path / "docs").exists()


def test_compare_device_defaults_to_cuda(tmp_path) -> None:
    args = convergence_run.build_parser().parse_args(["compare"])
    assert args.device == "cuda"
    assert (args.epochs, args.samples, args.height, args.width, args.batch_size,
            args.seed, args.base_channels) == (5, 128, 96, 128, 16, 42, 32)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is about hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _compare(tmp_path, "--epochs", "1")
    assert not (tmp_path / "work").exists()  # refused before any work


def test_compare_refuses_the_jax_packages_docs(tmp_path) -> None:
    with pytest.raises(ValueError, match="JAX package"):
        convergence_run.main(["compare", "--device", "cpu", "--workdir", str(tmp_path / "w"),
                              "--docs-dir", str(ROOT / "docs" / "convergence")])
    assert not (tmp_path / "w").exists()



def test_compare_rescaled_start_gives_each_trainer_its_packages_rescale(
        tmp_path, monkeypatch) -> None:
    """``--init-checkpoint`` with ``--rescale-from-width``: the JAX package's
    rescale CLI (a child process, recorded here; its agreement with the
    port's CLI is ``tests/test_torch_transfer.py``'s) and the port's rescale
    one copy of the checkpoint, and each trainer starts from its own side's."""
    source = tmp_path / "best.pt"
    model = StereoUNet(base_channels=4, device="cpu", generator=torch.Generator().manual_seed(5))
    torch.save({"model_state_dict": model.state_dict(), "epoch": 7}, source)
    children = []

    def jax_child(work, argv, name):
        children.append((argv, name))
        if name == "jax_trainer":
            raise StopIteration  # the trainers' own runs are the compared fixture's

    monkeypatch.setattr(convergence_run, "_run_jax_child", jax_child)
    with pytest.raises(StopIteration):
        _compare(tmp_path, "--device", "cpu", "--epochs", "1", "--init-checkpoint", str(source),
                 "--rescale-from-width", "16")
    work = tmp_path / "work"
    assert (work / "init.pt").read_bytes() == source.read_bytes()
    (rescale, name), (trainer, _) = children
    assert name == "jax_rescale" and rescale[0] == str(ROOT / "scripts" / "rescale_transfer.py")
    assert rescale[1:] == ["--checkpoint", str(work / "init.pt"), "--from-width", "16",
                           "--to-width", "48", "--base-channels", "4",
                           "--out", str(work / "jax_rescaled")]
    assert trainer[trainer.index("--init-checkpoint") + 1] == str(
        work / "jax_rescaled" / "rescaled")

    port = torch.load(work / "port_rescaled" / "rescaled.pt", weights_only=False)
    want = rescale_resolution_transfer(model.state_dict(), 3.0)
    assert port["config"]["rescale_width_ratio"] == 3.0
    for key, value in want.items():
        assert torch.equal(port["model_state_dict"][key], value), key

def test_compare_rescale_needs_an_init_checkpoint(tmp_path) -> None:
    with pytest.raises(ValueError, match="--init-checkpoint"):
        _compare(tmp_path, "--device", "cpu", "--rescale-from-width", "16")
    assert not (tmp_path / "work").exists()
