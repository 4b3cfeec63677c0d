"""The progressive-resolution transfer (``docs/CONVERGENCE.md`` section 4)
through the port's CLIs, held against the JAX package's on the CPU.

The port's trainer pretrains at 16x16 for one epoch. Its ``best.pt`` is
rescaled for 48-wide inputs on both sides: the port's CLI writes
``rescaled.pt``, the JAX CLI (``scripts/rescale_transfer.py``) an Orbax
``rescaled`` directory, which the JAX trainer's ``--init-checkpoint`` reads
as the JAX package's section 4 run did. Both trainers then finetune for two
epochs at 32x48 from their side's checkpoint: rescaled, rescaled under the
cosine schedule (each trainer plans the horizon from the run's own steps),
and naive (``best.pt`` as it is, on both sides). The setting is
``tests/test_torch_trainer.py``'s (base 4, float32, no augmentation,
streamed batches), so the two finetunes see the same batches in the same
order, and their epoch and step metrics agree to its rtol. The pretrain is
16 high and 16 wide because the model's four pools need sides divisible by
16; the ratio is 3 where the card's run has 2.5. Last, the convergence
harness runs the same sequence in one workdir at two sizes, as the card's
runs do.

The pretrain starts from PyTorch's default init drawn from seed 3 (the
reference trainer's init, passed as a ``.pt`` to ``--init-checkpoint`` as
``docs/CONVERGENCE.md`` section 1 does), the start this tolerance was
measured at. From the JAX package's init, which a fresh port model draws,
the rescaled finetune at this size is chaotic at rtol 1e-4: the port
against itself, from weights moved by 1e-7 of their size, is 3.4e-5 apart
in the step loss after three steps, the AdamW first-step noise of
``tests/test_torch_trainer.py`` grown through the 2x3 bottleneck.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from test_torch_data import make_dataset
from test_torch_trainer import BASE, HW, RTOL, _flags, _metrics

from stereo_depth_estimation_tpu.training.config import parse_args as jax_parse_args
from stereo_depth_estimation_tpu.training.trainer import train as jax_train
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import rescale_resolution_transfer
from stereo_depth_estimation_tpu_torch.scripts import convergence_run, rescale_transfer
from stereo_depth_estimation_tpu_torch.training import checkpoint, trainer

ROOT = Path(__file__).resolve().parent.parent
PRETRAIN_HW = (16, 16)


def _jax_rescale_cli(argv: list[str], monkeypatch) -> None:
    """``scripts/rescale_transfer.py`` (the JAX package's CLI) with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        "jax_script_rescale_transfer", ROOT / "scripts" / "rescale_transfer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["rescale_transfer.py", *argv])
    module.main()


@torch.no_grad()
def pytorch_default_init(model: StereoUNet, generator: torch.Generator) -> StereoUNet:
    """``model`` with every conv and transposed-conv weight and bias drawn as
    PyTorch's own layers draw them, U(+-1/sqrt(fan_in)) with fan_in =
    ``weight.shape[1] * kh * kw``, from ``generator``."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            for p in (module.weight, module.bias):
                if p is not None:
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory) -> dict[str, Path]:
    """The port's 16x16 pretrain and both sides' rescaled checkpoints."""
    root = tmp_path_factory.mktemp("transfer")
    make_dataset(root / "data", scenes=(("scene_a", 12),))  # 9 train, 3 val
    model = pytorch_default_init(StereoUNet(base_channels=BASE, device="cpu"),
                                 torch.Generator().manual_seed(3))
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, root / "init.pt")
    summary = trainer.main(_flags(
        root, "--height", str(PRETRAIN_HW[0]), "--width", str(PRETRAIN_HW[1]),
        "--epochs", "1", "--device-resident", "off", "--no-augment",
        "--init-checkpoint", str(root / "init.pt"),
        "--mlflow-tracking-uri", str(root / "pretrain_runs"),
        "--output-dir", str(root / "pretrain_out")))
    best = Path(summary["checkpoints_dir"]) / "best.pt"
    rescale = ["--checkpoint", str(best), "--from-width", str(PRETRAIN_HW[1]),
               "--to-width", str(HW[1]), "--base-channels", str(BASE)]
    port = rescale_transfer.main([*rescale, "--out", str(root / "port_rescaled")])
    with pytest.MonkeyPatch.context() as monkeypatch:
        _jax_rescale_cli([*rescale, "--out", str(root / "jax_rescaled")], monkeypatch)
    return {"root": root, "best": best, "port": port, "jax": root / "jax_rescaled" / "rescaled"}


def test_rescaled_pt_is_the_rescale_of_best_pt(pretrained) -> None:
    """What the finetune starts from: ``rescaled.pt`` through the trainer's
    own load equals ``rescale_resolution_transfer`` of ``best.pt``, bitwise."""
    original = StereoUNet(base_channels=BASE, device="cpu")
    checkpoint.load_model_variables(pretrained["best"], original)
    want = rescale_resolution_transfer(original.state_dict(), HW[1] / PRETRAIN_HW[1])
    fresh = StereoUNet(base_channels=BASE, device="cpu")
    loaded = checkpoint.load_model_variables(pretrained["port"], fresh)
    assert loaded["epoch"] == 1 and not loaded["missing_keys"] and not loaded["unexpected_keys"]
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key
    assert pretrained["jax"].is_dir()


@pytest.mark.parametrize("start,extra", [
    ("rescaled", ()),
    ("rescaled", ("--lr-schedule", "cosine")),
    ("naive", ()),
], ids=["rescaled", "rescaled-cosine", "naive"])
def test_finetune_matches_the_jax_trainer(pretrained, start, extra) -> None:
    root = pretrained["root"]
    tag = f"{start}{len(extra)}"
    init = {"port": pretrained["port"], "jax": pretrained["jax"]} if start == "rescaled" \
        else dict.fromkeys(("port", "jax"), pretrained["best"])
    common = _flags(root, "--device-resident", "off", "--no-augment", *extra)
    jax_summary = jax_train(jax_parse_args(common + [
        "--mesh-devices", "1", "--init-checkpoint", str(init["jax"]),
        "--mlflow-tracking-uri", str(root / f"jax_runs_{tag}"),
        "--output-dir", str(root / f"jax_out_{tag}")]))
    port_summary = trainer.main(common + [
        "--init-checkpoint", str(init["port"]),
        "--mlflow-tracking-uri", str(root / f"port_runs_{tag}"),
        "--output-dir", str(root / f"port_out_{tag}")])
    jax_metrics = _metrics(root / f"jax_runs_{tag}", jax_summary["run_id"])
    port_metrics = _metrics(root / f"port_runs_{tag}", port_summary["run_id"])

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
    np.testing.assert_allclose(port_summary["best_val_mae"], jax_summary["best_val_mae"],
                               rtol=RTOL)
    (recorded,) = (root / f"port_runs_{tag}").glob(
        f"*/{port_summary['run_id']}/params/init_checkpoint")
    assert recorded.read_text().strip() == str(Path(init["port"]).expanduser())


def test_harness_records_each_size_and_rebuilds_the_packed_cache(tmp_path) -> None:
    """Two harness runs in one workdir, a pretrain and a cosine finetune
    from its ``best.pt`` at another size and batch: the scenes are generated
    once, the packed cache is rebuilt at the new size, and each artifact
    records its resolution, batch, schedule and init checkpoint."""
    work, docs = tmp_path / "work", tmp_path / "docs"

    def card(*extra: str) -> dict:
        return convergence_run.main([
            "card", "--device", "cpu", "--samples", "24", "--epochs", "1",
            "--workdir", str(work), "--docs-dir", str(docs), *extra])

    def packed_size() -> tuple[int, int]:
        meta = json.loads((work / "packed" / "train" / "meta.json").read_text())
        return meta["height"], meta["width"]

    fast = card("--height", "32", "--width", "64", "--batch-size", "8", "--tag", "_fast")
    generated = (work / "data" / "synth_meta.json").stat().st_mtime_ns
    assert packed_size() == (32, 64)
    best = Path(fast["summary"]["checkpoints_dir"]) / "best.pt"
    finetune = card("--height", "48", "--width", "64", "--batch-size", "4",
                    "--lr-schedule", "cosine", "--init-checkpoint", str(best),
                    "--tag", "_prog")
    assert (work / "data" / "synth_meta.json").stat().st_mtime_ns == generated
    assert packed_size() == (48, 64)
    for tag, run, hw, batch, schedule, init in (
        ("_fast", fast, [32, 64], 8, "constant", None),
        ("_prog", finetune, [48, 64], 4, "cosine", str(best)),
    ):
        config = json.loads((docs / f"card_metrics{tag}.json").read_text())["config"]
        assert (config["resolution"], config["batch_size"], config["lr_schedule"],
                config["init_checkpoint"]) == (hw, batch, schedule, init)
        assert config["initialiser"] == (
            f"--init-checkpoint {init}" if init else convergence_run.INITIALISER)
        assert run["summary"]["global_step"] == 22 // batch  # 22 train, pinned
