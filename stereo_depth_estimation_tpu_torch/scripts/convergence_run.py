"""Convergence evidence harness on the GPU.

Counterpart of ``scripts/convergence_run.py``'s ``tpu`` mode:

    python -m stereo_depth_estimation_tpu_torch.scripts.convergence_run card \\
        --epochs 200 --samples 4096

``card`` trains the full-size model (base 32, 240x320, batch 128,
augmentation on, bf16 compute, packed cache and device-resident train set,
eager) for many epochs on a synthetic stereo dataset (``make_synth_dataset``:
layered fronto-parallel scenes with exact ground truth, always generated at
240x320; other ``--height``/``--width`` resize on load with width-scaled
disparity). It writes the per-epoch train/val metric trajectory
(``card_metrics{tag}.json``, the JAX artifact's keys plus the card's name and
power limit and the pairs per second) and the preview montages of the first
and last epochs (``card_preview{tag}_{first,last}_epoch.png``) to
``--docs-dir``, by default ``docs/convergence_torch/``. It refuses
``docs/convergence/``, whose files are the JAX package's. ``--seed``
(default 42) is the trainer's; the artifact's ``config`` records it and the
initialiser (the JAX package's, or the ``--init-checkpoint`` it loaded).

An interrupted run carries on with ``--resume-from <workdir>/outputs/<run>/
checkpoints/last.pt``: the tracking directory is kept and the artifact merges
the epoch records of both runs, and keeps the first run's first-epoch
preview. ``--device`` is the card (``cuda``, raising without CUDA) unless
``cpu`` is asked for.

Counterpart of the JAX harness's ``compare`` mode, with the JAX package's
trainer in the reference trainer's place:

    python -m stereo_depth_estimation_tpu_torch.scripts.convergence_run compare \\
        --device cpu --epochs 12

``compare`` generates ``--samples`` scenes at ``--height`` x ``--width``,
draws one fresh model at ``--seed`` (the JAX package's initialisers), saves
it as ``init.pt``, and trains it twice with the same flags: first with the
JAX trainer (``python -m stereo_depth_estimation_tpu.training.trainer`` in a
child process with ``JAX_PLATFORMS=cpu``; this package never imports it),
then with the port's trainer in this process on ``--device``. Both run
float32 without augmentation on streamed batches, so they see the same split
and the same batches in the same order, and log the train loss at every
step. A child that fails raises with the end of its output. With
``--init-checkpoint`` both start from that .pt instead (``init.pt`` is its
copy); with ``--rescale-from-width`` too, each package's rescale CLI first
rescales it for ``--width`` and each trainer starts from its own side's
(section 4's width-rescaled finetune, the JAX package's
``scripts/rescale_transfer.py`` run as a child as well). The artifact,
``compare_jax{tag}.json`` in ``--docs-dir``, has the JAX artifact
``docs/convergence/compare.json``'s keys (the JAX trainer under
``reference``, the port under ``this_framework``), both per-step train-loss
series, the init's SHA-256 as each trainer was handed it, and the device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from .._device import resolve_cli_device
from ..models import StereoUNet
from ..training.checkpoint import load_checkpoint_meta
from ..training.config import TrainConfig, parse_args
from ..training.trainer import train
from . import rescale_transfer
from .make_synth_dataset import generate

REPO = Path(__file__).resolve().parents[2]
DOCS = REPO / "docs" / "convergence_torch"
JAX_DOCS = REPO / "docs" / "convergence"  # the JAX package's artifacts

METRIC_KEYS = ("train_loss", "train_mae", "val_loss", "val_mae", "val_rmse")
# What a fresh model is drawn from (``StereoUNet.reset_parameters``).
INITIALISER = ("the JAX package's: truncated LeCun-normal kernels, zero biases, "
               "BatchNorm 1/0")
# The reference trainer of ``compare``: run as a child process, never imported.
JAX_TRAINER = "stereo_depth_estimation_tpu.training.trainer"


def _log(msg: str) -> None:
    print(f"[convergence] {msg}", flush=True)


def _read_jsonl_metrics(tracking_dir: Path) -> list[dict]:
    """Merge every metrics.jsonl under the jsonl tracking dir -> epoch
    records (step-metric records, which carry train_* keys only, are
    filtered out by requiring epoch_seconds). Merging handles resumed
    runs, where epochs 1..k live in the interrupted run's file and
    k+1..N in the resumed run's; for a duplicated epoch the newest
    file's record wins."""
    candidates = sorted(
        tracking_dir.rglob("metrics.jsonl"), key=lambda p: p.stat().st_mtime
    )
    if not candidates:
        raise FileNotFoundError(f"No metrics.jsonl under {tracking_dir}")
    by_epoch: dict[int, dict] = {}
    for path in candidates:  # oldest first; newer files overwrite
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            r = json.loads(line)
            if "epoch_seconds" in r:
                by_epoch[int(r["step"])] = r
    return list(by_epoch.values())


def _epoch_series(records: list[dict], keys: tuple[str, ...]) -> dict:
    series: dict[str, list] = {"epoch": []}
    for key in keys:
        series[key] = []
    for r in sorted(records, key=lambda r: r["step"]):
        series["epoch"].append(int(r["step"]))
        for key in keys:
            series[key].append(round(float(r[key]), 5) if key in r else None)
    return series


def describe_device(device: torch.device) -> dict:
    """The device the run trained on: on CUDA the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 1}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, power_limit = smi.stdout.strip().splitlines()[0].rsplit(", ", 1)
    return {"name": name, "power_limit": power_limit, "count": torch.cuda.device_count()}


def _docs_dir(arg: str) -> Path:
    docs = Path(arg).resolve()
    if docs == JAX_DOCS.resolve() or JAX_DOCS.resolve() in docs.parents:
        raise ValueError(
            f"--docs-dir {arg}: docs/convergence/ holds the JAX package's "
            "artifacts; write the port's elsewhere (default docs/convergence_torch/)")
    return docs


def run_card(args: argparse.Namespace) -> dict:
    device = resolve_cli_device(args.device)
    docs = _docs_dir(args.docs_dir)

    work = Path(args.workdir)
    data = work / "data"
    hw = (args.height, args.width)
    meta_path = data / "synth_meta.json"
    if meta_path.exists():
        existing = json.loads(meta_path.read_text())["samples"]
        if existing != args.samples:
            raise SystemExit(
                f"{data} holds {existing} samples but --samples="
                f"{args.samples}; pick a fresh --workdir (reusing a "
                "differently-sized dataset would silently change the run)."
            )
    else:
        _log(f"generating {args.samples} samples at 240x320 ...")
        meta = generate(data, args.samples, 8, (240, 320), 48.0, seed=0)
        _log(f"dataset ready in {meta['elapsed_seconds']}s")

    trk = work / "tracking"
    if trk.exists() and not args.resume_from:
        shutil.rmtree(trk)
    start_step = 0
    if args.resume_from:
        carry = (load_checkpoint_meta(Path(args.resume_from))["metrics"] or {}).get(
            "resume_carry", {})
        start_step = int(carry.get("global_step", 0))
    cfg = TrainConfig(
        dataset_root=str(data),
        height=hw[0], width=hw[1],
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=1e-3, weight_decay=1e-4,
        val_fraction=0.1, seed=args.seed,
        device=args.device,
        augment=True,
        compute_dtype="bfloat16",
        packed_cache_root=str(work / "packed"),
        device_resident="auto",
        output_dir=str(work / "outputs"),
        mlflow_tracking_uri=f"jsonl://{trk}",
        preview_samples=args.preview_samples,
        num_workers=0,
        init_checkpoint=args.init_checkpoint,
        lr_schedule=args.lr_schedule,
        lr_warmup_steps=args.lr_warmup_steps,
        resume=args.resume_from or None,
    )
    _log(f"training base=32 {hw} batch={args.batch_size} "
         f"for {args.epochs} epochs on {device} ...")
    t0 = time.perf_counter()
    summary = train(cfg)
    train_seconds = time.perf_counter() - t0
    summary.pop("state", None)  # the trained model: only its checkpoints are needed
    _log(f"train() done in {train_seconds:.0f}s: {summary}")

    records = _read_jsonl_metrics(trk)
    series = _epoch_series(records, METRIC_KEYS)
    epoch_seconds = sum(e["epoch_seconds"] for e in summary["epochs"])
    docs.mkdir(parents=True, exist_ok=True)
    artifact = {
        "config": {
            "model": "StereoUNet base=32 (7,763,938 params)",
            "resolution": list(hw),
            "batch_size": args.batch_size,
            "epochs": args.epochs,
            "samples": args.samples,
            "augment": True,
            "compute_dtype": "bfloat16",
            "optimizer": "AdamW lr=1e-3 wd=1e-4",
            "lr_schedule": args.lr_schedule,
            "lr_warmup_steps": args.lr_warmup_steps,
            "seed": cfg.seed,
            "initialiser": f"--init-checkpoint {args.init_checkpoint}" if args.init_checkpoint
            else INITIALISER,
            "val_fraction": cfg.val_fraction,
            "dataset": "stereo_depth_estimation_tpu_torch/scripts/make_synth_dataset.py "
                       "(seed 0)",
            "pipeline": f"packed cache + device-resident ({summary['device_resident']}), "
                        "eager",
            "framework": f"torch {torch.__version__} (CUDA {torch.version.cuda})",
            "init_checkpoint": args.init_checkpoint,
            "resumed_from": args.resume_from,
        },
        "device": describe_device(device),
        "wall_seconds": round(train_seconds, 1),
        # Trained pairs per second of this run's epochs (each epoch's
        # training and validation; previews and checkpoints excluded).
        "pairs_per_second": round(
            (summary["global_step"] - start_step) * args.batch_size / epoch_seconds, 2)
        if epoch_seconds else None,
        # Best over the MERGED series, so a --resume-from artifact reports
        # the run's global best.
        "best_epoch": min(
            zip(series["val_mae"], series["epoch"]),
            default=(summary["best_val_mae"], summary["best_epoch"]),
            key=lambda t: float("inf") if t[0] is None else t[0],
        )[1],
        "best_val_mae": round(
            min(
                (m for m in series["val_mae"] if m is not None),
                default=float(summary["best_val_mae"]),
            ),
            5,
        ),
        "series": series,
    }
    out_name = f"card_metrics{args.tag}.json"
    (docs / out_name).write_text(json.dumps(artifact, indent=2))
    _log(f"wrote {docs / out_name}")

    # First/last epoch preview montages (sample 0). A resumed run's outputs
    # start at the resume epoch, so it must not overwrite the interrupted
    # run's first-epoch montage.
    previews = work / "outputs" / summary["run_id"] / "mlflow_previews"
    if previews.exists():
        epochs_dirs = sorted(previews.iterdir())
        for tag, src_dir in (("first", epochs_dirs[0]), ("last", epochs_dirs[-1])):
            dest = f"card_preview{args.tag}_{tag}_epoch.png"
            if tag == "first" and args.resume_from and (docs / dest).exists():
                _log(f"kept pre-resume {dest}")
                continue
            pngs = sorted(src_dir.glob("*.png"))
            if pngs:
                shutil.copy2(pngs[0], docs / dest)
                _log(f"copied {pngs[0].name} -> {dest}")
    print(json.dumps({"best_val_mae": artifact["best_val_mae"],
                      "best_epoch": artifact["best_epoch"],
                      "first_val_mae": series["val_mae"][0],
                      "last_val_mae": series["val_mae"][-1]}))
    return {**artifact, "summary": summary}


# --------------------------------------------------------------------------
# compare mode
# --------------------------------------------------------------------------

def _sha256(path: Path) -> str:
    """A file's SHA-256; a directory's (an Orbax checkpoint) over its files'
    relative paths and bytes, in order."""
    path = Path(path)
    if path.is_file():
        return hashlib.sha256(path.read_bytes()).hexdigest()
    digest = hashlib.sha256()
    for f in sorted(p for p in path.rglob("*") if p.is_file()):
        digest.update(str(f.relative_to(path)).encode())
        digest.update(f.read_bytes())
    return digest.hexdigest()


def _read_jsonl_steps(tracking_dir: Path) -> dict[int, dict]:
    """The step records (those without ``epoch_seconds``) of the one run
    under a jsonl tracking dir, by global step."""
    (path,) = tracking_dir.rglob("metrics.jsonl")
    records = (json.loads(line) for line in path.read_text().splitlines() if line.strip())
    return {int(r["step"]): r for r in records if "epoch_seconds" not in r}


def _read_jsonl_params(tracking_dir: Path) -> dict:
    (path,) = tracking_dir.rglob("params.json")
    return json.loads(path.read_text())


def _compare_flags(args: argparse.Namespace, work: Path, side: str, start: Path) -> list[str]:
    """The trainer flags of ``compare``, the same for both trainers but for
    their output and tracking directories (``side``) and, after a rescale,
    the checkpoint each starts from (``start``)."""
    return [
        "--dataset-root", str(work / "data"),
        "--height", str(args.height), "--width", str(args.width),
        "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
        "--lr", "1e-3", "--weight-decay", "1e-4",
        "--val-fraction", "0.25", "--seed", str(args.seed),
        "--base-channels", str(args.base_channels), "--mesh-devices", "1",
        "--no-augment", "--compute-dtype", "float32", "--input-precision", "float32",
        "--device-resident", "off", "--num-workers", "0", "--aot-cache", "off",
        "--preview-samples", "0", "--log-every-batches", "1",
        "--init-checkpoint", str(start),
        "--output-dir", str(work / f"{side}_outputs"),
        "--mlflow-tracking-uri", f"jsonl://{work / f'{side}_tracking'}",
    ]


def _run_jax_child(work: Path, argv: list[str], name: str) -> None:
    """``python <argv>`` of the JAX package on the CPU in a child process;
    its output goes to ``<workdir>/<name>.log``. A child that fails raises
    with the end of its output."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    _log(f"{name}: " + " ".join(argv))
    done = subprocess.run([sys.executable, *argv], env=env, cwd=work, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    (work / f"{name}.log").write_text(done.stdout)
    if done.returncode != 0:
        raise RuntimeError(
            f"the JAX child {name} exited with {done.returncode}; the end of its output:\n"
            + done.stdout[-4000:])


def _run_jax_trainer(work: Path, flags: list[str]) -> None:
    _run_jax_child(work, ["-m", JAX_TRAINER, *flags, "--device", "cpu"], "jax_trainer")


def _rescaled_starts(args: argparse.Namespace, work: Path) -> dict[str, Path]:
    """``init.pt`` rescaled for ``--width`` by each package's rescale CLI:
    the JAX package's ``scripts/rescale_transfer.py`` in a child process
    (an Orbax directory) and the port's ``rescale_transfer`` (a .pt)."""
    common = ["--checkpoint", str(work / "init.pt"), "--from-width",
              str(args.rescale_from_width), "--to-width", str(args.width),
              "--base-channels", str(args.base_channels)]
    _run_jax_child(work, [str(REPO / "scripts" / "rescale_transfer.py"), *common,
                          "--out", str(work / "jax_rescaled")], "jax_rescale")
    return {"jax": work / "jax_rescaled" / "rescaled",
            "port": rescale_transfer.main([*common, "--out", str(work / "port_rescaled")])}


def _rel(ours: list, ref: list) -> list:
    return [None if (a is None or b in (None, 0)) else round(abs(a - b) / abs(b), 7)
            for a, b in zip(ours, ref)]


def run_compare(args: argparse.Namespace) -> dict:
    device = resolve_cli_device(args.device)
    docs = _docs_dir(args.docs_dir)
    work = Path(args.workdir).resolve()
    hw = (args.height, args.width)
    if args.rescale_from_width and not args.init_checkpoint:
        raise ValueError("--rescale-from-width rescales --init-checkpoint; give both")
    for side in ("jax", "port"):
        for stale in ("outputs", "tracking", "rescaled"):
            shutil.rmtree(work / f"{side}_{stale}", ignore_errors=True)
    work.mkdir(parents=True, exist_ok=True)
    max_disp = 48.0 * args.width / 320.0
    meta_path = work / "data" / "synth_meta.json"
    want = {"samples": args.samples, "height": args.height, "width": args.width}
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if {k: meta[k] for k in want} != want:
            raise SystemExit(f"{work / 'data'} holds {meta}, not {want}; pick a fresh --workdir")
    else:
        _log(f"generating {args.samples} samples at {hw} ...")
        generate(work / "data", args.samples, 2, hw, max_disp, seed=0)

    if args.init_checkpoint:
        shutil.copyfile(args.init_checkpoint, work / "init.pt")
        init = f"--init-checkpoint {Path(args.init_checkpoint).name}"
    else:
        model = StereoUNet(base_channels=args.base_channels, device="cpu",
                           generator=torch.Generator().manual_seed(args.seed))
        torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, work / "init.pt")
        init = (f"a fresh StereoUNet base={args.base_channels} drawn at seed {args.seed} "
                f"from the JAX package's initialisers ({INITIALISER})")
    init_sha = _sha256(work / "init.pt")
    _log(f"init.pt: {init}, sha256 {init_sha}")
    starts = ({"jax": work / "init.pt", "port": work / "init.pt"}
              if not args.rescale_from_width else _rescaled_starts(args, work))

    # The JAX trainer is the reference; each side's files are under its prefix.
    sides = {}
    for name, prefix in (("reference", "jax"), ("this_framework", "port")):
        flags = _compare_flags(args, work, prefix, starts[prefix])
        t0 = time.perf_counter()
        if prefix == "jax":
            _run_jax_trainer(work, flags)
        else:
            _log(f"the port's trainer on {device} ...")
            train(parse_args(flags + ["--device", args.device])).pop("state", None)
        seconds = round(time.perf_counter() - t0, 1)
        _log(f"{prefix} trainer done in {seconds}s")
        trk = work / f"{prefix}_tracking"
        params = _read_jsonl_params(trk)
        sides[name] = {
            "epochs": _epoch_series(_read_jsonl_metrics(trk), METRIC_KEYS),
            "steps": _read_jsonl_steps(trk),
            "split": [params["train_samples"], params["val_samples"]],
            "init_sha256": _sha256(Path(params["init_checkpoint"])),
            "seconds": seconds,
        }

    ref, ours = sides["reference"]["epochs"], sides["this_framework"]["epochs"]
    steps = sorted(sides["reference"]["steps"])
    if steps != sorted(sides["this_framework"]["steps"]):
        raise RuntimeError("the two trainers logged different steps")
    step_loss = {name: [side["steps"][i]["train_loss_step"] for i in steps]
                 for name, side in sides.items()}
    step_rel = _rel(step_loss["this_framework"], step_loss["reference"])
    parting = next((i for i, r in zip(steps, step_rel) if r > 1e-4), None)
    artifact = {
        "protocol": {
            "data": f"{args.samples} synthetic samples @ {hw}, seed 0, 2 scenes, "
                    f"max disparity {max_disp}",
            "init": f"{init}, saved as init.pt; "
                    + (f"rescaled from width {args.rescale_from_width} to {args.width} by "
                       "each package's rescale CLI (the JAX package's "
                       "scripts/rescale_transfer.py, the port's rescale_transfer), each "
                       "trainer's --init-checkpoint its own side's"
                       if args.rescale_from_width else "both trainers' --init-checkpoint"),
            "optimizer": "AdamW lr=1e-3 wd=1e-4",
            "augment": False,
            "precision": "float32 compute and float32 input, both trainers",
            "note": "the same split and the same batches in the same order: both "
                    "trainers stream them (no packed cache, not device-resident)",
            "reference_cmd": f"python -m {JAX_TRAINER} <flags> --device cpu "
                             "(child process, JAX_PLATFORMS=cpu)",
            "this_framework_cmd": f"training.trainer.train(parse_args(<flags> "
                                  f"--device {args.device})), in process",
            "flags": _compare_flags(args, Path("<workdir>"), "<side>", Path("<start>")),
        },
        # What each trainer's --init-checkpoint read: init.pt itself, or
        # after a rescale its side's rescaled checkpoint.
        "init": {"sha256": init_sha, "rescaled_from_width": args.rescale_from_width,
                 **{name: side["init_sha256"] for name, side in sides.items()}},
        "split": {name: side["split"] for name, side in sides.items()},
        "device": {"reference": "cpu", "this_framework": describe_device(device)},
        "framework": f"torch {torch.__version__}",
        "seconds": {name: side["seconds"] for name, side in sides.items()},
        "reference": ref,
        "this_framework": ours,
        "delta_ours_minus_ref": {
            key: [None if (a is None or b is None) else round(a - b, 5)
                  for a, b in zip(ours[key], ref[key])]
            for key in METRIC_KEYS
        },
        "relative_abs_delta": {key: _rel(ours[key], ref[key])
                               for key in ("train_loss", "val_mae")},
        "steps": {
            "step": steps,
            "reference_train_loss": step_loss["reference"],
            "this_framework_train_loss": step_loss["this_framework"],
            "relative_abs_delta": step_rel,
            "first_step_apart_over_1e-4": parting,
        },
    }
    docs.mkdir(parents=True, exist_ok=True)
    out = docs / f"compare_jax{args.tag}.json"
    out.write_text(json.dumps(artifact, indent=2))
    _log(f"wrote {out}")
    print(json.dumps({
        "ref_val_mae": ref["val_mae"],
        "our_val_mae": ours["val_mae"],
        "rel_abs_delta_val_mae": artifact["relative_abs_delta"]["val_mae"],
        "first_step_apart_over_1e-4": parting,
    }))
    return artifact


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    card = sub.add_parser("card")
    card.add_argument("--epochs", type=int, default=30)
    card.add_argument("--samples", type=int, default=2048)
    card.add_argument("--height", type=int, default=240)
    card.add_argument("--width", type=int, default=320)
    card.add_argument("--batch-size", type=int, default=128)
    card.add_argument("--tag", type=str, default="",
                      help="artifact filename suffix, e.g. _fast")
    card.add_argument("--preview-samples", type=int, default=4)
    card.add_argument("--workdir", type=str, default=str(REPO / "build" / "convergence_card"),
                      help="Dataset, packed cache, tracking and checkpoints.")
    card.add_argument("--docs-dir", type=str, default=str(DOCS), dest="docs_dir",
                      help="Where the artifact and the previews go.")
    card.add_argument("--device", type=str, default="cuda",
                      help='"cuda" (the card; raises without CUDA) or "cpu".')
    card.add_argument(
        "--resume-from", type=str, default=None, dest="resume_from",
        help="Resume an interrupted run from this last.pt (the trainer's "
             "full-state resume). The workdir's tracking dir is kept and "
             "the artifact merges epoch records across the interrupted and "
             "resumed runs.",
    )
    card.add_argument("--seed", type=int, default=42,
                      help="The trainer's seed: the fresh weights, the train/val "
                           "split, the augmentation and the shuffle.")
    card.add_argument("--lr-schedule", type=str, default="constant",
                      choices=("constant", "cosine"), dest="lr_schedule")
    card.add_argument("--lr-warmup-steps", type=int, default=0,
                      dest="lr_warmup_steps")
    card.add_argument(
        "--init-checkpoint", type=str, default=None,
        help="Initialise model weights from this .pt. Enables "
             "progressive-resolution schedules: pretrain at a small "
             "resolution, rescale (rescale_transfer), then finetune at full "
             "resolution.",
    )

    cmp_ = sub.add_parser("compare")
    cmp_.add_argument("--epochs", type=int, default=5)
    cmp_.add_argument("--samples", type=int, default=128)
    cmp_.add_argument("--height", type=int, default=96)
    cmp_.add_argument("--width", type=int, default=128)
    cmp_.add_argument("--batch-size", type=int, default=16)
    cmp_.add_argument("--seed", type=int, default=42,
                      help="The fresh model's seed and both trainers'.")
    cmp_.add_argument("--base-channels", type=int, default=32,
                      help="UNet width (32 = the reference architecture).")
    cmp_.add_argument("--workdir", type=str, default=str(REPO / "build" / "convergence_cmp"),
                      help="Dataset, init.pt, both trainers' tracking and checkpoints.")
    cmp_.add_argument("--docs-dir", type=str, default=str(DOCS), dest="docs_dir",
                      help="Where compare_jax{tag}.json goes.")
    cmp_.add_argument("--tag", type=str, default="",
                      help="artifact filename suffix, e.g. _transfer")
    cmp_.add_argument("--init-checkpoint", type=str, default=None, dest="init_checkpoint",
                      help="Start both trainers from this .pt (a pretrain's best.pt) "
                           "instead of a fresh model.")
    cmp_.add_argument("--rescale-from-width", type=int, default=None,
                      dest="rescale_from_width",
                      help="With --init-checkpoint: each package's rescale CLI rescales it "
                           "from this width to --width, and each trainer starts from its "
                           "own side's (docs/CONVERGENCE.md section 4's start).")
    cmp_.add_argument("--device", type=str, default="cuda",
                      help='The port\'s side: "cuda" (the card; raises without CUDA) '
                           'or "cpu". The JAX trainer runs on the CPU.')
    return parser


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    return run_compare(args) if args.mode == "compare" else run_card(args)


if __name__ == "__main__":
    main()
