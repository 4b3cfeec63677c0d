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
``cpu`` is asked for. The JAX harness's ``compare`` mode runs the reference
trainer's source, which the repository does not hold; it is not ported.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .._device import resolve_cli_device
from ..training.checkpoint import load_checkpoint_meta
from ..training.config import TrainConfig
from ..training.trainer import train
from .make_synth_dataset import generate

REPO = Path(__file__).resolve().parents[2]
DOCS = REPO / "docs" / "convergence_torch"
JAX_DOCS = REPO / "docs" / "convergence"  # the JAX package's artifacts

METRIC_KEYS = ("train_loss", "train_mae", "val_loss", "val_mae", "val_rmse")
# What a fresh model is drawn from (``StereoUNet.reset_parameters``).
INITIALISER = ("the JAX package's: truncated LeCun-normal kernels, zero biases, "
               "BatchNorm 1/0")


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


def run_card(args: argparse.Namespace) -> dict:
    device = resolve_cli_device(args.device)
    docs = Path(args.docs_dir).resolve()
    if docs == JAX_DOCS.resolve() or JAX_DOCS.resolve() in docs.parents:
        raise ValueError(
            f"--docs-dir {args.docs_dir}: docs/convergence/ holds the JAX package's "
            "artifacts; write the port's elsewhere (default docs/convergence_torch/)")

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
    return parser


def main(argv: list[str] | None = None) -> dict:
    return run_card(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
