"""``foundation-stereo-predict`` on one GPU: batched offline disparity
inference.

Counterpart of ``stereo_depth_estimation_tpu/eval/predict.py``, with its
flags plus ``--device``:

    python -m stereo_depth_estimation_tpu_torch.eval.predict \\
        --left-dir <dir> --right-dir <dir> --checkpoint <last.pt> \\
        --predictions-dir <out> [--save-png] [--calibration <npz>]

runs a checkpoint over a directory of rectified stereo pairs (paired by
file stem) or a FoundationStereo dataset split, in batches, and writes per
pair ``<stem>.npz`` with float16 ``disparity``, ``logvar`` and
``confidence`` (plus metric ``depth_m`` when a calibration is given: the
focal length scaled from calibration to model width, the baseline from
P1/P2 or T), and optionally a percentile-normalised ``<stem>_disparity.png``.
Dataset outputs are keyed ``<scene>_<stem>``; a duplicate key raises.

Batches go to the device as uint8; the tail batch is padded to the batch
size, as the JAX CLI pads it, and its padding rows are dropped. Every
forward then runs at one shape, so a pair's output does not depend on the
batch it falls in: the convolutions' algorithms (cuDNN's, oneDNN's) are
chosen by batch size, and a tail of one pair unpadded lands a float16 ulp
away in places. Prints one JSON summary line.

``--compile`` runs the forward through ``torch.compile`` (one graph: every
batch has the one shape), and ``--aot-cache`` (``auto``:
``<predictions-dir>/.aot_cache``) carries its compile artifacts to later
processes, as evaluate's do. Eager is the default.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
from PIL import Image

from .._device import resolve_cli_device
from ..data.samples import discover_samples, split_samples
from ..models.unet import StereoUNet
from ..ops.geometry import (
    confidence_from_logvar_np,
    disparity_to_depth_np,
    estimate_baseline_m,
    scale_focal_to_model,
)
from ..ops.resize import resize_bilinear_np
from ..parallel.aot_cache import compile_cache_for
from ..parallel.train_step import compile_model, compile_options_from, make_predict_fn
from ..training.checkpoint import load_model_variables, resolve_checkpoint_path
from ..training.config import add_compile_arguments
from .preview import normalize_map

_IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Batched offline disparity inference over stereo pairs."
    )
    src = parser.add_argument_group("input (one of)")
    src.add_argument("--left-dir", type=Path, default=None,
                     help="Directory of left images; paired with --right-dir "
                          "by matching filename stem.")
    src.add_argument("--right-dir", type=Path, default=None)
    src.add_argument("--dataset-root", type=str, default=None,
                     help="FoundationStereo tree; predicts on a split's "
                          "left/right frames.")
    parser.add_argument("--split", type=str, default="val",
                        choices=("val", "train", "all"))
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--max-samples", type=int, default=0)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--batch-size", type=int, default=30)
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="Reference .pt file (the port reads no Orbax "
                             "directory).")
    parser.add_argument("--run-id", type=str, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"),
                        help="Training outputs root for checkpoint "
                             "resolution (as in foundation-stereo-eval).")
    parser.add_argument("--checkpoint-name", type=str, default="last")
    parser.add_argument("--base-channels", type=int, default=32)
    parser.add_argument("--predictions-dir", type=Path, required=True,
                        help="Where per-pair outputs are written.")
    parser.add_argument("--save-npz", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="<stem>.npz with disparity/logvar/confidence "
                             "(float16) per pair.")
    parser.add_argument("--save-png", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="Also write 5th-95th-percentile-normalized "
                             "grayscale <stem>_disparity.png.")
    parser.add_argument("--calibration", type=Path, default=None,
                        help="stereo_calib.npz; adds metric depth_m to the "
                             "npz (focal scaled calib->model width, "
                             "baseline from P1/P2 or T).")
    parser.add_argument("--aot-cache", type=str, default="auto",
                        help="Compile cache of --compile across processes: "
                             "'auto' = <predictions-dir>/.aot_cache, 'off', or a "
                             "directory. Unused without --compile.")
    parser.add_argument("--device", type=str, default="auto",
                        help="auto (= cuda), cuda or cpu.")
    add_compile_arguments(parser, "one graph for the forward")
    return parser


def _list_pairs(left_dir: Path, right_dir: Path) -> list[tuple[str, Path, Path]]:
    pairs = []
    for left in sorted(left_dir.iterdir()):
        if left.suffix.lower() not in _IMAGE_EXTS:
            continue
        right = next(
            (
                right_dir / (left.stem + ext)
                for ext in _IMAGE_EXTS
                if (right_dir / (left.stem + ext)).exists()
            ),
            None,
        )
        if right is not None:
            pairs.append((left.stem, left, right))
    return pairs


def _load_pair_u8(left: Path, right: Path, hw: tuple[int, int]) -> np.ndarray:
    def one(path: Path) -> np.ndarray:
        rgb = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        resized = resize_bilinear_np(rgb, hw)
        return np.clip(resized * 255.0, 0, 255).astype(np.uint8)

    return np.concatenate([one(left), one(right)], axis=-1)  # (H, W, 6)


def _scene_qualified_stem(sample) -> str:
    """``<scene>_<stem>`` by the cache key's scene rule (the path segment
    before ``dataset``), else the bare stem for other layouts."""
    parts = sample.left_rgb_path.parts
    if "dataset" in parts and parts.index("dataset") > 0:
        return f"{parts[parts.index('dataset') - 1]}_{sample.left_rgb_path.stem}"
    return sample.left_rgb_path.stem


def _depth_geometry(calibration: Path, model_width: int) -> tuple[float, float]:
    calib = np.load(calibration)
    p1 = calib["P1"] if "P1" in calib else None
    p2 = calib["P2"] if "P2" in calib else None
    t = calib["T"] if "T" in calib else None
    baseline_m = estimate_baseline_m(p1, p2, t)
    if baseline_m is None:
        raise ValueError(f"No usable baseline in calibration: {calibration}")
    if p1 is None and "mtx_l" not in calib:
        raise ValueError(
            "Calibration file has neither 'P1' nor 'mtx_l', so no focal "
            f"length is available: {calibration}"
        )
    focal_calib = float(p1[0, 0]) if p1 is not None else float(calib["mtx_l"][0, 0])
    if "image_size" not in calib:
        raise ValueError(f"Calibration file is missing 'image_size': {calibration}")
    calib_width = int(np.asarray(calib["image_size"]).reshape(-1)[0])
    return scale_focal_to_model(focal_calib, calib_width, model_width), baseline_m


def _pairs(args: argparse.Namespace) -> list[tuple[str, Path, Path]]:
    """(output key, left, right) for every pair to predict; raises on a
    duplicate key."""
    if (args.left_dir is None) != (args.right_dir is None):
        raise ValueError("--left-dir and --right-dir must be given together.")
    if (args.left_dir is None) == (args.dataset_root is None):
        raise ValueError("Give either --left-dir/--right-dir or --dataset-root.")

    if args.dataset_root is not None:
        samples = discover_samples(args.dataset_root)
        if args.max_samples > 0:
            samples = samples[: args.max_samples]
        if args.split != "all":
            train_s, val_s = split_samples(samples, args.val_fraction, args.seed)
            samples = val_s if args.split == "val" else train_s
        # Stems are per-scene frame indices (000000.png is in every scene),
        # so keys are scene-qualified.
        pairs = [
            (_scene_qualified_stem(s), s.left_rgb_path, s.right_rgb_path) for s in samples
        ]
    else:
        pairs = _list_pairs(args.left_dir, args.right_dir)
        if args.max_samples > 0:
            pairs = pairs[: args.max_samples]
    if not pairs:
        raise ValueError("No stereo pairs found to predict on.")
    seen: dict[str, Path] = {}
    for stem, left, _right in pairs:
        if stem in seen:
            raise ValueError(
                f"Duplicate output key {stem!r} for {left} and {seen[stem]}: "
                "outputs would overwrite each other. Rename the colliding "
                "inputs or predict the directories separately."
            )
        seen[stem] = left
    return pairs


def predict(args: argparse.Namespace) -> dict[str, Any]:
    device = resolve_cli_device(args.device)
    pairs = _pairs(args)

    checkpoint_path = resolve_checkpoint_path(
        args.output_dir, checkpoint=args.checkpoint, run_id=args.run_id,
        checkpoint_name=args.checkpoint_name,
    )
    model = StereoUNet(base_channels=args.base_channels, device=device).eval()
    load_model_variables(checkpoint_path, model)
    options = compile_options_from(args)
    predict_fn = make_predict_fn(
        model, compiled=None if options is None else compile_model(model, options))
    cache = None
    if options is not None:
        cache = compile_cache_for(args.aot_cache, args.predictions_dir, {
            "cli": "predict", "compile_mode": options.mode, "compile_backend": options.backend,
            "base_channels": args.base_channels, "compute_dtype": "float32",
            "batch_size": args.batch_size, "height": args.height, "width": args.width,
        }, device)
    if cache is not None:
        cache.load()
        predict_fn = cache.wrap(predict_fn, "predict")
    hw = (args.height, args.width)

    geometry = None
    if args.calibration is not None:
        geometry = _depth_geometry(args.calibration, args.width)

    out_dir = args.predictions_dir
    out_dir.mkdir(parents=True, exist_ok=True)

    written = 0
    start = time.perf_counter()
    batch_size = args.batch_size
    for begin in range(0, len(pairs), batch_size):
        chunk = pairs[begin : begin + batch_size]
        batch = np.zeros((batch_size, *hw, 6), np.uint8)  # tail rows stay padding
        for i, (_stem, left, right) in enumerate(chunk):
            batch[i] = _load_pair_u8(left, right, hw)
        disp, logvar = predict_fn(torch.from_numpy(batch).to(device))
        disp = disp[: len(chunk)].cpu().numpy()
        logvar = logvar[: len(chunk)].cpu().numpy()
        for i, (stem, _left, _right) in enumerate(chunk):
            if args.save_npz:
                payload = {
                    "disparity": disp[i].astype(np.float16),
                    "logvar": logvar[i].astype(np.float16),
                    "confidence": confidence_from_logvar_np(logvar[i]).astype(np.float16),
                }
                if geometry is not None:
                    focal_model, baseline_m = geometry
                    payload["depth_m"] = disparity_to_depth_np(
                        disp[i], focal_model, baseline_m
                    ).astype(np.float16)
                np.savez(out_dir / f"{stem}.npz", **payload)
            if args.save_png:
                Image.fromarray(normalize_map(disp[i])).save(out_dir / f"{stem}_disparity.png")
            written += 1
    elapsed = time.perf_counter() - start
    if cache is not None:
        cache.finish()

    result = {
        "checkpoint": str(checkpoint_path),
        "pairs": written,
        "output_dir": str(out_dir),
        "seconds": round(elapsed, 2),
        "pairs_per_sec": round(written / elapsed, 2) if elapsed > 0 else None,
        "depth": geometry is not None,
    }
    if cache is not None:
        result["compile_cache"] = cache.reports
    print(json.dumps(result))
    return result


def main(argv: list[str] | None = None) -> dict[str, Any]:
    return predict(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
