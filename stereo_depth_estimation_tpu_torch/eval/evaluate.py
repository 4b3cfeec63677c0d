"""``foundation-stereo-eval``: offline metric evaluation of a checkpoint, on
one GPU or several.

Counterpart of ``stereo_depth_estimation_tpu/eval/evaluate.py``, with the
same flags and the same JSON line:

    python -m stereo_depth_estimation_tpu_torch.eval.evaluate \\
        --dataset-root <root> --checkpoint <last.pt> [--device cpu]

Scores a reference ``.pt`` checkpoint (the port's own, or the JAX package's
export) on a side of the seeded split with the trainer's pixel-weighted
metrics (mae/rmse/nll/sigma over valid pixels) and prints one JSON line. The
model runs in float32 with its running BatchNorm statistics, as the JAX CLI
builds it.

The tail batch is padded to the batch size with rows flagged invalid, as the
JAX CLI pads it (``parallel/mesh.py::pad_batch_to``): eval-mode BatchNorm
treats each sample on its own and every metric is a masked sum, so the
metrics are those of the samples, and every batch has one shape.

``--compile`` runs the eval forward through ``torch.compile`` (one graph for
the pass, the tail included), as the trainer's ``--compile`` does; with
``--aot-cache`` (``auto``: ``<output-dir>/.aot_cache``) a later process
loads Inductor's compile artifacts from the blob the first one saved
(``parallel/aot_cache.py``). Eager is the default: a cold compile costs
tens of seconds, which a short evaluation never earns back.

``--mesh-devices N`` scores on N ranks, one GPU each, as the JAX CLI shards
over N devices: each rank fetches its block of every batch, padded with
flagged wrap rows to the data rows (``MultihostBatcher``), and the metric
sums are summed over the ranks; rank 0 prints the line. With
``--spatial-devices S`` the ranks form a (N / S, S) mesh that also shards
image height, the model exchanging halo rows around its convolutions
(``parallel/mesh.py``); an N that S does not divide raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any

from .._device import local_rank_count, resolve_cli_device
from ..data.dataset import StereoSampleLoader
from ..data.pipeline import batch_iterator, cuda_put, loader_fetch, prefetch_to_device
from ..data.samples import discover_samples, split_samples
from ..models.unet import StereoUNet
from ..ops.loss import LossStats, accumulate_stats, metrics_from_stats
from ..parallel.aot_cache import compile_cache_for
from ..parallel.distributed import MultihostBatcher, is_main_process, run_ranks
from ..parallel.mesh import Mesh, pad_batch_to
from ..parallel.train_step import TrainState, compile_model, compile_options_from, make_eval_step
from ..training.checkpoint import load_model_variables, resolve_checkpoint_path
from ..training.config import add_compile_arguments


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Score a trained checkpoint on a dataset split "
                    "(pixel-weighted mae/rmse/nll, same math as training)."
    )
    parser.add_argument("--dataset-root", type=str, required=True)
    parser.add_argument("--split", type=str, default="val",
                        choices=("val", "train", "all"),
                        help="Which side of the seeded split to score.")
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=42,
                        help="Split seed; match the training run's.")
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--batch-size", type=int, default=30)
    parser.add_argument("--max-samples", type=int, default=0)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--cache-root", type=str, default=None)
    parser.add_argument("--require-cache", action="store_true")
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="Reference .pt file (the port reads no Orbax "
                             "directory).")
    parser.add_argument("--run-id", type=str, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    parser.add_argument("--checkpoint-name", type=str, default="last")
    parser.add_argument("--base-channels", type=int, default=32,
                        help="UNet width; must match the checkpoint's.")
    parser.add_argument("--device", type=str, default="auto",
                        help="auto (= cuda), cuda or cpu.")
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="Ranks, one GPU each (0 = all visible GPUs; one "
                             "rank on the CPU); batches split over them.")
    parser.add_argument("--spatial-devices", type=int, default=1,
                        help="Shard image height over this many of the ranks "
                             "(a (ranks / N, N) mesh); it must divide them.")
    parser.add_argument("--aot-cache", type=str, default="auto",
                        help="Compile cache of --compile across processes: "
                             "'auto' = <output-dir>/.aot_cache, 'off', or a "
                             "directory. Unused without --compile.")
    add_compile_arguments(parser, "one graph for the eval forward")
    return parser


def evaluate(args: argparse.Namespace) -> dict[str, Any]:
    device = resolve_cli_device(args.device)
    local = local_rank_count(device, args.mesh_devices)
    return run_ranks(evaluate_rank, (args,), device=device, local_ranks=local,
                     spatial=args.spatial_devices)


def evaluate_rank(mesh: Mesh, args: argparse.Namespace) -> dict[str, Any]:
    """Evaluate on one rank of ``mesh``; rank 0 prints the JSON line."""
    device = mesh.device
    samples = discover_samples(args.dataset_root)
    if args.max_samples > 0:
        samples = samples[: args.max_samples]
    if args.split != "all":
        train_s, val_s = split_samples(samples, args.val_fraction, args.seed)
        samples = val_s if args.split == "val" else train_s
    if not samples:
        raise ValueError(f"No samples to evaluate (split={args.split}).")

    checkpoint_path = resolve_checkpoint_path(
        args.output_dir, checkpoint=args.checkpoint, run_id=args.run_id,
        checkpoint_name=args.checkpoint_name,
    )
    model = StereoUNet(base_channels=args.base_channels, device=device,
                       spatial_group=mesh.spatial_group)
    ckpt_meta = load_model_variables(checkpoint_path, model)
    # The eval step reads only the model; nothing here trains.
    options = compile_options_from(args)
    state = TrainState(model=model.eval(), optimizer=None, generator=None,
                       compiled=None if options is None else compile_model(model, options))
    eval_step = make_eval_step(mesh)
    cache = None
    if options is not None:
        cache = compile_cache_for(args.aot_cache, args.output_dir, {
            "cli": "evaluate", "compile_mode": options.mode, "compile_backend": options.backend,
            "base_channels": args.base_channels, "compute_dtype": "float32",
            "batch_size": args.batch_size, "height": args.height, "width": args.width,
            "ranks": mesh.world_size, "rank": mesh.rank, "spatial": mesh.spatial,
        }, device, verbose=is_main_process())
    if cache is not None:
        cache.load()
        eval_step = cache.wrap(eval_step, "eval step")

    loader = StereoSampleLoader(
        samples, image_size=(args.height, args.width),
        cache_root=args.cache_root, require_cache=args.require_cache,
    )
    fetch = loader_fetch(loader, num_workers=args.num_workers)
    put = cuda_put(device, lambda batch: pad_batch_to(batch, args.batch_size))
    if mesh.distributed:  # this rank's block of the global batch, padded
        fetch = MultihostBatcher(fetch, mesh, pad_to=args.batch_size)
        put = cuda_put(device)
    total: LossStats | None = None
    batches = prefetch_to_device(batch_iterator(fetch, len(loader), args.batch_size), put=put)
    for batch in batches:
        total = accumulate_stats(total, eval_step(state, batch))
    assert total is not None
    if cache is not None:
        cache.finish()
    metrics = metrics_from_stats(total)
    result = {
        "checkpoint": str(checkpoint_path),
        "checkpoint_epoch": int(ckpt_meta.get("epoch", -1)),
        "split": args.split,
        "samples": len(samples),
        "valid_pixels": int(total.valid_count),
        **{k: round(v, 6) for k, v in metrics.items()},
    }
    if cache is not None:
        result["compile_cache"] = cache.reports
    if is_main_process():
        print(json.dumps(result))
    return result


def main(argv: list[str] | None = None) -> dict[str, Any]:
    return evaluate(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
