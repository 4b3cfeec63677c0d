"""Rescale a trained checkpoint for transfer to a different resolution.

Counterpart of ``scripts/rescale_transfer.py``:

    python -m stereo_depth_estimation_tpu_torch.scripts.rescale_transfer \\
        --checkpoint outputs/<run>/checkpoints/best.pt \\
        --from-width 128 --to-width 320 --out <dir>

Progressive-resolution workflow (``docs/CONVERGENCE.md`` section 4):
pretrain at a small resolution (cheap epochs), then finetune at full
resolution from the pretrained weights. The finetune must start from a
head-rescaled checkpoint: disparity scales with image width, and without
the rescale the Laplace NLL inflates the log-variance instead of rescaling
the mean, and the finetune stalls. This CLI applies
``models.compat.rescale_resolution_transfer`` and writes
``<out>/rescaled.pt`` for the trainer's ``--init-checkpoint``: the source's
weights and BatchNorm statistics (heads rescaled), its epoch, and a config
that records the ratio and the source. The JAX CLI writes an Orbax
directory; this one writes the port's ``.pt``. It rewrites a state dict and
computes nothing, so it runs on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..models.compat import rescale_resolution_transfer
from ..models.unet import StereoUNet
from ..parallel.train_step import create_train_state, make_adamw
from ..training.checkpoint import (
    load_model_variables,
    resolve_checkpoint_path,
    save_checkpoint,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", type=Path, required=True,
                        help="Source checkpoint: a .pt, or a run's checkpoints "
                             "directory (its best.pt).")
    parser.add_argument("--from-width", type=int, required=True,
                        help="Training image width of the source checkpoint.")
    parser.add_argument("--to-width", type=int, required=True,
                        help="Image width the finetune will train at.")
    parser.add_argument("--out", type=Path, required=True,
                        help="Output directory; checkpoint written at "
                             "<out>/rescaled.pt.")
    parser.add_argument("--base-channels", type=int, default=32,
                        help="UNet width; must match the checkpoint's.")
    return parser


def main(argv: list[str] | None = None) -> Path:
    args = build_parser().parse_args(argv)
    source = args.checkpoint
    if source.is_dir():  # outputs/<run>/checkpoints
        source = resolve_checkpoint_path(
            source.parent.parent, run_id=source.parent.name, checkpoint_name="best")

    ratio = args.to_width / args.from_width
    model = StereoUNet(base_channels=args.base_channels, device="cpu")
    loaded = load_model_variables(source, model)
    if loaded["missing_keys"] or loaded["unexpected_keys"]:
        raise ValueError(
            f"{source} does not match a base-{args.base_channels} StereoUNet: "
            f"missing {loaded['missing_keys']}, unexpected {loaded['unexpected_keys']}")
    model.load_state_dict(rescale_resolution_transfer(model.state_dict(), ratio))
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4))
    target = save_checkpoint(
        args.out, "rescaled", state,
        epoch=loaded["epoch"],
        config={"rescale_width_ratio": ratio, "source_checkpoint": str(args.checkpoint)},
        metrics={},
    )
    print(f"Wrote width-rescaled (x{ratio:g}) checkpoint to {target}")
    return target


if __name__ == "__main__":
    main()
