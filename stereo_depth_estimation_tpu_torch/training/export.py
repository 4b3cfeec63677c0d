"""``foundation-stereo-export``: write the reference trainer's ``.pt`` payload.

Counterpart of ``stereo_depth_estimation_tpu/training/export.py``, with the
same flags:

    python -m stereo_depth_estimation_tpu_torch.training.export \\
        --checkpoint <last.pt> --out <model.pt>

The port's checkpoints already are the reference's ``.pt`` format, with
resume state beside the weights. The export keeps what the reference trainer
saves, ``epoch``, ``model_state_dict``, ``config`` and ``metrics``, and drops
the optimizer and generator state. Its source is a port ``.pt`` or a bare
state dict; the weights are loaded into a StereoUNet of ``--base-channels``
first, so every key and shape is checked. Orbax directories, which the JAX
package writes, are not read (ROADMAP Queue 3). The weights pass through the
CPU: the export computes nothing.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..models.unet import StereoUNet
from .checkpoint import load_checkpoint_meta, load_model_variables, resolve_checkpoint_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Write a reference-format PyTorch .pt file (weights, epoch, "
                    "config, metrics) from a checkpoint."
    )
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="A .pt checkpoint (outputs/<run>/checkpoints/last.pt) "
                             "or a bare state dict.")
    parser.add_argument("--run-id", type=str, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    parser.add_argument("--checkpoint-name", type=str, default="last")
    parser.add_argument("--base-channels", type=int, default=32,
                        help="UNet width; must match the checkpoint's.")
    parser.add_argument("--out", type=Path, required=True,
                        help="Destination .pt path.")
    return parser


def export_checkpoint(args: argparse.Namespace) -> Path:
    checkpoint_path = resolve_checkpoint_path(
        args.output_dir, checkpoint=args.checkpoint, run_id=args.run_id,
        checkpoint_name=args.checkpoint_name,
    )
    model = StereoUNet(base_channels=args.base_channels, device="cpu")
    loaded = load_model_variables(checkpoint_path, model)
    if loaded["missing_keys"] or loaded["unexpected_keys"]:
        raise ValueError(
            f"{checkpoint_path} does not match a base-{args.base_channels} StereoUNet: "
            f"missing {loaded['missing_keys']}, unexpected {loaded['unexpected_keys']}"
        )
    meta = load_checkpoint_meta(checkpoint_path)
    state_dict = model.state_dict()
    payload = {
        "epoch": loaded["epoch"],
        "model_state_dict": state_dict,
        "config": meta.get("config") or {},
        "metrics": meta.get("metrics") or {},
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, args.out)
    print(f"Wrote reference-format checkpoint: {args.out} "
          f"(epoch {payload['epoch']}, {len(state_dict)} tensors)")
    return args.out


def main(argv: list[str] | None = None) -> Path:
    return export_checkpoint(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
