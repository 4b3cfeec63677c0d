"""Checkpoints in the reference's ``.pt`` format, with full resume.

Counterpart of ``stereo_depth_estimation_tpu/training/checkpoint.py``. The JAX
package writes Orbax directories; the port writes what the reference trainer
writes: ``checkpoints/last.pt`` every epoch and ``best.pt`` on a new best val
MAE, each a ``torch.save`` dict of

- ``epoch``, ``model_state_dict`` (reference parameter names),
  ``optimizer_state_dict`` (``torch.optim.AdamW.state_dict()``), ``config``
  and ``metrics`` (the epoch's metrics; in ``last.pt`` also the trainer's
  ``resume_carry``: global step, best val MAE and epoch, schedule horizon);
- ``generator_state``, the train state's ``torch.Generator``, and
  ``train_step``, its step counter, so a resumed run continues the random
  stream as the JAX ``TrainState`` carries its rng.

The JAX package's ``load_model_variables`` reads these files (it takes
``model_state_dict``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch

from ..models.compat import load_torch_state_dict
from ..parallel.train_step import TrainState


def save_checkpoint(
    checkpoint_dir: Path,
    name: str,
    state: TrainState,
    *,
    epoch: int,
    config: dict[str, Any],
    metrics: dict[str, Any],
) -> Path:
    """Write ``<checkpoint_dir>/<name>.pt``, atomically replacing any earlier
    checkpoint of that name."""
    target = Path(checkpoint_dir) / f"{name}.pt"
    target.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "epoch": epoch,
        "model_state_dict": state.model.state_dict(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "config": config,
        "metrics": metrics,
        "generator_state": state.generator.get_state(),
        "train_step": state.step,
    }
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return target


def _load(path: Path) -> dict[str, Any]:
    # weights_only=False: the payload holds the config and metrics dicts;
    # only files this trainer or the reference wrote are loaded.
    checkpoint = torch.load(Path(path), map_location="cpu", weights_only=False)
    if not isinstance(checkpoint, dict):
        raise ValueError(f"Unexpected checkpoint format in {path}.")
    return checkpoint


def load_checkpoint_meta(checkpoint_path: Path) -> dict[str, Any]:
    """epoch, config and metrics of a checkpoint."""
    checkpoint = _load(checkpoint_path)
    return {k: checkpoint.get(k) for k in ("epoch", "config", "metrics")}


def load_train_state(
    checkpoint_path: Path, state: TrainState
) -> tuple[TrainState, dict[str, Any]]:
    """Full resume, in place: weights and BatchNorm buffers, AdamW's moments
    and step counts, the generator and the train step counter. The optimizer
    state is copied into the state's own tensors, so their devices, and the
    learning-rate tensor the train step refreshes, stay as they are."""
    checkpoint = _load(checkpoint_path)
    missing, unexpected = load_torch_state_dict(state.model, checkpoint["model_state_dict"])
    if missing or unexpected:
        raise ValueError(
            f"{checkpoint_path} does not match the model: missing {missing}, "
            f"unexpected {unexpected}"
        )
    saved = checkpoint["optimizer_state_dict"]["state"]
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    if len(saved) != len(params):
        raise ValueError(
            f"{checkpoint_path} holds optimizer state for {len(saved)} "
            f"parameters, the model has {len(params)}"
        )
    with torch.no_grad():
        for i, p in enumerate(params):
            for key, tensor in state.optimizer.state[p].items():
                tensor.copy_(saved[i][key])
    state.generator.set_state(checkpoint["generator_state"])
    state.step = int(checkpoint["train_step"])
    return state, {k: checkpoint.get(k) for k in ("epoch", "config", "metrics")}


# A key only PSMNet's state_dict has (models/psmnet.py).
_PSMNET_KEY = "feature_extraction.firstconv.0.0.weight"


def load_model_variables(
    checkpoint_path: Path, model: torch.nn.Module
) -> dict[str, Any]:
    """Load the weights of a reference ``.pt``/``.pth`` (a training
    checkpoint with ``model_state_dict``, or a bare state_dict) into
    ``model`` in place; non-strict like the reference loader. Returns the
    checkpoint's epoch and the missing/unexpected keys."""
    path = Path(checkpoint_path)
    if not (path.is_file() and path.suffix in (".pt", ".pth")):
        raise FileNotFoundError(f"Not a .pt/.pth checkpoint: {path}")
    checkpoint = _load(path)
    state_dict = checkpoint.get("model_state_dict", checkpoint)
    if _PSMNET_KEY in state_dict and _PSMNET_KEY not in model.state_dict():
        raise ValueError(
            f"{path} is a PSMNet checkpoint (trained with --model psmnet); predict, "
            "evaluate, export, the live viewer and the rescale CLI serve the StereoUNet "
            "only, and serving PSMNet is not supported")
    missing, unexpected = load_torch_state_dict(model, state_dict)
    return {
        "epoch": int(checkpoint.get("epoch", -1)),
        "source": "torch",
        "missing_keys": missing,
        "unexpected_keys": unexpected,
        "has_uncertainty_head": "logvar_head.weight" in state_dict,
    }


def resolve_checkpoint_path(
    output_dir: Path,
    *,
    checkpoint: Path | None = None,
    run_id: str | None = None,
    checkpoint_name: str = "last",
) -> Path:
    """Explicit path > run-id > newest-mtime scan over outputs/*/checkpoints."""
    if checkpoint is not None:
        resolved = Path(checkpoint).expanduser().resolve()
        if not resolved.exists():
            raise FileNotFoundError(f"Checkpoint not found: {resolved}")
        return resolved

    output_dir = Path(output_dir).expanduser().resolve()
    filename = f"{checkpoint_name}.pt"
    if run_id:
        candidate = output_dir / run_id / "checkpoints" / filename
        if not candidate.exists():
            raise FileNotFoundError(f"Checkpoint not found: {candidate}")
        return candidate

    candidates: list[Path] = []
    if output_dir.exists():
        for run_dir in output_dir.iterdir():
            candidate = run_dir / "checkpoints" / filename
            if candidate.exists():
                candidates.append(candidate)
    if not candidates:
        raise FileNotFoundError(
            f"No checkpoint {filename} found under {output_dir}. "
            "Pass --checkpoint or --run-id."
        )
    return max(candidates, key=checkpoint_mtime_ns)


def checkpoint_mtime_ns(path: Path) -> int:
    return Path(path).stat().st_mtime_ns
