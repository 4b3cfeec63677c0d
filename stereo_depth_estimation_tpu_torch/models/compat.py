"""Checkpoint compatibility: key scheme, legacy renames, weight carry-over.

Counterpart of ``stereo_depth_estimation_tpu/models/compat.py``. The port's
``StereoUNet`` already uses the reference PyTorch parameter names, so a
reference ``.pt`` state_dict loads as it is, after two compatibility steps
the reference loader also takes:

- legacy single-head checkpoints name the disparity head ``output_head`` ->
  renamed to ``disparity_head``;
- a checkpoint without a ``logvar_head`` keeps the model's fresh one;
- loading is non-strict, returning (missing_keys, unexpected_keys).

``state_dict_from_jax`` carries the JAX package's variables across:
- flax Conv kernel (kH, kW, I, O)            -> Conv2d (O, I, kH, kW)
- flax ConvTranspose kernel (kH, kW, I, O)   -> ConvTranspose2d (I, O, kH, kW),
  spatially flipped (lax.conv_transpose is zero-insertion + correlation,
  torch's transposed conv the gradient of a correlation)
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# Blocks that contain two (conv, bn) pairs.
_CONV_BLOCKS = (
    "enc1", "enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3", "dec2", "dec1",
)
_UPS = ("up4", "up3", "up2", "up1")
_HEADS = ("disparity_head", "logvar_head")


def apply_legacy_renames(state_dict: dict[str, Any]) -> dict[str, Any]:
    """Rename legacy ``output_head.*`` -> ``disparity_head.*`` (non-destructive)."""
    mapped = dict(state_dict)
    if "output_head.weight" in mapped and "disparity_head.weight" not in mapped:
        mapped["disparity_head.weight"] = mapped.pop("output_head.weight")
    if "output_head.bias" in mapped and "disparity_head.bias" not in mapped:
        mapped["disparity_head.bias"] = mapped.pop("output_head.bias")
    return mapped


def torch_key_map() -> dict[str, tuple[str, ...]]:
    """torch state_dict key -> path into the JAX variables {'params'|'batch_stats', ...}."""
    mapping: dict[str, tuple[str, ...]] = {}
    for block in _CONV_BLOCKS:
        # Sequential indices: 0 conv, 1 bn, 3 conv, 4 bn (2/5 are ReLU).
        for i, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4))):
            mapping[f"{block}.block.{conv_idx}.weight"] = (
                "params", block, f"conv{i}", "kernel")
            mapping[f"{block}.block.{bn_idx}.weight"] = (
                "params", block, f"bn{i}", "scale")
            mapping[f"{block}.block.{bn_idx}.bias"] = (
                "params", block, f"bn{i}", "bias")
            mapping[f"{block}.block.{bn_idx}.running_mean"] = (
                "batch_stats", block, f"bn{i}", "mean")
            mapping[f"{block}.block.{bn_idx}.running_var"] = (
                "batch_stats", block, f"bn{i}", "var")
    for up in _UPS:
        mapping[f"{up}.weight"] = ("params", up, "kernel")
        mapping[f"{up}.bias"] = ("params", up, "bias")
    for head in _HEADS:
        mapping[f"{head}.weight"] = ("params", head, "kernel")
        mapping[f"{head}.bias"] = ("params", head, "bias")
    return mapping


def _is_up_weight(torch_key: str) -> bool:
    return torch_key.endswith(".weight") and torch_key.split(".")[0] in _UPS


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy-convertible leaves) -> the
    port's state_dict (float32 CPU tensors). Leaves absent from the tree are
    absent from the result."""
    out: dict[str, torch.Tensor] = {}
    for torch_key, path in torch_key_map().items():
        node: Any = variables
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                break
            node = node[key]
        else:
            value = np.asarray(node, dtype=np.float32)
            if _is_up_weight(torch_key):
                value = np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
            elif torch_key.endswith(".weight") and value.ndim == 4:
                value = np.transpose(value, (3, 2, 0, 1))
            out[torch_key] = torch.from_numpy(np.array(value, order="C"))  # owned copy
    return out


def load_torch_state_dict(
    model: nn.Module, state_dict: Mapping[str, Any]
) -> tuple[list[str], list[str]]:
    """Load a (possibly legacy) reference state_dict into ``model`` in place.

    Non-strict like the reference loader: returns (missing_keys,
    unexpected_keys). Missing entries (e.g. a checkpoint without a logvar
    head) keep their current values. A shape mismatch raises."""
    mapped = apply_legacy_renames(dict(state_dict))
    own = model.state_dict()
    unexpected = [k for k in mapped if k not in own]
    present = {k: v for k, v in mapped.items() if k in own}
    for key, value in present.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(
                f"Shape mismatch at {key}: expected {tuple(own[key].shape)}, "
                f"got {tuple(value.shape)}"
            )
    model.load_state_dict(present, strict=False)
    missing = [k for k in torch_key_map() if k not in mapped]
    return missing, unexpected
