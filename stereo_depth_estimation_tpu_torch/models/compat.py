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

``rescale_resolution_transfer`` moves a trained model to a wider input, on
the port's state dict.
"""

from __future__ import annotations

import math
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
    unexpected_keys); missing counts the StereoUNet's keys, or another
    network's (PSMNet's) own. Missing entries (e.g. a checkpoint without a
    logvar head) keep their current values. A shape mismatch raises."""
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
    expected = torch_key_map()
    if not any(k in own for k in expected):  # another network (PSMNet): its own keys
        expected = own
    missing = [k for k in expected if k not in mapped]
    return missing, unexpected


def rescale_resolution_transfer(
    state_dict: Mapping[str, torch.Tensor], width_ratio: float
) -> dict[str, torch.Tensor]:
    """Adapt a trained StereoUNet's state dict to a ``width_ratio``-times
    wider input: JAX ``models/compat.py::rescale_resolution_transfer`` on the
    port's reference names.

    Disparity scales with image width, so a model trained at one width
    predicts means ``width_ratio`` times too small at a wider one, and
    Laplace scales ``b`` that much too tight. This multiplies
    ``disparity_head.weight`` and ``disparity_head.bias`` (the pre-softplus
    output: exact where softplus is linear, disparity above ~1 px) by the
    ratio and adds ``log(width_ratio)`` to ``logvar_head.bias`` (b' = ratio *
    b). Every other entry is returned as it is: the model is fully
    convolutional. The JAX package's docs/CONVERGENCE.md section 4 records
    what it buys: a 96x128 pretrain moved to 240x320 with it reached val MAE
    2.56 from 5.18 in 12 epochs, and stalled near 9 without it."""
    if width_ratio <= 0:
        raise ValueError(f"width_ratio must be positive, got {width_ratio}")
    for head in ("disparity_head", "logvar_head"):
        if f"{head}.weight" not in state_dict or f"{head}.bias" not in state_dict:
            raise ValueError(f"the state dict has no '{head}' -- not a StereoUNet's? "
                             f"(keys: {sorted(state_dict)[:6]} ...)")
    out = dict(state_dict)
    for key in ("disparity_head.weight", "disparity_head.bias"):
        out[key] = state_dict[key] * width_ratio
    out["logvar_head.bias"] = state_dict["logvar_head.bias"] + math.log(width_ratio)
    return out
