"""A toy two-layer model as plain PyTorch functions: a 1x1 convolution from
``in_channels`` to ``hidden`` channels, ReLU, and a 1x1 convolution to one
output. It stands in for a new model in the benchmark's CPU tests, which
add it to a copy of the benchmark as new files and entries alone."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def parameter_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    c, h = cfg["in_channels"], cfg["hidden"]
    return {"layer1.weight": (h, c, 1, 1), "layer1.bias": (h,),
            "layer2.weight": (1, h, 1, 1), "layer2.bias": (1,)}


def forward_flops(cfg: dict) -> int:
    return 2 * cfg["height"] * cfg["width"] * cfg["hidden"] * (cfg["in_channels"] + 1)


def forward(p: dict[str, torch.Tensor], x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """x: (N, C, H, W) -> (N, H, W); ``"bf16"`` holds every operand in
    bfloat16 (the control)."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    w = {k: v.to(dtype) for k, v in p.items()}
    h = F.relu(F.conv2d(x.to(dtype), w["layer1.weight"], w["layer1.bias"]))
    return F.conv2d(h, w["layer2.weight"], w["layer2.bias"])[:, 0].float()
