"""The frozen arithmetic: the FLOP count of a forward against forward hooks on
the port's own convolutions, and the byte counts against the kernel table's
bounds (``PERF.md``)."""

from __future__ import annotations

import pytest
import torch
from torch import nn

from benchmark import roofline, spec
from benchmark.reference.unet import conv_macs

BENCH = spec.benchmark()


def _hooked_macs(model: nn.Module, x: torch.Tensor) -> int:
    total = 0

    def hook(module, inputs, output):
        nonlocal total
        k = module.kernel_size[0] * module.kernel_size[1]
        if isinstance(module, nn.ConvTranspose2d):
            total += inputs[0].numel() // inputs[0].shape[1] * module.in_channels \
                * module.out_channels * k
        else:
            total += output.numel() * module.in_channels * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        model(x, return_uncertainty=True)
    for h in handles:
        h.remove()
    return total


def test_forward_flops_of_the_base_32_model_at_240x320_match_hooks_on_the_port() -> None:
    from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet, count_params

    cfg = spec.config(BENCH, "stereounet-b32-240x320")
    model = StereoUNet(base_channels=32, device="cpu").eval()
    assert count_params(model) == cfg["parameters"]
    macs = _hooked_macs(model, torch.rand(1, 240, 320, 6))
    assert macs == conv_macs(32, 240, 320) == 14_214_758_400
    assert roofline.forward_flops(cfg) == cfg["forward_flops"] == 2 * macs
    assert round(cfg["forward_flops"] / 1e9, 2) == 28.43


@pytest.mark.parametrize("hw", [(96, 128), (32, 48)])
def test_forward_flops_at_other_sizes_match_hooks(hw) -> None:
    from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet

    model = StereoUNet(base_channels=8, device="cpu").eval()
    assert _hooked_macs(model, torch.rand(2, *hw, 6)) == 2 * conv_macs(8, *hw)
    if hw == (96, 128):
        cfg = spec.config(BENCH, "stereounet-b32-96x128")
        assert roofline.forward_flops(cfg) == cfg["forward_flops"]
        assert round(cfg["forward_flops"] / 1e9, 2) == 4.55


def test_a_train_step_is_three_forwards() -> None:
    cfg = spec.config(BENCH, "stereounet-b32-240x320")
    assert round(roofline.train_step_flops(cfg, 128) / 1e12, 2) == 10.92


def _us(nbytes: int) -> float:
    return round(nbytes / roofline.HBM_BYTES_PER_S * 1e6, 1)


def test_byte_counts_reproduce_the_kernel_tables_bounds() -> None:
    cfg = spec.config(BENCH, "stereounet-b32-240x320")
    assert _us(roofline.k1_bytes(128, 240, 320, 2)) == 52.8
    assert _us(roofline.pool_forward_bytes(cfg, 128, 2)) == 484.2
    assert _us(roofline.pool_forward_bytes(cfg, 30, 4)) == 216.6
    assert round(roofline.pool_forward_bytes(cfg, 30, 4) / 1e6, 1) == 725.8
    assert _us(roofline.pool_forward_bytes(cfg, 1, 4)) == 7.2
    assert round(roofline.pool_forward_bytes(cfg, 1, 4) / 1e6, 1) == 24.2
