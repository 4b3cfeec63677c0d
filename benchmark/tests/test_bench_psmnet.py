"""The PSMNet cell's own readers, on made-up profiler events: its traffic
kind sorts each convolution kernel by the rank of the operator that
launched it, and ``psmnet.conv3d_ms`` / ``psmnet.conv2d_ms`` read the sums."""

from __future__ import annotations

import pytest

from benchmark import spec


def test_psmnet_convolutions_go_by_the_rank_of_the_operator_that_launched_them() -> None:
    """cuDNN runs some of the same kernels for 2D and 3D convolutions: the
    PSMNet kind's split sorts each ``conv`` kernel by its operator's shapes,
    and ``psmnet.conv3d_ms`` / ``psmnet.conv2d_ms`` read the sums a step."""
    from types import SimpleNamespace as Event

    from benchmark.traffic import train_psmnet_resident

    def op(shapes, *kernels):
        return Event(input_shapes=shapes,
                     kernels=[Event(name=n, duration=us) for n, us in kernels])

    shared = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
    events = [
        op([[2, 64, 48, 64, 128], [64, 64, 3, 3, 3], [], []], (shared, 3000.0)),
        op([[2, 64, 48, 64, 128], [2, 64, 48, 64, 128], [64, 64, 3, 3, 3]],
           ("sm80_xmma_wgrad_implicit_gemm_indexed", 1000.0), ("bn_stats_partial", 50.0)),
        op([[2, 32, 128, 256], [32, 32, 3, 3], []], (shared, 400.0)),
        op([[2, 32, 128, 256]], ("bn_relu_fwd", 80.0)),
        op([], ("Memset (Device)", 5.0)),
    ]
    split = train_psmnet_resident.conv_ms(events, 2)
    assert split == pytest.approx({"conv3d": 2.0, "conv2d": 0.2})
    rec = {"split_ms": split}
    assert spec.reader("psmnet.conv3d_ms")(rec) == pytest.approx(2.0)
    assert spec.reader("psmnet.conv2d_ms")(rec) == pytest.approx(0.2)
    assert spec.reader("psmnet.conv3d_ms")({}) is None
