"""The reduction of a traced stretch and the per-layer readers, on a made-up
record: busy time is the union of device operations, idle gaps go to the
innermost host operation open at their middle, and a reader that finds
nothing returns None."""

from __future__ import annotations

import pytest

from benchmark import roofline, spec, tracing

BENCH = spec.benchmark()


def test_busy_time_is_the_union_and_gaps_go_to_the_innermost_host_op() -> None:
    device = [(10.0, 30.0, "sm90_xmma_fprop_bf16"), (20.0, 40.0, "maxpool2x2_fwd_kernel"),
              (60.0, 70.0, "Memcpy HtoD (Pageable -> Device)")]
    host = [(0.0, 100.0, "aten::conv"), (42.0, 58.0, "cudaLaunchKernel")]
    rec = tracing.reduce(device, host, (0.0, 100.0, "ProfilerStep#1"), 1.0, 2)
    assert rec["busy_s"] == pytest.approx(40e-6)
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["groups_n"] == {"conv": 1, "K2 max pool fwd": 1, "memcpy": 1}
    idle = dict(rec["breakdown"]["idle_gaps"])
    assert idle["cudaLaunchKernel"] == pytest.approx(20e-6)
    assert idle["aten::conv"] == pytest.approx(40e-6)
    assert rec["breakdown"]["device_ops"][0][0] == "sm90_xmma_fprop_bf16"


def test_kernel_groups_name_the_ports_kernels() -> None:
    assert tracing.group_of("augment_kernel<true>") == "K1 augment"
    assert tracing.group_of("gray_means_kernel") == "augment gray means"
    assert tracing.group_of("maxpool2x2_bwd_kernel") == "K3 max pool bwd"
    assert tracing.group_of("batch_norm_collect_statistics_channels_last_kernel") == "batchnorm"
    assert tracing.group_of("triton_poi_fused_batch_norm_0") == "inductor triton"
    assert tracing.group_of("Memcpy DtoH (Device -> Pageable)") == "memcpy"


def _train_record(k2_count: int) -> dict:
    cfg = spec.config(BENCH, "stereounet-b32-240x320")
    mix = spec.mix("resident-b128")
    k2 = roofline.pool_forward_bytes(cfg, 128, 2) / roofline.HBM_BYTES_PER_S
    return {"units": 2, "busy_s": 0.19, "window_s": 0.2, "cfg": cfg, "mix": mix,
            "groups_s": {"K2 max pool fwd": 2 * k2 / 0.9, "K3 max pool bwd": 2 * k2 / 0.8,
                         "conv": 0.068, "K1 augment": 0.0002},
            "groups_n": {"K2 max pool fwd": k2_count, "K3 max pool bwd": 8, "conv": 300,
                         "K1 augment": 2},
            "window": {"train_pairs_per_s": 1300.0}, "tf32": True}


def test_the_readers_compute_their_shares() -> None:
    rec = _train_record(8)
    assert spec.reader("train.pool_roofline")(rec) == pytest.approx(100 / (1 / 0.9 + 1 / 0.8) * 2)
    assert spec.reader("train.conv_ms")(rec) == pytest.approx(34.0)
    assert spec.reader("train.device_idle_pct")(rec) == pytest.approx(5.0)
    assert spec.reader("train.mfu")(rec) == pytest.approx(
        100 * 3 * 28429516800 * 1300 / 989e12)
    assert 0 < spec.reader("train.k1_roofline")(rec) < 100


def test_a_reader_with_nothing_to_read_returns_none() -> None:
    rec = _train_record(7)  # a pool level missing: no share
    assert spec.reader("train.pool_roofline")(rec) is None
    assert spec.reader("train.optimizer_ms")(rec) is None
    rec["groups_n"].pop("K1 augment")
    assert spec.reader("train.k1_roofline")(rec) is None
