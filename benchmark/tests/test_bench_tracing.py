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


def test_every_device_operation_keeps_its_seconds_and_count_by_name() -> None:
    """All names, not only the breakdown's ten longest, so a reader can sum a
    later model's kernels by name."""
    names = [f"kernel_{k}" for k in range(12)]
    device = [(100.0 * k, 100.0 * k + 10 + k, n) for k, n in enumerate(names)]
    device += [(2000.0, 2030.0, "kernel_3"), (2100.0, 2101.0, "triton_poi_fused_0")]
    rec = tracing.reduce(device, [], (0.0, 2200.0, "ProfilerStep#1"), 1.0, 1)
    assert rec["names_n"] == {**{n: 1 for n in names}, "kernel_3": 2, "triton_poi_fused_0": 1}
    assert rec["names_s"]["kernel_3"] == pytest.approx(43e-6)
    assert rec["names_s"]["kernel_0"] == pytest.approx(10e-6)
    assert sum(rec["names_s"].values()) == pytest.approx(sum(rec["groups_s"].values()))
    assert sum(rec["names_n"].values()) == sum(rec["groups_n"].values()) == 14
    assert len(rec["breakdown"]["device_ops"]) == 10
    assert rec["breakdown"]["device_ops"][0] == ["kernel_3", rec["names_s"]["kernel_3"]]


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


PRETRAIN = [m["name"] for m in BENCH["per_layer"] if m["name"].startswith("pretrain.")]


@pytest.mark.parametrize("name", PRETRAIN)
def test_a_pretrain_reader_reads_what_its_train_twin_reads(monkeypatch, name) -> None:
    """The train-96x128 cell reports its rate as ``pretrain_pairs_per_s``,
    and each ``pretrain.*`` reader reads its stage as ``train.*`` does, at
    that rate: on a device record and on a span store."""
    from benchmark import program_spans

    from .test_bench_program_spans import _train_store

    twin = "train." + name.split(".", 1)[1]
    rec = _train_record(8)
    rec["groups_s"].update({"BN1-BN4": 0.01, "optimizer": 0.0006})
    rate = rec["window"].pop("train_pairs_per_s")
    monkeypatch.setattr(program_spans, "store", _train_store)
    got = spec.reader(name)(dict(rec, window={"pretrain_pairs_per_s": rate}))
    want = spec.reader(twin)(dict(rec, window={"train_pairs_per_s": rate}))
    assert got is not None and got == pytest.approx(want)
