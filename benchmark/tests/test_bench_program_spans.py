"""The readers of the program's spans on a made-up store: None with no unit
span, or with no span store at all; else each unit's sum of its spans,
the mean over train steps and the median over live frames."""

from __future__ import annotations

import pytest

from benchmark import program_spans, spec
from stereo_depth_estimation_tpu_torch.spans import SpanRecord

from .conftest import BENCH, kind_of

SPAN_METRICS = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]


def _span(name, parent, start_ms, end_ms, device_ms=None) -> SpanRecord:
    start, end = int(start_ms * 1e6), int(end_ms * 1e6)
    return SpanRecord(name, parent, start, end, (end - start) * 1e-6, device_ms)


def _train_store() -> list[SpanRecord]:
    """Two steps, each after its gather; the second step's gate and noise
    take longer on the device."""
    out = []
    for k, t in enumerate((0.0, 100.0)):
        out += [_span("train.gather", None, t, t + 1),
                _span("train.step", None, t + 2, t + 42, 40.0),
                _span("train.augment", "train.step", t + 3, t + 5, 0.7 + k),
                _span("train.augment.noise", "train.augment", t + 4, t + 5, 0.5 + k),
                _span("train.gate.snapshot", "train.step", t + 6, t + 8, 2.0 + k),
                _span("train.forward", "train.step", t + 8, t + 20, 15.0),
                _span("train.gate.select", "train.step", t + 30, t + 41, 3.0 + k)]
    return sorted(out, key=lambda r: r.start_ns)


def _live_store() -> list[SpanRecord]:
    out = []
    for k, t in enumerate((0.0, 10.0, 20.0)):
        out += [_span("live.frame", None, t, t + 9),
                _span("live.upload", "live.frame", t, t + 3),
                _span("live.upload.flip", "live.upload", t, t + 1 + k),
                _span("live.preprocess", "live.frame", t + 3, t + 4),
                _span("live.forward", "live.frame", t + 4, t + 5 + k),
                _span("live.download", "live.frame", t + 6, t + 8.5 - k)]
    return out


def test_each_unit_sums_its_spans_and_a_span_before_a_step_counts_in_it() -> None:
    store = _train_store()
    gate = ("train.gate.snapshot", "train.gate.select")
    assert program_spans.per_unit(store, "train.step", gate, "device_ms") == [5.0, 7.0]
    host = program_spans.per_unit(store, "train.step", ("train.gather", "train.step"), "host_ms")
    assert host == pytest.approx([41.0, 41.0])
    assert program_spans.per_unit(store, "train.step", gate, "host_ms") == pytest.approx(
        [13.0, 13.0])
    assert program_spans.per_unit(store, "live.frame", gate, "host_ms") is None
    # A span with no device time (off the card) gives no device number.
    cpu = [r._replace(device_ms=None) for r in store]
    assert program_spans.per_unit(cpu, "train.step", gate, "device_ms") is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_reader_finds_nothing_without_spans(monkeypatch, name) -> None:
    monkeypatch.setattr(program_spans, "store", lambda: None)  # a program without spans
    assert spec.reader(name)({}) is None
    monkeypatch.setattr(program_spans, "store", lambda: [])  # spans, but none recorded
    assert spec.reader(name)({}) is None


def test_the_span_readers_take_the_mean_step_and_the_median_frame(monkeypatch) -> None:
    monkeypatch.setattr(program_spans, "store", _train_store)
    assert spec.reader("train.gate_ms")({}) == pytest.approx(6.0)
    assert spec.reader("train.augment_ms")({}) == pytest.approx(1.2)
    assert spec.reader("train.noise_ms")({}) == pytest.approx(1.0)
    assert spec.reader("train.host_ms")({}) == pytest.approx(41.0)
    assert spec.reader("live.flip_ms")({}) is None
    monkeypatch.setattr(program_spans, "store", _live_store)
    assert spec.reader("live.flip_ms")({}) == pytest.approx(2.0)
    assert spec.reader("live.enqueue_ms")({}) == pytest.approx(3.0)  # 2, 3, 4
    assert spec.reader("live.download_ms")({}) == pytest.approx(1.5)  # 2.5, 1.5, 0.5
    assert spec.reader("train.gate_ms")({}) is None


def test_the_span_metrics_are_listed_by_cells_whose_kind_records_a_unit() -> None:
    """The seven span metrics read above are entries, and every span metric
    is listed only by cells whose kind records a unit span."""
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"}
    assert {"train.gate_ms", "train.augment_ms", "train.noise_ms", "train.host_ms",
            "live.flip_ms", "live.enqueue_ms", "live.download_ms"} <= set(entries)
    for name, m in entries.items():
        assert m["unit"] == "ms" and m["better"] == "lower"
        for cell in m["workloads"]:
            assert kind_of(cell).SPAN_UNIT is not None, (name, cell)
