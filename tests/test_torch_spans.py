"""The port's spans (``stereo_depth_estimation_tpu_torch/spans.py``) on the
CPU: off unless a ``torch.profiler`` capture records, one ``train.step``
with its stages in order per traced step, the live engine's stages under
``live.frame``, each span a user-annotation row of the capture, and no span
in code that ``torch.compile`` traces."""

import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from stereo_depth_estimation_tpu_torch import spans
from stereo_depth_estimation_tpu_torch.live.depth_live_dl import LiveDepthEngine
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
from stereo_depth_estimation_tpu_torch.parallel import train_step as P

PORT = Path(__file__).resolve().parent.parent / "stereo_depth_estimation_tpu_torch"
BASE = 4
HW = (32, 48)
TRAIN_ORDER = ["train.gather", "train.step", "train.augment", "train.augment.noise",
               "train.gate.snapshot", "train.forward", "train.loss", "train.backward",
               "train.optimizer", "train.gate.select"]
LIVE_ORDER = ["live.frame", "live.upload", "live.upload.flip", "live.upload.flip",
              "live.preprocess", "live.forward", "live.download"]


@pytest.fixture(autouse=True)
def empty_store():
    spans.reset()
    yield
    spans.reset()


def _device_step(batch: int = 2, pairs: int = 4) -> tuple[P.TrainState, P.DeviceDataTrainStep]:
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (pairs, *HW, 6), dtype=torch.uint8, generator=g)
    targets = torch.rand((pairs, *HW), generator=g) * 8.0
    model = StereoUNet(base_channels=BASE, device="cpu")
    state = P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    step = P.make_device_data_train_step(images, targets, batch, AugmentConfig(impl="plain"))
    return state, step


def _traced_train_steps(active_steps: int):
    """One warm-up step, then ``active_steps`` active steps, under a CPU
    capture with the benchmark's schedule: the capture, the spans and the
    Unix ns at which the capture's clock starts."""
    state, step = _device_step()
    starts = []
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True, on_trace_ready=lambda p: starts.append(
                     p.profiler.kineto_results.trace_start_ns())) as prof:
        state, _ = step(state)
        prof.step()
        for _ in range(active_steps):
            state, _ = step(state)
        prof.step()
    return prof, spans.records(), starts[0]


def test_off_a_span_is_the_shared_noop_and_records_nothing() -> None:
    assert not torch.autograd._profiler_enabled()
    assert spans.span("train.step") is spans.OFF
    with spans.span("train.step"):
        pass
    state, step = _device_step()
    step(state)
    assert spans.records() == [] and spans.dropped() == 0


def test_a_traced_train_step_records_its_stages_in_order() -> None:
    _, records, _ = _traced_train_steps(active_steps=2)
    assert [r.name for r in records] == TRAIN_ORDER * 2  # none from the warm-up step
    parents = {r.name: r.parent for r in records}
    assert parents["train.gather"] is None and parents["train.step"] is None
    assert parents["train.augment.noise"] == "train.augment"
    assert {parents[n] for n in TRAIN_ORDER[2:] if n != "train.augment.noise"} == {"train.step"}
    steps = [r for r in records if r.name == "train.step"]
    for r in records:
        assert r.start_ns <= r.end_ns and r.host_ms == pytest.approx((r.end_ns - r.start_ns) / 1e6)
        assert r.device_ms is None  # no CUDA event on the CPU
        if r.parent is not None:
            assert any(s.start_ns <= r.start_ns and r.end_ns <= s.end_ns for s in steps)


def test_each_span_is_a_user_annotation_row_holding_its_host_interval() -> None:
    """The capture's clock (Unix time, as the profiler converts its own) and
    ``perf_counter_ns`` differ by an offset known to a few microseconds, less
    than a span's margins: so the test asks for one offset, near the one
    measured, under which every row holds its span's host interval."""
    offset_ns = time.time_ns() - time.perf_counter_ns()
    prof, records, t0_ns = _traced_train_steps(active_steps=1)
    rows = {}
    for e in prof.events():
        if e.name in TRAIN_ORDER:
            rows.setdefault(e.name, []).append(e)
    assert sorted(rows) == sorted(TRAIN_ORDER)
    latest, earliest = -float("inf"), float("inf")  # bounds on the shift of the rows
    for r in records:
        (row,) = rows[r.name]
        assert row.is_user_annotation
        start = t0_ns + row.time_range.start * 1e3 - offset_ns
        end = t0_ns + row.time_range.end * 1e3 - offset_ns
        assert end - start >= r.end_ns - r.start_ns, r.name
        earliest = min(earliest, r.start_ns - start)
        latest = max(latest, r.end_ns - end)
    assert latest <= earliest and abs(0.5 * (latest + earliest)) < 1e6


def test_a_live_frame_records_its_stages() -> None:
    engine = LiveDepthEngine((HW[1], HW[0]), None, device="cpu", base_channels=BASE)
    rng = np.random.default_rng(0)
    left, right = (rng.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2))
    engine.process(left, right)
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        out = engine.process(left, right)
    records = spans.records()
    assert [r.name for r in records] == LIVE_ORDER
    parents = {r.name: r.parent for r in records}
    assert parents == {"live.frame": None, "live.upload": "live.frame",
                       "live.upload.flip": "live.upload", "live.preprocess": "live.frame",
                       "live.forward": "live.frame", "live.download": "live.frame"}
    assert out[0].shape == HW and out[2].shape == (*HW, 3)


def test_a_full_store_counts_what_it_drops(monkeypatch) -> None:
    monkeypatch.setattr(spans, "CAPACITY", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with spans.span(name):
                pass
    assert [r.name for r in spans.records()] == ["a", "b"] and spans.dropped() == 1
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0


def test_spans_set_aside_leave_the_store_as_it_was() -> None:
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("kept"):
            pass
        with spans.set_aside():
            with spans.span("aside"):
                pass
        with spans.span("after"):
            pass
    assert [r.name for r in spans.records()] == ["kept", "after"] and spans.dropped() == 0


def _span_calls(path: Path, cls: str, methods: set[str]) -> dict[str, int]:
    """Calls of ``span`` in each of ``cls``'s ``methods``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    (node,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls]
    found = {}
    for fn in node.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in methods:
            found[fn.name] = sum(
                isinstance(c, ast.Call) and (getattr(c.func, "id", None) == "span"
                                             or getattr(c.func, "attr", None) == "span")
                for c in ast.walk(fn))
    assert set(found) == methods
    return found


def test_no_span_sits_in_code_that_torch_compile_traces() -> None:
    live = _span_calls(PORT / "live" / "depth_live_dl.py", "LiveDepthEngine",
                       {"_frame", "_preprocess", "_forward", "preprocess", "forward"})
    assert live == {"_frame": 0, "_preprocess": 0, "_forward": 0, "preprocess": 1, "forward": 1}
    assert _span_calls(PORT / "models" / "unet.py", "StereoUNet", {"forward"}) == {"forward": 0}
