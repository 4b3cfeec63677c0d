"""Named spans over the stages of the port's train step and live engine.

``with span("train.forward"): ...`` marks a stage. A span records only
while a ``torch.profiler`` capture is recording
(``torch.autograd._profiler_enabled()``): the trainer's ``--profile-dir``
capture (``training/profiling.py``) or any capture a caller opens around
the port's calls. A schedule's wait and warm-up steps do not record. With
no capture recording, ``span`` returns the shared no-op ``OFF`` and costs
that one check.

Recording, a span
- is a ``torch.profiler.record_function`` range, so it is a row of the
  capture, on the clock of the capture's device rows;
- takes ``time.perf_counter_ns()`` at entry and at exit, inside that range;
- in a process that has initialised CUDA, records a timing
  ``torch.cuda.Event`` on the current stream at entry and at exit.

A finished span goes into an in-memory store of at most ``CAPACITY``
spans; past that, spans are counted (``dropped()``) and not kept.
``records()`` returns the store as ``SpanRecord``s in the order the spans
started:

- ``name``: the span's name;
- ``parent``: the name of the span open around it, or None;
- ``start_ns``, ``end_ns``: ``time.perf_counter_ns()`` at entry and exit;
- ``host_ms``: their difference in milliseconds;
- ``device_ms``: milliseconds between the two events on the stream, the
  stage's length on the device's timeline (the device's idle time between
  the stage's launches included); None where no event was recorded.

``reset()`` empties the store; inside ``set_aside()`` spans record as
ever and are then dropped, so a capture that is not a reading (one with
operator shapes, say) leaves the store as it found it. No span sits in code that ``torch.compile``
traces: the compiled programs run inside a span, never around one.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

CAPACITY = 16384
OFF = contextlib.nullcontext()

_open: list[_Span] = []
_store: list[tuple] = []
_dropped = 0


class SpanRecord(NamedTuple):
    name: str
    parent: str | None
    start_ns: int
    end_ns: int
    host_ms: float
    device_ms: float | None


class _Span:
    __slots__ = ("name", "parent", "_range", "_events", "_start_ns")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> _Span:
        self.parent = _open[-1].name if _open else None
        _open.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._events = None
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        _open.pop()
        if len(_store) < CAPACITY:
            _store.append(
                (self.name, self.parent, self._start_ns, end_ns, self._events))
        else:
            _dropped += 1
        return False


def span(name: str):
    """A context manager over one stage: ``OFF`` unless a capture records."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _Span(name)


def records() -> list[SpanRecord]:
    """The stored spans, by start; synchronises first where any recorded
    device events."""
    if any(events is not None for *_, events in _store):
        torch.cuda.synchronize()
    out = [SpanRecord(name, parent, start, end, (end - start) * 1e-6,
                      None if events is None else events[0].elapsed_time(events[1]))
           for name, parent, start, end, events in _store]
    return sorted(out, key=lambda r: r.start_ns)


def dropped() -> int:
    """Spans finished while the store was full."""
    return _dropped


def reset() -> None:
    """Empties the store and the count of dropped spans."""
    global _dropped
    _store.clear()
    _dropped = 0


@contextlib.contextmanager
def set_aside():
    """Spans finished inside are not kept: the store and the count of dropped
    spans come out as they went in."""
    global _dropped
    kept, dropped_before = list(_store), _dropped
    try:
        yield
    finally:
        _store[:] = kept
        _dropped = dropped_before
