"""``train.gate_ms``: device ms a train step in the zero-valid gate, its
snapshot and its select (spans ``train.gate.snapshot`` and
``train.gate.select``), mean over the traced steps."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.mean_per_unit(
        "train.step", ("train.gate.snapshot", "train.gate.select"), "device_ms")
