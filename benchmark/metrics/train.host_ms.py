"""``train.host_ms``: host ms a train step in its gather and its step (spans
``train.gather`` and ``train.step``), traced, mean over the traced steps."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.mean_per_unit("train.step", ("train.gather", "train.step"), "host_ms")
