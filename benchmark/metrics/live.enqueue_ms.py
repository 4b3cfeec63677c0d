"""``live.enqueue_ms``: host ms a live frame in launching the rectify, resize
and forward (spans ``live.preprocess`` and ``live.forward``, no synchronise
between them), median over the traced frames."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.median_per_unit(
        "live.frame", ("live.preprocess", "live.forward"), "host_ms")
