"""``live.flip_ms``: host ms a live frame in the upload's BGR to RGB flip on
the host (span ``live.upload.flip``), median over the traced frames."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.median_per_unit("live.frame", ("live.upload.flip",), "host_ms")
