"""``live.download_ms``: host ms a live frame in the download (span
``live.download``: the wait for the frame's device work, the copies to the
host, numpy), median over the traced frames."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.median_per_unit("live.frame", ("live.download",), "host_ms")
