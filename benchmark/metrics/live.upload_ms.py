"""``live.upload_ms``: Median ms of the live engine's upload (host flip,
pageable H2D), synchronised."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return rec["split_ms"]["upload"]
