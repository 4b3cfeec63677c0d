"""``live.preprocess_ms``: Median ms of scale, rectification and resize
(ops/remap.py, ops/resize.py), synchronised."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return rec["split_ms"]["preprocess"]
