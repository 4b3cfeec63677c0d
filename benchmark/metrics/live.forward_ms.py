"""``live.forward_ms``: Median ms of the StereoUNet eval forward at batch 1 and
the uint8 views, synchronised."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return rec["split_ms"]["forward"]
