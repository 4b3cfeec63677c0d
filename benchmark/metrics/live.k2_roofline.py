"""``live.k2_roofline``: K2 in float32 at batch 1 over the four pool levels:
bytes over device time, as a share of the byte roofline."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.pool_share(rec, 1, rec["cfg"]["compute_dtype"]["serve"], backward=False)
