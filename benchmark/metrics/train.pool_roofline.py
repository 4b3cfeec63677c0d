"""``train.pool_roofline``: K2 and K3 over the four pool levels: their bytes
over their summed device time, as a share of the byte roofline."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.pool_share(rec, rec["mix"]["batch"], rec["cfg"]["compute_dtype"]["train"], backward=True)
