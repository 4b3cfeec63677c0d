"""``train.k1_roofline``: K1's share of its byte roofline: the uint8 batch in,
the augmented batch out in the training dtype, the factor rows in, over K1's
device time."""

from benchmark import readers, roofline


def read(rec: dict) -> float | None:
    n, t = rec["groups_n"].get("K1 augment", 0), rec["groups_s"].get("K1 augment", 0.0)
    if not n:
        return None
    cfg, mix = rec["cfg"], rec["mix"]
    nbytes = n * roofline.k1_bytes(mix["batch"], cfg["height"], cfg["width"],
                                   readers.itemsize(cfg["compute_dtype"]["train"]))
    return readers.bytes_share(nbytes, t)
