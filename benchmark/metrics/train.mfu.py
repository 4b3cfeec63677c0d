"""``train.mfu``: The whole train step's share of the card's dense peak in the
training dtype: 3x the forward's convolution FLOPs a pair, at the window's
pairs/s."""

from benchmark import readers, roofline


def read(rec: dict) -> float | None:
    cfg = rec["cfg"]
    return readers.mfu(3 * cfg["forward_flops"], 1, 1.0 / rec["window"]["train_pairs_per_s"],
                       roofline.PEAK_FLOPS[cfg["compute_dtype"]["train"]])
