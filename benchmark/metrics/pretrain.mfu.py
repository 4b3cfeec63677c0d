"""``pretrain.mfu``: ``train.mfu`` at the window's ``pretrain_pairs_per_s``:
the whole train step's share of the card's dense peak in the training
dtype, 3x the forward's convolution FLOPs a pair."""

from benchmark import readers, roofline


def read(rec: dict) -> float | None:
    cfg = rec["cfg"]
    return readers.mfu(3 * cfg["forward_flops"], 1, 1.0 / rec["window"]["pretrain_pairs_per_s"],
                       roofline.PEAK_FLOPS[cfg["compute_dtype"]["train"]])
