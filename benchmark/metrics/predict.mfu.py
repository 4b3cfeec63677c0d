"""``predict.mfu``: The whole batch's share of the card's dense peak for
float32 serving: the forward's convolution FLOPs a pair at the window's
pairs/s."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.mfu(rec["cfg"]["forward_flops"], 1, 1.0 / rec["window"]["predict_pairs_per_s"], readers.serve_peak(rec))
