"""``live.mfu``: The whole frame's share of the card's dense peak for float32
serving: the forward's convolution FLOPs over the window's mean frame time."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.mfu(rec["cfg"]["forward_flops"], rec["window_units"], rec["window_elapsed_s"],
                       readers.serve_peak(rec))
