"""``psmnet.regression_ms``: device ms a PSMNet train step in the forward's
regression (span ``psmnet.regression``: the trilinear upsampling, softmax
and soft-argmin of the three outputs, float32), mean over the traced
steps."""

from benchmark import program_spans


def read(rec: dict) -> float | None:
    return program_spans.mean_per_unit("train.step", ("psmnet.regression",), "device_ms")
