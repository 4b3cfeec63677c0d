"""``train.inductor_ms``: device ms a train step in the kernels Inductor
generated for the compiled model (the ``inductor triton`` group): its fused
elementwise work around the convolutions and the hand-written kernels."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "inductor triton")
