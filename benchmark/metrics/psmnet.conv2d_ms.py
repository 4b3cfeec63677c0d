"""``psmnet.conv2d_ms``: device ms a PSMNet train step in the 2D feature
extractor's convolution kernels, both views, forward, dgrad and wgrad: the
``conv`` kernels launched by an operator over 4-D tensors (as
``psmnet.conv3d_ms``)."""


def read(rec: dict) -> float | None:
    value = rec.get("split_ms", {}).get("conv2d")
    return value if value else None
