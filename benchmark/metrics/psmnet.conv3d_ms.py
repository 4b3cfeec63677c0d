"""``psmnet.conv3d_ms``: device ms a PSMNet train step in the 3D stack's
convolution and transposed-convolution kernels, forward, dgrad and wgrad:
the ``conv`` kernels launched by an operator over 5-D tensors, from steps
profiled with their operators' shapes after the traced stretch (the kind's
``split``, ``traffic/train_psmnet_resident.py`` ``conv_ms``). cuDNN runs
some of the same kernels for the 2D extractor, so a kernel's name cannot
tell the two apart."""


def read(rec: dict) -> float | None:
    value = rec.get("split_ms", {}).get("conv3d")
    return value if value else None
