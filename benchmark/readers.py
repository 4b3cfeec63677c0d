"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. Each takes
the record of a traced run (``harness.trace_record``) and returns the
metric, or None where the record holds nothing to read."""

from __future__ import annotations

from . import roofline


def group_ms(rec: dict, *groups: str) -> float | None:
    """Device milliseconds a unit of the named kernel groups."""
    seconds = sum(rec["groups_s"].get(g, 0.0) for g in groups)
    return 1e3 * seconds / rec["units"] if seconds > 0 else None


def idle_pct(rec: dict) -> float:
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def serve_peak(rec: dict) -> float:
    """The card's dense peak for the configuration's float32 serving: TF32
    where cuDNN may use it (PyTorch's default), else plain float32."""
    return roofline.PEAK_FLOPS["tf32" if rec["tf32"] else "float32"]


def itemsize(dtype_name: str) -> int:
    return {"bfloat16": 2, "float32": 4}[dtype_name]


def mfu(flops_per_unit: float, units: int, seconds: float, peak: float) -> float:
    return 100.0 * flops_per_unit * units / seconds / peak


def bytes_share(nbytes: float, seconds: float) -> float | None:
    """Percent of the byte roofline: the bytes at the card's bandwidth over
    the kernels' device time."""
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / seconds if seconds > 0 else None


def pool_share(rec: dict, batch: int, dtype_name: str, backward: bool) -> float | None:
    """K2 (and K3) over the model's four pool levels, a unit each: their
    bytes over their summed device time. None unless every unit ran its
    four levels."""
    groups = ["K2 max pool fwd"] + (["K3 max pool bwd"] if backward else [])
    if any(rec["groups_n"].get(g, 0) != 4 * rec["units"] for g in groups):
        return None
    nbytes = len(groups) * rec["units"] * roofline.pool_forward_bytes(
        rec["cfg"], batch, itemsize(dtype_name))
    return bytes_share(nbytes, sum(rec["groups_s"][g] for g in groups))
