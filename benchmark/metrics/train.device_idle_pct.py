"""``train.device_idle_pct``: Share of the traced stretch in which no operation
ran on the device."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.idle_pct(rec)
