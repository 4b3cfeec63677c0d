"""``predict.transfer_ms``: Device ms of the host-device copies a batch
(profiler memcpy rows: the uint8 batch in, disparity and log-variance out)."""

from benchmark import readers


def read(rec: dict) -> float | None:
    return readers.group_ms(rec, "memcpy")
