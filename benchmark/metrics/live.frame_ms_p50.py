"""``live.frame_ms_p50``: The median host-clock latency of the traced run's
window frames (``LiveDepthEngine.process``, BGR in to numpy out). Bimodal on
the card (modes near 7 and 11 ms that switch within a run), so it stands
here beside ``live_frame_ms_p95`` and not as an end-to-end metric."""


def read(rec: dict) -> float | None:
    return rec["window"].get("live_frame_ms_p50")
