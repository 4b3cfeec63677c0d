"""``toy.batch_ms``: host ms a batch over the window."""


def read(rec: dict) -> float | None:
    units = rec.get("window_units")
    return 1e3 * rec["window_elapsed_s"] / units if units else None
