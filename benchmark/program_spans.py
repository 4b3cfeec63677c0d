"""What the readers of the program's spans share (``metrics/<name>.py`` with
``"source": "program_span"``). The port keeps its spans in memory
(``stereo_depth_estimation_tpu_torch/spans.py``) while a ``torch.profiler``
capture records: in a ``--trace 1`` run, exactly the traced stretch's
active units. A program without that module, or a store with no unit span,
gives None.

A unit is one span of the unit's name (``train.step``, ``live.frame``).
Each other span counts in the unit whose host interval holds it, or else
in the first unit that starts after it ends (``train.gather`` runs before
its step); a metric's value for a unit is the sum over the unit's spans of
the named ones."""

from __future__ import annotations

import bisect
import statistics


def store() -> list | None:
    """The port's spans (``SpanRecord``s by start), or None where the
    program records none."""
    try:
        from stereo_depth_estimation_tpu_torch import spans
    except ImportError:
        return None
    return spans.records()


def per_unit(records: list | None, unit: str, names: tuple[str, ...],
             field: str) -> list[float] | None:
    """Each unit's sum of ``field`` (``host_ms`` or ``device_ms``) over its
    spans named in ``names``; None without a unit, or where a span to sum
    has no value (``device_ms`` off the card)."""
    units = sorted((r for r in records or () if r.name == unit), key=lambda r: r.start_ns)
    if not units:
        return None
    starts = [u.start_ns for u in units]
    sums = [0.0] * len(units)
    for r in records:
        if r.name not in names:
            continue
        i = bisect.bisect_right(starts, r.start_ns) - 1
        if i < 0 or r.end_ns > units[i].end_ns:  # outside every unit: the next one's
            i = bisect.bisect_left(starts, r.end_ns)
            if i == len(units):
                continue
        value = getattr(r, field)
        if value is None:
            return None
        sums[i] += value
    return sums


def mean_per_unit(unit: str, names: tuple[str, ...], field: str) -> float | None:
    sums = per_unit(store(), unit, names, field)
    return None if sums is None else statistics.fmean(sums)


def median_per_unit(unit: str, names: tuple[str, ...], field: str) -> float | None:
    sums = per_unit(store(), unit, names, field)
    return None if sums is None else statistics.median(sums)
