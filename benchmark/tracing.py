"""The traced stretch: ``torch.profiler`` over a few units at the end of a
``--trace 1`` run, reduced to what the per-layer metrics read.

The stretch runs one unit in the profiler's warm-up step, whose records are
dropped (a stretch that starts the tracing itself may lose the first
kernels it launches), then ``units`` units in the active step, which ends in
a synchronise. Every operation on the device (kernels, copies, sets) counts
as busy time; the window is the active step's span on the host.
"""

from __future__ import annotations

import bisect
import time

import torch

# First match names a device operation's group (kernel names of the port,
# cuDNN and PyTorch as the H100 shows them).
KERNEL_GROUPS = (
    ("augment gray means", ("gray_means_kernel",)),
    ("K1 augment", ("augment_kernel",)),
    ("K2 max pool fwd", ("maxpool2x2_fwd",)),
    ("K3 max pool bwd", ("maxpool2x2_bwd",)),
    ("BN1-BN4", ("bn_stats_partial", "bn_bwd_sums_partial", "bn_sums_final", "bn_relu_")),
    # Inductor's generated kernels hold "batchnorm" in their names: first.
    ("inductor triton", ("triton_",)),
    ("batchnorm", ("batch_norm",)),
    ("conv", ("conv", "gemm", "xmma", "dgrad", "wgrad", "cudnn", "cutlass", "sm90_")),
    ("max pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("relu", ("threshold", "clamp_min")),
    ("memcpy", ("Memcpy", "memcpy")),
    ("memset", ("Memset", "memset")),
)
GAP_FLOOR_US = 2.0  # shorter idle gaps are not attributed


def group_of(name: str) -> str:
    return next((g for g, subs in KERNEL_GROUPS if any(s in name for s in subs)), "other")


def profile(run_unit, units: int):
    """The events of ``units`` calls of ``run_unit`` and the host seconds
    they took."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1),
                       acc_events=True) as prof:
        run_unit()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(units):
            run_unit()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        prof.step()
    return list(prof.events()), host_s


def split_events(events):
    """(device ops, host ops, active step) as (start_us, end_us, name)."""
    from torch.autograd import DeviceType

    device, host, step = [], [], None
    for e in events:
        span = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.name.startswith("ProfilerStep"):
            if e.device_type != DeviceType.CUDA:
                step = span
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        (device if e.device_type == DeviceType.CUDA else host).append(span)
    return device, host, step


def reduce(device, host, step, host_s: float, units: int) -> dict:
    """Busy and window seconds, device seconds and counts by group and by
    name (every name, so a reader can sum a later model's kernels by name
    without a new group), and the idle gaps by what the host was doing
    (innermost host operation open at each gap's middle)."""
    lo, hi = (step[0], step[1]) if step else (
        min(s for s, _, _ in device), max(e for _, e, _ in device))
    spans = sorted((max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi)
    busy_us, gaps = 0.0, []
    cursor = lo
    for s, e, _ in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy_us += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    by_group: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for s, e, n in device:
        for k in (by_group.setdefault(group_of(n), [0.0, 0]), by_name.setdefault(n, [0.0, 0])):
            k[0] += (e - s) * 1e-6
            k[1] += 1
    host = sorted(host)
    starts = [s for s, _, _ in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        if b - a < GAP_FLOOR_US:
            continue
        mid = 0.5 * (a + b)
        label = "no host operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    window_s = (hi - lo) * 1e-6 if step else host_s
    names_s = {n: v[0] for n, v in by_name.items()}
    top = sorted(names_s.items(), key=lambda kv: -kv[1])[:10]
    return {
        "units": units,
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "groups_s": {g: v[0] for g, v in by_group.items()},
        "groups_n": {g: v[1] for g, v in by_group.items()},
        "names_s": names_s,
        "names_n": {n: v[1] for n, v in by_name.items()},
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def trace_units(run_unit, units: int) -> dict:
    events, host_s = profile(run_unit, units)
    device, host, step = split_events(events)
    if not device:
        raise RuntimeError("torch.profiler recorded no operation on the device")
    return reduce(device, host, step, host_s, units)
