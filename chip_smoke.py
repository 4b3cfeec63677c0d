"""Smoke run of the PyTorch/CUDA port (``stereo_depth_estimation_tpu_torch``)
on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``stereo_depth_estimation_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, drives the
port's main path (the augmented StereoUNet train step at full width: base 32,
240x320, batch 128, bf16, over a device-resident uint8 payload), checks that
the path went through the kernel, runs predict, times the kernel against its
bound, and prints one JSON line per kernel list and, last, the result line.
Any failed check raises, so the exit code is non-zero and no result line is
printed. Without CUDA, or outside the repository, it exits non-zero too.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from stereo_depth_estimation_tpu_torch import _build
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig, sample_factors
from stereo_depth_estimation_tpu_torch.ops.augment_cuda import (
    _pack_factors,
    pointwise_chain_cuda,
    pointwise_chain_plain,
)
from stereo_depth_estimation_tpu_torch.ops.loss import LossStats, metrics_from_stats
from stereo_depth_estimation_tpu_torch.parallel import (
    create_train_state,
    make_adamw,
    make_device_data_train_step,
    make_predict_fn,
    make_train_step,
    train_step,
)

BATCH, HW, PAYLOAD, STEPS, WARMUP = 128, (240, 320), 512, 5, 2

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Operations per pixel and view of the colour chain and gamma, counting each
# f32 add, sub, mul, div, min, max, compare, select, floor, int->float
# conversion and powf as one (csrc/augment.cu chain_view + load_pixel):
# decode 6, brightness 9, contrast 14, saturation 19, rgb->hsv 44,
# hsv->rgb + gamma 50.
CHAIN_OPS_PER_PIXEL_VIEW = 142

# Kernel vs plain: f32 outputs within 1e-5 (FMA contraction and powf/expf
# ulps; near 0, the min channel of hsv->rgb is a cancellation that
# x^gamma amplifies, to ~5e-6). bf16 outputs within one bf16 ulp of the
# larger value plus that f32 tolerance.
F32_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_case(gen, n, h, w, blur_prob, config=None):
    """Random uint8 batch + sampled, packed factors at one shape and config."""
    cfg = config or AugmentConfig(blur_prob=blur_prob)
    images = torch.randint(0, 256, (n, h, w, 6), dtype=torch.uint8, device="cuda",
                           generator=gen)
    factors = sample_factors(gen, 2 * n, cfg)
    packed = _pack_factors(images, factors, n)
    blur_k = cfg.blur_kernel_size if cfg.blur_enabled else 0
    return images, packed, blur_k


def compare_kernel(images, packed, blur_k, out_dtype) -> float:
    out = pointwise_chain_cuda(images, packed, blur_k, out_dtype)
    ref = pointwise_chain_plain(images, packed, blur_k, out_dtype)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, "kernel shape/dtype")
    check(bool(torch.isfinite(out.float()).all()), "kernel output not finite")
    err = (out.float() - ref.float()).abs()
    if out_dtype == torch.float32:
        check(float(err.max()) <= F32_TOL, f"kernel vs plain f32 err {float(err.max())}")
    else:
        ulp = torch.maximum(bf16_ulp(out.float()), bf16_ulp(ref.float()))
        check(bool((err <= ulp + F32_TOL).all()),
              f"kernel vs plain bf16 err {float(err.max())} > 1 ulp + {F32_TOL:g}")
    return float(err.max())


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_checks() -> dict[tuple, float]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errors = {}
    cases = [(BATCH, *HW, bp) for bp in (0.0, 0.03, 1.0)]
    # Ragged sides, the smallest image k=5 reflect padding allows, and a
    # resolution above the TPU kernel's whole-image limit: one kernel for all.
    cases += [(2, 37, 53, 0.0), (2, 37, 53, 1.0), (2, 3, 3, 1.0), (2, 480, 640, 1.0)]
    for n, h, w, bp in cases:
        for dtype in (torch.float32, torch.bfloat16):
            images, packed, blur_k = kernel_case(gen, n, h, w, bp)
            blurred = int((packed[:, [6, 14]] > 0).sum()) if blur_k else 0
            err = compare_kernel(images, packed, blur_k, dtype)
            tol = f"{F32_TOL:g}" if dtype == torch.float32 else f"1 bf16 ulp + {F32_TOL:g}"
            print(f"kernel check: {n}x{h}x{w} blur_prob={bp} blur_k={blur_k} "
                  f"blurred_views={blurred} out={str(dtype).split('.')[-1]} "
                  f"max_abs_err={err:.3g} tol={tol} ok")
            errors[(n, h, w, bp, dtype)] = err
    return errors


def phase_reference_step() -> None:
    """One train step on a small input, on the card (kernel augmentation)
    and on the CPU (plain augmentation), from the same weights and batch."""
    still = dict(brightness_jitter=0.0, contrast_jitter=0.0, saturation_jitter=0.0,
                 hue_jitter=0.0, gamma_jitter=0.0, noise_std_max=0.0, blur_prob=0.0)
    rng = np.random.default_rng(0)
    batch = {
        "input": torch.from_numpy(rng.integers(0, 256, (4, 32, 48, 6), dtype=np.uint8)),
        "target": torch.from_numpy(rng.uniform(0.5, 8.0, (4, 32, 48)).astype(np.float32)),
    }
    results = {}
    for device, impl in (("cpu", "auto"), ("cuda", "kernel")):
        model = StereoUNet(base_channels=8, device=device,
                           generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), 0)
        step = make_train_step(AugmentConfig(impl=impl, **still))
        state, stats = step(state, {k: v.to(device) for k, v in batch.items()})
        weights = torch.cat([p.detach().flatten().cpu() for p in model.parameters()])
        results[device] = ([float(s) for s in stats], weights)
    (cpu_stats, cpu_w), (gpu_stats, gpu_w) = results["cpu"], results["cuda"]
    for name, a, b in zip(LossStats._fields, gpu_stats, cpu_stats):
        check(math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-4), f"reference step {name}: {a} vs {b}")
    # Adam's first update is lr * g / (|g| + eps): bounded by 2 lr apart.
    w_err = float((gpu_w - cpu_w).abs().max())
    check(w_err <= 2e-3 + 1e-4, f"reference step weights differ by {w_err}")
    print(f"reference step (base 8, 4x32x48, f32): card vs CPU nll_sum "
          f"{gpu_stats[0]:.6g} vs {cpu_stats[0]:.6g}, max weight diff {w_err:.3g} ok")

    # A batch with no valid pixel leaves weights, BN stats and the (on-card,
    # capturable) AdamW state as they were.
    before = [t.clone() for t in train_step._gated_tensors(state)]
    empty = {"input": batch["input"].cuda(), "target": torch.zeros_like(batch["target"]).cuda()}
    state, stats = step(state, empty)
    after = train_step._gated_tensors(state)
    check(float(stats.valid_count) == 0.0, "zero-valid batch counted pixels")
    check(all(torch.equal(a, b) for a, b in zip(after, before)), "zero-valid batch changed state")

    # The learning-rate schedule read from AdamW's on-card step count equals
    # the same schedule on the CPU, step by step, to 1e-5: the two devices'
    # float32 cos differ by an ulp, which 1 + cos(x) near x = pi enlarges.
    lrs = {}
    for device in ("cpu", "cuda"):
        w = torch.nn.Parameter(torch.ones(3, device=device))
        opt = make_adamw([w], 1e-3, 0.0, schedule="cosine", total_steps=10, warmup_steps=3)
        lrs[device] = []
        for _ in range(12):
            w.grad = torch.ones_like(w)
            train_step._set_learning_rate(opt)
            lrs[device].append(float(opt.param_groups[0]["lr"]))
            opt.step()
    check(all(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-12)
              for a, b in zip(lrs["cuda"], lrs["cpu"])), f"lr schedules differ: {lrs}")
    print("zero-valid batch on the card: a no-op ok; warmup-cosine lr on the card "
          "equals the CPU's over 12 steps ok")


def phase_train(state, runner) -> tuple[float, list[LossStats]]:
    for _ in range(WARMUP):
        runner(state)
    torch.cuda.synchronize()
    pointwise_chain_cuda.launches = 0  # counts from here are the main path's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    stats = []
    start.record()
    for _ in range(STEPS):
        state, s = runner(state)
        stats.append(s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / STEPS, stats


KERNEL_GROUPS = (  # first match names a device kernel's group
    ("K1 augment", ("augment_kernel",)),
    ("batchnorm", ("batch_norm",)),
    ("conv", ("conv", "gemm", "xmma", "dgrad", "wgrad", "cudnn", "cutlass", "sm90_")),
    ("max pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("relu", ("threshold", "clamp_min")),
)


def phase_profile(runner, state) -> None:
    """Device time by kernel over 2 steps (torch.profiler), grouped, and the
    device's busy share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            runner(state)
        torch.cuda.synchronize()
    window_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        print("profile: torch.profiler recorded no device kernel time")
        return
    print(f"profile (2 steps, profiler on): kernels {total / 2e3:.2f} ms/step of a "
          f"{window_us / 2e3:.2f} ms/step window, device busy {100 * total / window_us:.1f}%")
    groups: dict[str, float] = {}
    for dev, _, key in rows:
        name = next((g for g, subs in KERNEL_GROUPS if any(s in key for s in subs)), "other")
        groups[name] = groups.get(name, 0.0) + dev
    print("profile: by group " + ", ".join(
        f"{g} {t / 2e3:.2f} ms ({100 * t / total:.1f}%)"
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    for dev, count, key in rows[:10]:
        print(f"profile:   {dev / 2e3:8.3f} ms/step  {100 * dev / total:5.1f}%  "
              f"x{count // 2:<4d} {key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cudnn.benchmark={torch.backends.cudnn.benchmark}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    for lib in libs.values():
        print(f"build: {lib.path.name} in {lib.seconds:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build:   {line.strip()}")
    print(f"build: total {time.perf_counter() - t0:.1f} s")

    errors = phase_kernel_checks()
    phase_reference_step()

    # The main path at full width, as bench.py runs the JAX package.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    images = torch.randint(0, 256, (PAYLOAD, *HW, 6), dtype=torch.uint8, device="cuda",
                           generator=gen)
    targets = torch.rand((PAYLOAD, *HW), device="cuda", generator=gen) * 63.5 + 0.5
    targets[:, :8] = 0.0  # a band of invalid pixels
    model = StereoUNet(base_channels=32, compute_dtype=torch.bfloat16, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    runner = make_device_data_train_step(images, targets, BATCH, AugmentConfig())
    torch.cuda.reset_peak_memory_stats()
    ms_step, stats = phase_train(state, runner)
    launches = pointwise_chain_cuda.launches
    check(launches == STEPS, f"kernel launched {launches} times in {STEPS} steps")
    losses = [metrics_from_stats(s)["loss"] for s in stats]
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    print(f"train: StereoUNet base 32 bf16, batch {BATCH}, {HW[0]}x{HW[1]}, payload "
          f"{PAYLOAD} on device, {STEPS} steps after {WARMUP} warm-up: {ms_step:.2f} ms/step, "
          f"{BATCH * 1e3 / ms_step:.1f} pairs/s, kernel launches {launches}, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_profile(runner, state)

    predict = make_predict_fn(model)
    batch = images[:BATCH]
    ms_predict = time_ms(lambda: predict(batch), 3)
    disp, logvar = predict(batch)
    torch.cuda.synchronize()
    check(tuple(disp.shape) == tuple(logvar.shape) == (BATCH, *HW), "predict shapes")
    check(bool(torch.isfinite(disp).all() and torch.isfinite(logvar).all()), "predict not finite")
    check(float(disp.min()) >= 0.0, "negative disparity")
    check(-6.0 <= float(logvar.min()) and float(logvar.max()) <= 3.0, "logvar out of [-6, 3]")
    print(f"predict: batch {BATCH} {HW[0]}x{HW[1]} bf16 -> disparity/logvar "
          f"{tuple(disp.shape)}, {ms_predict:.2f} ms, disparity in "
          f"[{float(disp.min()):.4f}, {float(disp.max()):.4f}] ok")

    # The kernel alone at the main path's shape and config (bf16 out).
    cfg = AugmentConfig()
    timing_gen = torch.Generator(device="cuda")
    timing_gen.manual_seed(2)
    x, packed, blur_k = kernel_case(timing_gen, BATCH, *HW, cfg.blur_prob, cfg)
    ms_kernel = time_ms(lambda: pointwise_chain_cuda(x, packed, blur_k, torch.bfloat16), 20)
    ms_plain = time_ms(lambda: pointwise_chain_plain(x, packed, blur_k, torch.bfloat16), 3)
    ms_kernel_f32 = time_ms(lambda: pointwise_chain_cuda(x, packed, blur_k, torch.float32), 20)
    n, (h, w) = BATCH, HW
    blurred_views = int((packed[:, [6, 14]] > 0).sum())
    nbytes = n * h * w * 6 * (1 + 2) + packed.numel() * 4
    ops = n * h * w * 2 * CHAIN_OPS_PER_PIXEL_VIEW + blurred_views * h * w * 3 * 4 * blur_k
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    f32_bound_ms = (n * h * w * 6 * (1 + 4) + packed.numel() * 4) / HBM_BYTES_PER_S * 1e3
    print(f"kernel timing: {n}x{h}x{w} bf16 out, blur_k={blur_k}, {blurred_views} of {2 * n} "
          f"views blurred: kernel {ms_kernel * 1e3:.1f} us, plain {ms_plain * 1e3:.1f} us, "
          f"bound {bound_ms * 1e3:.1f} us by {bound_by} ({nbytes / 1e6:.1f} MB -> "
          f"{bytes_ms * 1e3:.1f} us; {ops / 1e9:.2f} G ops -> {ops_ms * 1e3:.1f} us), "
          f"{100 * bound_ms / ms_kernel:.1f}% of bound; f32 out {ms_kernel_f32 * 1e3:.1f} us "
          f"(bytes bound {f32_bound_ms * 1e3:.1f} us); launches per step "
          f"{launches / STEPS:g}")

    kernels = [{
        "name": "augment_pointwise_chain",
        "route": "cuda",
        "source": "stereo_depth_estimation_tpu_torch/csrc/augment.cu",
        "replaces": "stereo_depth_estimation_tpu/ops/augment_pallas.py:177",
        "launches": launches,
        "max_abs_err": errors[(BATCH, *HW, 0.03, torch.bfloat16)],
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this chain
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
