"""Time the PyTorch/CUDA port's augmentation layer on one NVIDIA GPU, part by
part, at the train step's shape: batch 128, 240x320, ``AugmentConfig()``,
bf16 out.

Run from the root of a checkout, with no arguments:

    python3 augment_timing.py

It prints the card's name and power limit and one "augment timing:" line.
``chip_smoke.py`` prints the same line from ``time_augmentation``. The
script uses only names that the port had before its gray-mean kernel, so a
copy of it run from the root of an older checkout times that tree's
augmentation the same way (its pre-pass is then part of "pack").
"""

from __future__ import annotations

import subprocess
import sys

import torch

from stereo_depth_estimation_tpu_torch.ops import augment_cuda
from stereo_depth_estimation_tpu_torch.ops.augment import (
    AugmentConfig,
    noise_and_clip_stereo,
    sample_factors,
)

BATCH, HW = 128, (240, 320)


# Cycles the card spins before a timed run, per call of it: about 0.5 ms at
# the H100's clocks, more than the host takes to enqueue one call of the
# whole augmentation (~40 small launches).
QUEUE_AHEAD_CYCLES = 1_000_000


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after one warm-up
    call: CUDA events around the run, which is queued behind a spin of the
    card so that the host's enqueue time stays out of it (a kernel of ~30 us
    otherwise reads the Python wrapper's time)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_augmentation(reps: int = 20) -> dict[str, float | None]:
    """Milliseconds per call of each part of ``augment_stereo_batch_fused`` and
    of the whole call: "sample" (factor draws), "pre_pass_plain" and
    "pre_pass_kernel" (the gray means; None where the tree has no such
    function), "pack" (gray means by the dispatcher plus the factor rows),
    "chain" (K1), "noise" (noise + clamp epilogue), "whole"."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cfg = AugmentConfig()
    n, dtype = BATCH, torch.bfloat16
    x = torch.randint(0, 256, (n, *HW, 6), dtype=torch.uint8, device="cuda", generator=gen)
    factors = sample_factors(gen, 2 * n, cfg)
    packed = augment_cuda._pack_factors(x, factors, n)
    blur_k = cfg.blur_kernel_size if cfg.blur_enabled else 0
    chained = augment_cuda.pointwise_chain_cuda(x, packed, blur_k, dtype)
    std = factors["noise_std"]
    brightness = factors["brightness"]
    plain = getattr(augment_cuda, "gray_means_plain", None)
    kernel = getattr(augment_cuda, "gray_means_cuda", None)
    return {
        "sample": time_ms(lambda: sample_factors(gen, 2 * n, cfg), reps),
        "pre_pass_plain": time_ms(lambda: plain(x, brightness), reps) if plain else None,
        "pre_pass_kernel": time_ms(lambda: kernel(x, brightness), reps) if kernel else None,
        "pack": time_ms(lambda: augment_cuda._pack_factors(x, factors, n), reps),
        "chain": time_ms(lambda: augment_cuda.pointwise_chain_cuda(x, packed, blur_k, dtype),
                         reps),
        "noise": time_ms(lambda: noise_and_clip_stereo(gen, chained, std[:n], std[n:], True),
                         reps),
        "whole": time_ms(lambda: augment_cuda.augment_stereo_batch_fused(gen, x, cfg, dtype),
                         reps),
    }


def describe(times: dict[str, float | None]) -> str:
    """The "augment timing:" line, microseconds per call."""

    def us(key: str) -> str:
        return "not in this tree" if times[key] is None else f"{times[key] * 1e3:.1f} us"

    return (f"augment timing: {BATCH}x{HW[0]}x{HW[1]} bf16 out, AugmentConfig(): sample "
            f"{us('sample')}, gray-mean pre-pass plain {us('pre_pass_plain')} / kernel "
            f"{us('pre_pass_kernel')}, pack (pre-pass by dispatch + rows) {us('pack')}, "
            f"K1 {us('chain')}, noise + clamp {us('noise')}; whole "
            f"augment_stereo_batch_fused {us('whole')}")


def main() -> int:
    if not torch.cuda.is_available():
        print("augment_timing: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(describe(time_augmentation()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
