"""How far a planted fault in the compiled graph moves ``chip_smoke.py``'s
compiled-vs-eager check, on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 compile_fault.py

At the main path's setting (StereoUNet base 32, bf16, batch 128, 240x320,
augmentation on, seed-0 weights) it compiles the model as the trainer's
``--compile`` does and holds one step against the eager model from the same
weights on the same augmented batch (``chip_smoke.compiled_vs_eager_step``),
after the first step and after the ten steps at which ``chip_smoke.py``
checks it: first as it is, then with K3's index routed one window position
on (``(idx + 1) % 4``) inside the compiled graph only: the fault is in place
while the graph is traced (with the compile caches off, so that it is
traced) and taken out before the eager step. It prints each gap beside
``chip_smoke``'s limits. Each of the two compiles is cold
(Inductor's and Triton's caches point at a fresh directory under
``build/``, removed at the end). Without CUDA it exits non-zero.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import sys

import torch
import torch._functorch.config
import torch._inductor.config

import chip_smoke
from stereo_depth_estimation_tpu_torch.ops import pool


def misrouted_backward(real):
    """K3 with every saved index moved one window position on."""

    def backward(dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return real(dy, ((idx.to(torch.int32) + 1) % 4).to(torch.uint8))

    return backward


def measure(images: torch.Tensor, targets: torch.Tensor, planted: bool) -> list[dict]:
    """Compile (the planted fault in place while the graph is traced, with
    Inductor's and AOTAutograd's caches off so that the faulty graph is
    traced and built, not looked up), then hold a step against eager after
    the first step and after the main path's ten (the point where
    ``chip_smoke.py`` checks it)."""
    torch._dynamo.reset()
    real = pool.maxpool2x2_bwd
    caches_off = contextlib.ExitStack()
    if planted:
        pool.maxpool2x2_bwd = misrouted_backward(real)
        caches_off.enter_context(torch._inductor.config.patch(fx_graph_cache=False))
        caches_off.enter_context(torch._functorch.config.patch(enable_autograd_cache=False))
    try:
        with caches_off:
            state, runner, cold_s, _ = chip_smoke.compiled_main_path(images, targets)
    finally:
        pool.maxpool2x2_bwd = real
    readings = [{**chip_smoke.compiled_vs_eager_step(state, runner), "after": 1,
                 "cold_s": cold_s}]
    steps = 1 + chip_smoke.WARMUP + chip_smoke.STEPS + 2  # as chip_smoke.py, profile included
    for _ in range(steps - 1):
        runner(state)
    readings.append({**chip_smoke.compiled_vs_eager_step(state, runner), "after": steps,
                     "cold_s": cold_s})
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        print("compile_fault: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    caches = chip_smoke.fresh_compile_caches()
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        images = torch.randint(0, 256, (chip_smoke.PAYLOAD, *chip_smoke.HW, 6),
                               dtype=torch.uint8, device="cuda", generator=gen)
        targets = torch.rand((chip_smoke.PAYLOAD, *chip_smoke.HW), device="cuda",
                             generator=gen) * 63.5 + 0.5
        targets[:, :8] = 0.0
        limits = (chip_smoke.COMPILED_STATS_RTOL, chip_smoke.COMPILED_GRAD_RTOL)
        for planted in (False, True):
            what = "K3 misrouted in the graph" if planted else "as it is"
            for g in measure(images, targets, planted):
                print(f"compile fault: {what}, after {g['after']} steps: LossStats within "
                      f"{g['stats_gap']:.3g} ({g['stats_gap'] / limits[0]:.3g}x the limit "
                      f"{limits[0]:g}); largest leaf gap {g['grad_gap']:.3g} of its norm in "
                      f"{g['leaf']} ({g['grad_gap'] / limits[1]:.3g}x the limit "
                      f"{limits[1]:g}); cold compile {g['cold_s']:.1f} s")
    finally:
        shutil.rmtree(caches, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
