"""Which convolution launches which kernel: the StereoUNet's train step
profiled with the operators' shapes recorded.

    python -m stereo_depth_estimation_tpu_torch.scripts.conv_attribution \\
        --height 240 --width 320 --batch 128 --steps 2 [--compile]

Builds the model at base 32 in bf16 with AdamW and a device-resident payload
of seeded uint8 pairs (``make_device_data_train_step``, the benchmark's
training cells), runs ``--warmup`` steps, then ``--steps`` steps under
``torch.profiler`` with ``record_shapes``. Every convolution-like kernel
(cuDNN's forward, dgrad and wgrad, CUTLASS, gemm) is charged to the
operator that launched it and that operator's input shapes; the table lists
device ms a step by (kernel, operator, shapes), the largest first, and
``--out`` writes it as JSON too. Needs a CUDA card: it measures the card.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import torch

# Substrings of the kernels the table lists (the benchmark's ``conv`` group).
CONV_KERNELS = ("conv", "gemm", "xmma", "dgrad", "wgrad", "cudnn", "cutlass", "sm90_")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--base-channels", type=int, default=32)
    parser.add_argument("--payload-pairs", type=int, default=512,
                        help="Pairs held on the card, drawn from --seed.")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--steps", type=int, default=2, help="Profiled steps.")
    parser.add_argument("--compile", action="store_true",
                        help="Run the model through torch.compile (the trainer's --compile).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=25, help="Rows printed.")
    parser.add_argument("--out", type=Path, help="Write the whole table here as JSON.")
    return parser


def attribute(events, steps: int) -> list[dict]:
    """Device ms a step of each convolution-like kernel, by its name, the
    operator that launched it and that operator's input shapes."""
    ms: dict[tuple, float] = defaultdict(float)
    launches: dict[tuple, int] = defaultdict(int)
    for e in events:
        for k in e.kernels:
            if any(s in k.name for s in CONV_KERNELS):
                shapes = [list(s) for s in e.input_shapes if s]
                key = (k.name, e.name, json.dumps(shapes))
                ms[key] += 1e-3 * k.duration / steps
                launches[key] += 1
    rows = [{"kernel": name, "op": op, "shapes": json.loads(shapes), "ms": v,
             "launches_a_step": launches[(name, op, shapes)] / steps}
            for (name, op, shapes), v in ms.items()]
    return sorted(rows, key=lambda r: -r["ms"])


def main(argv: list[str] | None = None) -> list[dict]:
    from torch.profiler import ProfilerActivity, profile

    from ..models.unet import StereoUNet
    from ..ops.augment import AugmentConfig
    from ..parallel.train_step import (
        CompileOptions, create_train_state, make_adamw, make_device_data_train_step)

    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_attribution measures a CUDA card; none found")
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device)
    g.manual_seed(args.seed)
    n, h, w = args.payload_pairs, args.height, args.width
    images = torch.randint(0, 256, (n, h, w, 6), generator=g, device=device, dtype=torch.uint8)
    targets = torch.rand((n, h, w), generator=g, device=device) * 48.0
    model = StereoUNet(base_channels=args.base_channels, compute_dtype=torch.bfloat16,
                       device=device)
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4),
                               seed=args.seed,
                               compile=CompileOptions() if args.compile else None)
    step = make_device_data_train_step(images, targets, args.batch, AugmentConfig())
    for _ in range(args.warmup):
        state, _ = step(state)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(args.steps):
            state, _ = step(state)
        torch.cuda.synchronize(device)
    rows = attribute(prof.events(), args.steps)
    total = sum(r["ms"] for r in rows)
    print(f"{torch.cuda.get_device_name(device)}; {h}x{w} batch {args.batch}, "
          f"{'compiled' if args.compile else 'eager'}: convolution kernels "
          f"{total:.3f} ms a step over {args.steps} steps")
    for r in rows[:args.top]:
        print(f"{r['ms']:9.3f} ms  x{r['launches_a_step']:g}  {r['kernel'][:70]}  "
              f"{r['op']}  {r['shapes']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"total_ms": total, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
