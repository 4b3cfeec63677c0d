"""The compiled and the eager StereoUNet's heads on one GPU, with the heads'
bias fused into the bf16 convolution and added in float32 after it.

Run from the repository root, with no arguments:

    python3 head_rounding.py

For each way of adding the bias, from the JAX package's init (a fresh
model's, seed 0) and from ``chip_smoke.seeded_model``'s weights, it builds
the main path of ``chip_smoke.py`` (base 32, bf16, batch 128, 240x320, a
random payload on the card), compiles it as the trainer's ``--compile``
does, trains it for the
steps ``chip_smoke.py`` takes before its compiled-vs-eager check (1 + 2
warm-up + 5 timed + 2 in the profiler), and prints, on one augmented batch,
the mean valid logvar of the eager and of the compiled model, the same head
recomputed from the eager model's last decoder block in float32 and with the
bias added in bf16, and ``chip_smoke.compiled_vs_eager_step``'s LossStats and
gradient gaps. It needs CUDA and exits non-zero without it.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs
from stereo_depth_estimation_tpu_torch import _build
from stereo_depth_estimation_tpu_torch.models import unet
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
from stereo_depth_estimation_tpu_torch.parallel import train_step


def readings(images: torch.Tensor, targets: torch.Tensor) -> None:
    torch._dynamo.reset()
    state, runner, _, _ = cs.compiled_main_path(images, targets)
    cs.phase_train(state, runner)
    cs.phase_profile(runner, state, "profile compiled")
    eager = unet.StereoUNet(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    eager.load_state_dict(state.model.state_dict())
    batch = runner.gather(state)
    inputs = cs.augment_stereo_batch_fused(state.generator, batch["input"], AugmentConfig(),
                                           out_dtype=torch.bfloat16)
    _, mask = train_step._targets_and_mask(batch)
    d1 = {}
    eager.dec1.register_forward_hook(lambda module, args, out: d1.setdefault("x", out))
    eager.train()
    with torch.no_grad():
        _, logvar_eager = eager(inputs, return_uncertainty=True)
        _, logvar_compiled = state.compiled(inputs, return_uncertainty=True)
        w, b = eager.logvar_head.weight, eager.logvar_head.bias
        x = d1["x"]
        heads = {
            "float32 throughout": F.conv2d(x.float(), w.float(), b.float()),
            "bf16 convolution, bias added in float32": F.conv2d(x, w.bfloat16()).float() + b,
            "bf16 convolution, bias added in bf16": (F.conv2d(x, w.bfloat16())
                                                     + b.bfloat16()).float(),
        }

    def mean(logvar: torch.Tensor) -> float:
        return float(logvar.reshape(mask.shape)[mask].clamp(-6.0, 3.0).mean())

    print(f"  mean valid logvar: eager {mean(logvar_eager):.6f}, compiled "
          f"{mean(logvar_compiled):.6f}; recomputed from dec1: " + ", ".join(
              f"{name} {mean(h.permute(0, 2, 3, 1)):.6f}" for name, h in heads.items()))
    gaps = cs.compiled_vs_eager_step(state, runner)
    print(f"  compiled vs eager: LossStats within {gaps['stats_gap']:.3g} (chip_smoke's limit "
          f"{cs.COMPILED_STATS_RTOL:g}), gradients within {gaps['grad_gap']:.3g} of their norm "
          f"(largest in {gaps['leaf']}; limit {cs.COMPILED_GRAD_RTOL:g})")


def main() -> int:
    if not torch.cuda.is_available():
        print("head_rounding: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    print(cs.card())
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True  # as chip_smoke.py's main path
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    images = torch.randint(0, 256, (cs.PAYLOAD, *cs.HW, 6), dtype=torch.uint8, device="cuda",
                           generator=gen)
    targets = torch.rand((cs.PAYLOAD, *cs.HW), device="cuda", generator=gen) * 63.5 + 0.5
    targets[:, :8] = 0.0
    added_in_float32 = unet._Head.forward
    seeded_model = cs.seeded_model
    weights = {
        "the JAX package's init": lambda **kwargs: unet.StereoUNet(
            generator=torch.Generator().manual_seed(0), **kwargs),
        "chip_smoke.seeded_model": seeded_model,
    }
    for source, build in weights.items():
        cs.seeded_model = build
        # nn.Conv2d's forward: the bias inside the convolution.
        for name, forward in (("bias fused into the bf16 convolution", torch.nn.Conv2d.forward),
                              ("bias added in float32 (the model's)", added_in_float32)):
            unet._Head.forward = forward
            print(f"{source}, {name}:")
            readings(images, targets)
    unet._Head.forward = added_in_float32
    cs.seeded_model = seeded_model
    return 0


if __name__ == "__main__":
    sys.exit(main())
