"""How far apart data-parallel train steps drift through float noise alone,
and how far a planted fault moves them, on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 rank_drift.py

At ``chip_smoke.py``'s multi-rank setting (StereoUNet base 32, 240x320,
float32 with TF32 off, no augmentation, seed-0 weights, its global batch of
32 with unequal valid counts) it takes three steps in a row and prints, for
each step, the summed LossStats' largest relative gap and the largest
gradient leaf gap relative to the leaf's norm (``largest_leaf_gap``) of:

- two ranks against one rank taking the same step from the two ranks' state
  before it (what ``chip_smoke.py`` holds to its limits);
- two ranks against one rank taking its own three steps from the same start;
- one rank against itself with the batch's rows reversed: the same sums in
  another order, so float noise alone.

Then, at step 1, two ranks with a planted fault against one rank: each
rank's loss its own masked mean (its LossStats never summed over the
ranks), and BatchNorm over each rank's own stripe. The two ranks are two
processes in one gloo group on cuda:0, as in ``chip_smoke.py``. Without
CUDA it exits non-zero and runs nothing.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from chip_smoke import (
    MR_STEPS,
    largest_leaf_gap,
    mr_batch,
    multi_rank_steps,
    one_rank_steps_from,
)
from stereo_depth_estimation_tpu_torch import _build
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.parallel import train_step
from stereo_depth_estimation_tpu_torch.parallel.distributed import (
    initialize_multihost,
    run_process_farm,
)
from stereo_depth_estimation_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch_to_mesh


def stats_gap(want: list[float], got: list[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


def child(rank: int, tmp_dir: str) -> None:
    """One of the two ranks (a process of its own on cuda:0): the steps, the
    train state before each saved by rank 0, then step 1 again under each
    planted fault."""
    tmp = Path(tmp_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    initialize_multihost(f"file://{tmp / 'rendezvous'}", 2, rank, device=device,
                         backend="gloo")
    mesh = make_mesh(device)
    batch = shard_batch_to_mesh(mr_batch(), mesh)
    two = multi_rank_steps(mesh, batch, MR_STEPS, tmp / "states" if rank == 0 else None)
    summed = train_step.global_stats
    train_step.global_stats = lambda stats, mesh: stats
    local_loss = multi_rank_steps(mesh, batch, 1)
    train_step.global_stats = summed
    chip_smoke.StereoUNet = lambda **kw: StereoUNet(**{**kw, "bn_group": None})
    local_bn = multi_rank_steps(mesh, batch, 1)
    chip_smoke.StereoUNet = StereoUNet
    if rank == 0:
        torch.save({"two": two, "local_loss": local_loss["grads"][0],
                    "local_bn": local_bn["grads"][0]}, tmp / "ranks.pt")
    torch.distributed.destroy_process_group()
    print("RESULT ok", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_drift: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    repo = str(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_dir:
        tmp = Path(tmp_dir)
        run_process_farm(
            "import sys, rank_drift; rank_drift.child(int(sys.argv[1]), sys.argv[2])",
            lambda i: [str(i), str(tmp)], num_processes=2, timeout=600, cwd=repo)
        ranks = torch.load(tmp / "ranks.pt", weights_only=False)
        whole = {k: torch.from_numpy(v).cuda() for k, v in mr_batch().items()}
        from_state = one_rank_steps_from(tmp / "states", whole, MR_STEPS)
    one = Mesh(torch.device("cuda", 0))
    own = multi_rank_steps(one, whole, MR_STEPS)
    flipped = multi_rank_steps(one, {k: v.flip(0) for k, v in whole.items()}, MR_STEPS)
    two = ranks["two"]
    for k in range(MR_STEPS):
        rows = (("two ranks vs one from their state", two, from_state[k]["stats"],
                 from_state[k]["grads"]),
                ("two ranks vs one's own steps", two, own["stats"][k], own["grads"][k]),
                ("one rank vs itself, rows reversed", flipped, own["stats"][k],
                 own["grads"][k]))
        parts = []
        for name, got, want_stats, want_grads in rows:
            gap, leaf = largest_leaf_gap(want_grads, got["grads"][k])
            parts.append(f"{name}: LossStats {stats_gap(want_stats, got['stats'][k]):.3g}, "
                         f"largest leaf {gap:.3g} ({leaf})")
        print(f"drift: step {k + 1}: " + "; ".join(parts))
    for name, key in (("each rank's loss its own masked mean", "local_loss"),
                      ("BatchNorm over each rank's own stripe", "local_bn")):
        gap, leaf = largest_leaf_gap(own["grads"][0], ranks[key])
        print(f"fault: step 1 on two ranks with {name}, vs one rank: largest leaf {gap:.3g} "
              f"({leaf}); chip_smoke.py's limit {chip_smoke.MR_GRAD_RTOL:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
