"""The port's data-parallel path held against its own one-rank path and the
JAX package's mesh on the CPU.

Ranks are processes: two children join one gloo group through a ``file://``
rendezvous under ``tmp_path`` (so parallel test workers never share a port)
and import only torch and the port. The JAX side runs in this process on two
of the eight virtual CPU devices ``conftest.py`` provides.

Tolerances:
- two ranks vs one rank over the whole batch, in float32: loss sums, the
  whole gradient (relative to its norm) and the BatchNorm running statistics
  within 1e-5 relative, each parameter's gradient within 1e-4 of its norm.
  The two ranks' BatchNorm sums its shards' sums, one rank sums the batch
  in another order: float noise, which a small BatchNorm weight's gradient
  (a sum with cancellation) shows most; the test against
  ``nn.BatchNorm2d``, another variance formula, allows the same.
- weights after one AdamW step: where a gradient is below 1e-6, Adam's
  first update lr * g / (|g| + 1e-8) is decided by that noise and may land
  anywhere in [-lr, lr] (``tests/test_torch_train_step.py``), so those
  weights are held to 2 lr; the others to 1e-6.
- two ranks vs JAX on a 2-device mesh: ``tests/test_torch_train_step.py``'s
  float32 tolerances (atol 1e-4 with the same rule for quiet gradients).
- the window rows and batch stripes are numpy: exact.
"""

import json
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import jax_variables, write_checkpoint, write_dataset
from test_torch_train_step import _assert_weights_close

from stereo_depth_estimation_tpu.eval import evaluate as jax_evaluate
from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.parallel import distributed as j_distributed
from stereo_depth_estimation_tpu.parallel import mesh as j_mesh
from stereo_depth_estimation_tpu.parallel import train_step as J
from stereo_depth_estimation_tpu.parallel import window as j_window
from stereo_depth_estimation_tpu_torch import _device
from stereo_depth_estimation_tpu_torch.eval import evaluate
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.unet import MeshBatchNorm2d
from stereo_depth_estimation_tpu_torch.models.compat import state_dict_from_jax
from stereo_depth_estimation_tpu_torch.ops.loss import LossStats
from stereo_depth_estimation_tpu_torch.parallel import distributed, mesh, window
from stereo_depth_estimation_tpu_torch.parallel import train_step as P
from stereo_depth_estimation_tpu_torch.training import checkpoint, trainer

REPO = Path(__file__).resolve().parent.parent
BASE, HW = 4, (32, 48)
LR, WD = 1e-3, 1e-4
RTOL = 1e-5
LEAF_RTOL = 1e-4  # one parameter's gradient (measured up to 1.9e-5)
FARM_TIMEOUT = 240.0  # the step farm also traces a compiled step
CONSECUTIVE_STEPS = 3

# One child of a two-rank farm: joins the gloo group, runs every scenario of
# SCENARIOS on its stripe and saves what it saw as rank<r>.pt.
_STEP_CHILD = textwrap.dedent("""
    import os, sys
    rank, root, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from stereo_depth_estimation_tpu_torch.models import StereoUNet
    from stereo_depth_estimation_tpu_torch.models.unet import MeshBatchNorm2d
    from stereo_depth_estimation_tpu_torch.parallel import train_step as P
    from stereo_depth_estimation_tpu_torch.parallel.distributed import initialize_multihost
    from stereo_depth_estimation_tpu_torch.parallel.mesh import make_mesh, shard_batch_to_mesh
    from stereo_depth_estimation_tpu_torch.training import checkpoint

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    initialize_multihost(f"file://{root}/rendezvous", 2, rank, device=cpu)
    mesh = make_mesh(cpu)
    init = torch.load(f"{root}/init.pt")
    data = np.load(f"{root}/batches.npz")
    out = {}
    for name in sorted({k.split(":")[0] for k in data.files if ":" in k}):
        model = StereoUNet(base_channels=4, device=cpu, bn_group=mesh.group)
        model.load_state_dict(init, strict=False)
        state = P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4),
                                     0, mesh)
        batch = shard_batch_to_mesh(
            {"input": data[name + ":input"], "target": data[name + ":target"]}, mesh)
        eval_stats = P.make_eval_step(mesh)(state, batch)
        state, stats = P.make_train_step(None, mesh)(state, batch)
        out[name] = {
            "rows": int(batch["input"].shape[0]),
            "stats": [float(s) for s in stats],
            "eval_stats": [float(s) for s in eval_stats],
            "weights": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "bn_types": sorted({type(m).__name__ for m in model.modules()
                                if isinstance(m, torch.nn.BatchNorm2d)}),
        }
    # CONSECUTIVE_STEPS steps in a row on the "unequal" batch, the train
    # state saved before each and after the last (rank 0).
    model = StereoUNet(base_channels=4, device=cpu, bn_group=mesh.group)
    model.load_state_dict(init, strict=False)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4), 0, mesh)
    batch = shard_batch_to_mesh({"input": data["unequal:input"],
                                 "target": data["unequal:target"]}, mesh)
    step = P.make_train_step(None, mesh)
    out["consecutive"] = []
    for k in range(int(sys.argv[4]) + 1):
        if rank == 0:
            checkpoint.save_checkpoint(f"{root}/states", f"state{k}", state, epoch=k,
                                       config={}, metrics={})
        if k == int(sys.argv[4]):
            break
        state, stats = step(state, batch)
        out["consecutive"].append({
            "stats": [float(s) for s in stats],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}})
    out["consecutive_weights"] = {k: v.clone() for k, v in model.state_dict().items()}
    # The "unequal" step compiled (aot_eager: DistributedDataParallel wraps
    # the compiled model, whose BatchNorm all-reduces Dynamo traces).
    from torch._dynamo.utils import counters
    model = StereoUNet(base_channels=4, device=cpu, bn_group=mesh.group)
    model.load_state_dict(init, strict=False)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4), 0, mesh,
                                 compile=P.CompileOptions(backend="aot_eager"))
    batch = shard_batch_to_mesh({"input": data["unequal:input"],
                                 "target": data["unequal:target"]}, mesh)
    graphs = counters["stats"]["unique_graphs"]
    state, stats = P.make_train_step(None, mesh)(state, batch)
    out["compiled"] = {
        "stats": [float(s) for s in stats],
        "weights": {k: v.clone() for k, v in model.state_dict().items()},
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "graphs": counters["stats"]["unique_graphs"] - graphs,
    }
    x = torch.from_numpy(data["bn_x"])
    w = torch.from_numpy(data["bn_w"])
    stripe = slice(rank * 4, rank * 4 + 4)
    bn = MeshBatchNorm2d(x.shape[1], mesh.group)
    xr = x[stripe].clone().contiguous(memory_format=torch.channels_last).requires_grad_()
    y = bn(xr)
    (y * w[stripe]).sum().backward()
    out["bn"] = {"y": y.detach(), "x_grad": xr.grad, "weight_grad": bn.weight.grad,
                 "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
                 "running_var": bn.running_var, "tracked": int(bn.num_batches_tracked)}
    torch.save(out, f"{root}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print("RESULT ok", flush=True)
    # Leave without the interpreter's teardown, where gloo's threads can
    # abort a finished child ("terminate called without an active exception").
    os._exit(0)
""")


def run_farm(source: str, root: Path, *argv: str) -> list[tuple[str, str]]:
    return distributed.run_process_farm(
        source, lambda i: [str(i), str(root), str(REPO), *argv],
        timeout=FARM_TIMEOUT, cwd=str(REPO),
    )


def _batch(seed: int, n: int) -> dict[str, np.ndarray]:
    """uint8 pairs and float32 targets; the first rows of every image are
    invalid and rows 2k+1 lose more, so the two ranks' stripes (first half,
    second half) hold unequal valid counts."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, 256, (n, *HW, 6), dtype=np.uint8)
    target = rng.uniform(0.5, 8.0, (n, *HW)).astype(np.float32)
    target[:, :3] = 0.0
    target[n // 2:, :, : HW[1] // 2] = 0.0  # the second stripe: half as many
    return {"input": inputs, "target": target}


SCENARIOS = {
    # Unequal valid counts across the two stripes.
    "unequal": _batch(1, 4),
    # A global batch of 5: padded to 6 with one flagged wrap row.
    "pad5": _batch(2, 5),
    # Rank 1's stripe has no valid pixel; rank 0's has some.
    "zero_shard": {**_batch(3, 4), "target": np.concatenate(
        [_batch(3, 4)["target"][:2], np.zeros((2, *HW), np.float32)])},
    # No valid pixel anywhere: a no-op on both ranks.
    "zero_global": {**_batch(4, 4), "target": np.zeros((4, *HW), np.float32)},
}


@pytest.fixture(scope="module")
def jax_init():
    model = JaxUNet(base_channels=BASE)
    tx = J.make_adamw(LR, WD)
    state = jax.jit(lambda key: J.create_train_state(model, key, HW, tx))(jax.random.key(0))
    return model, tx, state


@pytest.fixture(scope="module")
def farm(tmp_path_factory, jax_init):
    """Both ranks' results for every scenario and the BatchNorm case."""
    _, _, jstate = jax_init
    root = tmp_path_factory.mktemp("farm")
    init = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    torch.save(init, root / "init.pt")
    rng = np.random.default_rng(7)
    arrays = {f"{name}:{k}": v for name, b in SCENARIOS.items() for k, v in b.items()}
    arrays["bn_x"] = (rng.normal(1.0, 2.0, (8, 6, 5, 7))).astype(np.float32)
    arrays["bn_w"] = rng.normal(0.0, 1.0, (8, 6, 5, 7)).astype(np.float32)
    np.savez(root / "batches.npz", **arrays)
    run_farm(_STEP_CHILD, root, str(CONSECUTIVE_STEPS))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, init, {**arrays, "root": root}


def _one_rank_step(init: dict, batch: dict[str, np.ndarray]) -> tuple[P.TrainState, LossStats]:
    model = StereoUNet(base_channels=BASE, device="cpu")
    model.load_state_dict(init, strict=False)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), 0)
    return P.make_train_step(None)(state, {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_ranks_equal(ranks: list[dict], name: str) -> None:
    a, b = ranks[0][name], ranks[1][name]
    assert a["stats"] == b["stats"]
    for key in a["weights"]:
        assert torch.equal(a["weights"][key], b["weights"][key]), key


def test_two_rank_step_equals_one_rank_step_with_unequal_counts(farm) -> None:
    ranks, init, arrays = farm
    batch = SCENARIOS["unequal"]
    counts = [int((batch["target"][s] > 0).sum()) for s in (slice(0, 2), slice(2, 4))]
    assert counts[0] != counts[1]
    _assert_ranks_equal(ranks, "unequal")
    got = ranks[0]["unequal"]
    assert got["bn_types"] == ["MeshBatchNorm2d"] and got["rows"] == 2
    state, stats = _one_rank_step(init, batch)
    assert got["stats"][4] == sum(counts)
    _assert_step_matches(got["stats"], got["grads"], got["weights"], state, stats)


def _assert_step_matches(two_stats, two_grads, two_weights, state, stats) -> None:
    """Two ranks' step (its summed LossStats, rank 0's gradients and the
    weights after it) against one rank's ``state`` after the same step."""
    np.testing.assert_allclose(two_stats, [float(s) for s in stats], rtol=RTOL)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    whole = torch.cat([g.flatten() for g in grads.values()])
    gap = torch.cat([(two_grads[k] - g).flatten() for k, g in grads.items()]).norm()
    assert float(gap / whole.norm()) <= RTOL
    for key, g in grads.items():
        leaf_gap = float((two_grads[key] - g).norm() / g.norm())
        assert leaf_gap <= LEAF_RTOL, (key, leaf_gap)
    for key, want in state.model.state_dict().items():
        have = two_weights[key]
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=RTOL, atol=1e-7,
                                       err_msg=key)
        elif key in grads:
            tol = torch.where(grads[key].abs() < 1e-6, 2 * LR, 1e-6)
            assert bool(((have - want).abs() <= tol).all()), key
        else:
            assert torch.equal(have, want), key


def test_compiled_two_rank_step_equals_the_eager_two_rank_step(farm) -> None:
    """The two ranks' "unequal" step with the model compiled (aot_eager,
    fullgraph: one graph, the cross-rank BatchNorm's all-reduces inside it)
    equals their eager step within 1e-6, and the ranks stay equal."""
    ranks, _, _ = farm
    for r in ranks:
        got, want = r["compiled"], r["unequal"]
        assert got["graphs"] == 1
        np.testing.assert_allclose(got["stats"], want["stats"], rtol=1e-6)
        for key, g in want["grads"].items():
            assert float((got["grads"][key] - g).norm()) <= 1e-6 * float(g.norm()), key
        for key, w in want["weights"].items():
            np.testing.assert_allclose(got["weights"][key].numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    assert ranks[0]["compiled"]["stats"] == ranks[1]["compiled"]["stats"]


def test_consecutive_two_rank_steps_each_equal_one_rank_step_from_their_state(farm) -> None:
    """CONSECUTIVE_STEPS two-rank steps in a row, each held against one rank
    taking that step over the whole batch from the two ranks' state before
    it (weights, BatchNorm statistics, AdamW moments and count), so that
    what a step carries into the next is checked. One rank's own run of the
    same steps is not held to these tolerances: where a gradient is float
    noise, AdamW's first update lands anywhere in [-lr, lr], and the next
    steps' gradients move by far more than the noise that decided it."""
    ranks, _, arrays = farm
    root = arrays["root"]
    batch = {k: torch.from_numpy(v) for k, v in SCENARIOS["unequal"].items()}
    steps = ranks[0]["consecutive"]
    assert len(steps) == CONSECUTIVE_STEPS
    for r in ranks[1:]:
        assert [s["stats"] for s in r["consecutive"]] == [s["stats"] for s in steps]
        for key, value in ranks[0]["consecutive_weights"].items():
            assert torch.equal(r["consecutive_weights"][key], value), key
    for k, two in enumerate(steps):
        model = StereoUNet(base_channels=BASE, device="cpu")
        state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), 0)
        state, meta = checkpoint.load_train_state(root / "states" / f"state{k}.pt", state)
        assert state.step == k and meta["epoch"] == k
        state, stats = P.make_train_step(None)(state, batch)
        after = torch.load(root / "states" / f"state{k + 1}.pt",
                           weights_only=False)["model_state_dict"]
        _assert_step_matches(two["stats"], two["grads"], after, state, stats)


def test_two_rank_step_equals_jax_two_device_mesh(farm, jax_init) -> None:
    ranks, _, _ = farm
    model, tx, jstate = jax_init
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    for name in ("unequal", "pad5"):
        batch = SCENARIOS[name]
        state = j_mesh.replicate_to_mesh(jax.tree.map(jnp.copy, jstate), jmesh)
        with jax.default_matmul_precision("highest"):
            jnew, jstats = J.make_train_step(model, tx, None)(
                state, j_mesh.shard_batch_to_mesh(dict(batch), jmesh))
        got = ranks[0][name]
        np.testing.assert_allclose(got["stats"], [float(s) for s in jstats], rtol=RTOL,
                                   atol=1e-4, err_msg=name)
        port = P.TrainState(model=StereoUNet(base_channels=BASE, device="cpu"),
                            optimizer=None, generator=None)
        port.model.load_state_dict(got["weights"])
        _assert_weights_close(port, jax.device_get(jnew))


def test_global_batch_of_five_is_padded_to_six_like_jax(farm, jax_init) -> None:
    ranks, _, _ = farm
    model, _, jstate = jax_init
    assert [r["pad5"]["rows"] for r in ranks] == [3, 3]
    _assert_ranks_equal(ranks, "pad5")
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    sharded = j_mesh.shard_batch_to_mesh(dict(SCENARIOS["pad5"]), jmesh)
    assert sharded["input"].shape[0] == 6 and not bool(sharded["valid_mask"][5])
    jstats = jax.jit(J.make_eval_step(model))(j_mesh.replicate_to_mesh(jstate, jmesh), sharded)
    for r in ranks:
        np.testing.assert_allclose(r["pad5"]["eval_stats"], [float(s) for s in jstats],
                                   rtol=RTOL, atol=1e-4)
    # The padded row counts nothing: the valid count is the five real rows'.
    assert ranks[0]["pad5"]["eval_stats"][4] == float((SCENARIOS["pad5"]["target"] > 0).sum())


def test_zero_valid_shard_steps_and_zero_valid_batch_is_a_noop(farm) -> None:
    ranks, init, _ = farm
    for name in ("zero_shard", "zero_global"):
        _assert_ranks_equal(ranks, name)
    moved = ranks[0]["zero_shard"]
    assert moved["stats"][4] > 0
    assert any(not torch.equal(moved["weights"][k], v) for k, v in init.items()
               if k in moved["grads"])
    still = ranks[0]["zero_global"]
    assert still["stats"][4] == 0.0
    for key, value in init.items():
        assert torch.equal(still["weights"][key], value), key
    assert int(still["weights"]["enc1.block.1.num_batches_tracked"]) == 0


def test_cross_rank_batchnorm_equals_batchnorm_over_the_whole_batch(farm) -> None:
    ranks, _, arrays = farm
    x = torch.from_numpy(arrays["bn_x"]).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    bn = torch.nn.BatchNorm2d(x.shape[1])
    y = bn(x)
    (y * torch.from_numpy(arrays["bn_w"])).sum().backward()
    got = [r["bn"] for r in ranks]
    close = dict(rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), y.detach().numpy(),
                               **close)
    np.testing.assert_allclose(torch.cat([g["x_grad"] for g in got]).numpy(),
                               x.grad.numpy(), **close)
    for key in ("weight_grad", "bias_grad"):
        want = bn.weight.grad if key == "weight_grad" else bn.bias.grad
        np.testing.assert_allclose((got[0][key] + got[1][key]).numpy(), want.numpy(),
                                   err_msg=key, **close)
    for g in got:
        np.testing.assert_allclose(g["running_mean"].numpy(), bn.running_mean.numpy(), **close)
        np.testing.assert_allclose(g["running_var"].numpy(), bn.running_var.numpy(), **close)
        assert g["tracked"] == 1


def test_one_rank_builds_plain_batchnorm_and_runs_no_collective(monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran on one rank")

    for name in ("all_reduce", "broadcast", "barrier", "all_gather"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    cpu = torch.device("cpu")
    one = mesh.Mesh(cpu)
    model = StereoUNet(base_channels=BASE, device=cpu, generator=torch.Generator().manual_seed(0))
    # One rank: the BatchNorms run on the kernels with no group.
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert {type(m) for m in bns} == {MeshBatchNorm2d}
    assert all(m.group is None for m in bns)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), 3, one)
    assert state.replica is None and state.generator.initial_seed() == 3
    mesh.replicate_to_mesh(state, one)
    one.barrier()
    batch = {k: torch.from_numpy(v) for k, v in SCENARIOS["unequal"].items()}
    P.make_train_step(None, one)(state, batch)
    P.make_eval_step(one)(state, batch)
    assert mesh.make_mesh(cpu) == one  # no process group: one rank


@pytest.mark.parametrize("pad_to", [None, 8], ids=["mesh-pad", "pad-to-8"])
def test_multihost_batcher_stripes_equal_jax(monkeypatch, pad_to) -> None:
    """The JAX batcher's per-process stripe, read before it assembles global
    arrays, for each of two processes; the port's rank stripes must equal
    it, flags included."""
    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, value, global_shape: np.asarray(value))
    fetched = []

    def fetch(idx):
        fetched.append(np.asarray(idx).copy())
        return {"input": np.asarray(idx)[:, None] * 10, "target": np.asarray(idx, np.float32)}

    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    for indices in (np.array([4, 9, 1, 7, 3]), np.array([2]), np.arange(8)[::-1]):
        for r in range(2):
            theirs = j_distributed.MultihostBatcher(fetch, jmesh, pad_to=pad_to)
            theirs.process_index, theirs.process_count = r, 2
            want = theirs(indices)
            want_fetch = fetched.pop()
            ours = distributed.MultihostBatcher(
                fetch, mesh.Mesh(torch.device("cpu"), 2, r), pad_to=pad_to)(indices)
            np.testing.assert_array_equal(fetched.pop(), want_fetch)  # each sample once
            assert ours.keys() == want.keys()
            for key in ours:
                np.testing.assert_array_equal(ours[key], want[key], err_msg=key)


@pytest.mark.parametrize("n,budget", [(13, 10**9), (13, 50), (16, 60)],
                         ids=["pinned", "rotating", "rotating-exact"])
def test_window_rows_per_rank_equal_jax_shards(n, budget) -> None:
    """Each rank stages the rows that JAX data shard r holds, for the same
    seed and epoch: samples carry their id, so the staged rows name them."""
    batch_size, per_sample = 4, 10

    def fetch(idx):
        idx = np.asarray(idx)
        return {"input": np.broadcast_to(idx.astype(np.uint8)[:, None, None, None],
                                         (len(idx), 1, 1, 6)).copy(),
                "target": idx.astype(np.float16)[:, None, None].copy()}

    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    theirs = j_window.HBMWindowLoader(fetch, n, batch_size, jmesh, per_sample, budget * 2,
                                      seed=3)
    ours = [window.HBMWindowLoader(fetch, n, batch_size, torch.device("cpu"), per_sample,
                                   window.default_hbm_budget_bytes(budget / (1 << 30), 2),
                                   seed=3, mesh=mesh.Mesh(torch.device("cpu"), 2, r))
            for r in range(2)]
    assert all(o.plan == ours[0].plan for o in ours)
    assert (ours[0].plan.pinned, ours[0].plan.n, ours[0].plan.steps_per_epoch) == (
        theirs.plan.pinned, theirs.plan.n, theirs.plan.steps_per_epoch)
    assert ours[0].local_batch == 2
    for epoch in (1, 2):
        if theirs.plan.pinned:
            jax_windows = [theirs._pinned_window]
        else:
            jax_windows = [theirs._stage(ix) for ix in theirs._epoch_window_indices(epoch)]
        for r, loader in enumerate(ours):
            staged = list(loader.epoch_windows(epoch))
            assert len(staged) == len(jax_windows)
            for (images, _), (j_images, _) in zip(staged, jax_windows):
                [shard] = [s for s in j_images.addressable_shards
                           if s.device == jmesh.devices[r]]
                np.testing.assert_array_equal(images[:, 0, 0, 0].numpy(),
                                              np.asarray(shard.data)[:, 0, 0, 0])
    with pytest.raises(ValueError, match="must divide"):
        window.plan_windows(12, 5, 1, 1000, data_degree=2)


def test_default_budget_scales_with_the_world_size() -> None:
    assert window.default_hbm_budget_bytes(2.0, 4) == 4 * window.default_hbm_budget_bytes(2.0)


def test_shard_and_replicate_on_one_rank_and_stripe_math() -> None:
    batch = {"input": np.arange(5)[:, None], "target": np.ones((5, 2), np.float32)}
    stripes = [mesh.shard_batch_to_mesh(batch, mesh.Mesh(torch.device("cpu"), 2, r))
               for r in range(2)]
    assert [s["input"][:, 0].tolist() for s in stripes] == [[0, 1, 2], [3, 4, 0]]
    assert [s["valid_mask"].tolist() for s in stripes] == [[True] * 3, [True, True, False]]
    even = {k: v[:4] for k, v in batch.items()}
    halves = [mesh.shard_batch_to_mesh(even, mesh.Mesh(torch.device("cpu"), 2, r))
              for r in range(2)]
    assert [h["input"][:, 0].tolist() for h in halves] == [[0, 1], [2, 3]]
    assert all("valid_mask" not in h for h in halves)  # divisible: nothing padded
    one = mesh.shard_batch_to_mesh(batch, mesh.Mesh(torch.device("cpu")))
    assert one["input"].shape[0] == 5 and "valid_mask" not in one


def test_rank_counts_backends_and_address_flags() -> None:
    assert distributed.default_backend(torch.device("cpu")) == "gloo"
    assert distributed.default_backend(torch.device("cuda", 0)) == "nccl"
    assert _device.local_rank_count(torch.device("cpu"), 0) == 1
    assert _device.local_rank_count(torch.device("cpu"), 3) == 3
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 GPU\\(s\\) visible"):
            _device.local_rank_count(torch.device("cuda"), 2)
    with pytest.raises(ValueError, match="go together"):
        distributed.initialize_multihost("localhost:1234", 2, None, device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="one rank a process"):
        distributed.run_ranks(lambda m: m, (), device=torch.device("cpu"), local_ranks=2,
                              multihost=True)
    with pytest.raises(ValueError, match="go together"):
        distributed.run_ranks(lambda m: m, (), device=torch.device("cpu"), local_ranks=2,
                              multihost=True, num_processes=2)
    assert distributed.next_farm_port(20000) != distributed.next_farm_port(20000)
    assert distributed.is_main_process()  # no process group: the one process


def test_multihost_without_address_flags_reads_the_environment(monkeypatch) -> None:
    """``--multihost`` alone joins the group the torch.distributed variables
    describe (here a group of one), runs there, and leaves no group behind."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    for name, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                        ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(name, value)

    def seen(m: mesh.Mesh) -> tuple:
        return (torch.distributed.get_backend(), m.world_size, m.rank,
                distributed.is_main_process())

    got = distributed.run_ranks(seen, (), device=torch.device("cpu"), local_ranks=1,
                                multihost=True)
    assert got == ("gloo", 1, 0, True)
    assert not torch.distributed.is_initialized()


def test_trainer_multihost_from_the_environment_runs_one_rank_a_process(
        monkeypatch, tmp_path) -> None:
    """``--multihost`` with no address flags at the default ``--mesh-devices``
    (0, every visible GPU) runs one rank a process, as a launcher that sets
    WORLD_SIZE and RANK for each process expects, on a host with two GPUs;
    an explicit ``--mesh-devices 2`` there raises. Then the CLI trains to the
    end on the CPU in the group of one that the environment describes."""
    write_dataset(tmp_path / "data", per_scene=3)
    flags = ["--dataset-root", str(tmp_path / "data"), "--height", str(HW[0]), "--width",
             str(HW[1]), "--epochs", "1", "--batch-size", "2", "--val-fraction", "0.34",
             "--compute-dtype", "float32", "--base-channels", str(BASE), "--num-workers", "0",
             "--preview-samples", "0", "--mlflow-tracking-uri", str(tmp_path / "runs"),
             "--output-dir", str(tmp_path / "out")]
    started = []
    with monkeypatch.context() as patched:
        patched.setattr(torch.cuda, "device_count", lambda: 2)
        patched.setattr(trainer, "resolve_cli_device", lambda arg: torch.device("cuda"))
        patched.setattr(trainer, "run_ranks", lambda fn, args, **kw: started.append(kw))
        trainer.main(flags + ["--multihost"])
        trainer.main(flags)
        with pytest.raises(ValueError, match="one a process"):
            trainer.main(flags + ["--multihost", "--mesh-devices", "2"])
    assert [(kw["local_ranks"], kw["multihost"]) for kw in started] == [(1, True), (2, False)]

    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    for name, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                        ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(name, value)
    summary = trainer.main(flags + ["--multihost", "--device", "cpu"])
    assert summary["global_step"] == 2 and summary["run_id"] != "multihost-follower"
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# The CLIs on two ranks.
# ---------------------------------------------------------------------------

_TRAIN_CHILD = textwrap.dedent("""
    import json, os, sys
    pid, root, repo, rendezvous = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    extra = json.loads(sys.argv[5])
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(2)
    from stereo_depth_estimation_tpu_torch.training import trainer
    summary = trainer.main([
        "--dataset-root", f"{root}/data", "--height", "32", "--width", "48",
        "--batch-size", "4", "--val-fraction", "0.25", "--device", "cpu",
        "--compute-dtype", "float32", "--base-channels", "4", "--num-workers", "0",
        "--log-every-batches", "2", "--mlflow-tracking-uri", f"{root}/mlruns",
        "--output-dir", f"{root}/outputs", "--packed-cache-root", f"{root}/packed",
        "--preview-samples", "2", "--multihost",
        "--coordinator-address", f"file://{root}/{rendezvous}",
        "--num-processes", "2", "--process-id", str(pid), *extra,
    ])
    summary.pop("state")
    print("RESULT " + json.dumps(summary), flush=True)
    # Leave without the interpreter's teardown, where gloo's threads can
    # abort a finished child ("terminate called without an active exception").
    os._exit(0)
""")


def _train_farm(root: Path, rendezvous: str, *extra: str) -> list[tuple[dict, str]]:
    farm = run_farm(_TRAIN_CHILD, root, rendezvous, json.dumps(list(extra)))
    return [(json.loads(line), out) for line, out in farm]


def test_two_process_trainer_writes_on_rank_0_alone_and_resumes(tmp_path) -> None:
    write_dataset(tmp_path / "data", per_scene=6)  # 12 samples: 9 train, 3 val
    (first, out0), (follower, out1) = _train_farm(tmp_path, "rdv1", "--epochs", "2")
    assert follower["run_id"] == "multihost-follower" != first["run_id"]
    # Pinned device-resident: 9 train samples pad to 10, 2 global steps of 4.
    assert first["device_resident"] == follower["device_resident"] == "pinned"
    assert first["global_step"] == follower["global_step"] == 4
    for a, b in zip(first["epochs"], follower["epochs"]):
        for key in ("train_mae", "val_mae", "val_nll"):
            assert a[key] == b[key], key  # global metrics on both ranks
    assert (out0 + out1).count("Building packed cache") == 2  # train and val, once
    assert "Discovered" in out0 and "Discovered" not in out1
    runs = list((tmp_path / "outputs").iterdir())
    assert [r.name for r in runs] == [first["run_id"]]
    ckpt = runs[0] / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["best.pt", "last.pt"]
    assert len(list((runs[0] / "mlflow_previews").rglob("*.png"))) == 2 * 2
    metric_runs = {p.parent.parent for p in (tmp_path / "mlruns").glob("*/*/metrics/*")}
    assert len(metric_runs) == 1

    (resumed, _), (resumed1, _) = _train_farm(
        tmp_path, "rdv2", "--epochs", "3", "--resume", str(ckpt / "last.pt"))
    assert resumed["global_step"] == resumed1["global_step"] == 6
    assert [e["epoch"] for e in resumed["epochs"]] == [3]
    assert checkpoint.load_checkpoint_meta(
        Path(resumed["checkpoints_dir"]) / "last.pt")["epoch"] == 3


def test_mesh_devices_two_trains_like_one_rank(tmp_path) -> None:
    """``--mesh-devices 2`` spawns two ranks in this process's place; with
    no augmentation in float32 it trains what one rank trains on the same
    global batches (streamed, so the stripes come from MultihostBatcher)."""
    write_dataset(tmp_path / "data", per_scene=6)
    flags = ["--dataset-root", str(tmp_path / "data"), "--height", str(HW[0]), "--width",
             str(HW[1]), "--epochs", "2", "--batch-size", "4", "--val-fraction", "0.25",
             "--device", "cpu", "--compute-dtype", "float32", "--base-channels", str(BASE),
             "--num-workers", "0", "--no-augment", "--preview-samples", "0",
             "--log-every-batches", "2", "--mlflow-tracking-uri", str(tmp_path / "runs")]
    two = trainer.main(flags + ["--mesh-devices", "2", "--output-dir", str(tmp_path / "two")])
    one = trainer.main(flags + ["--mesh-devices", "1", "--output-dir", str(tmp_path / "one")])
    assert "state" not in two and two["global_step"] == one["global_step"] == 2 * 3
    assert two["device_resident"] == "off"
    for a, b in zip(two["epochs"], one["epochs"]):
        for key in ("train_nll", "train_mae", "val_mae", "val_nll", "val_sigma"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, err_msg=key)
    weights = torch.load(Path(two["checkpoints_dir"]) / "last.pt", weights_only=False)
    assert weights["epoch"] == 2


def test_mesh_devices_two_compiled_trains_like_one_eager_rank(tmp_path) -> None:
    """``--mesh-devices 2 --compile --compile-backend aot_eager``: each
    spawned rank runs the compiled model inside its replica and trains what
    one eager rank trains on the same global batches."""
    write_dataset(tmp_path / "data", per_scene=6)
    flags = ["--dataset-root", str(tmp_path / "data"), "--height", str(HW[0]), "--width",
             str(HW[1]), "--epochs", "1", "--batch-size", "4", "--val-fraction", "0.25",
             "--device", "cpu", "--compute-dtype", "float32", "--base-channels", str(BASE),
             "--num-workers", "0", "--no-augment", "--preview-samples", "0",
             "--log-every-batches", "2", "--mlflow-tracking-uri", str(tmp_path / "runs")]
    two = trainer.main(flags + ["--mesh-devices", "2", "--compile", "--compile-backend",
                                "aot_eager", "--aot-cache", "off",
                                "--output-dir", str(tmp_path / "two")])
    one = trainer.main(flags + ["--mesh-devices", "1", "--output-dir", str(tmp_path / "one")])
    assert two["global_step"] == one["global_step"] == 3
    for a, b in zip(two["epochs"], one["epochs"]):
        for key in ("train_nll", "train_mae", "val_mae", "val_nll", "val_sigma"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, err_msg=key)
    last = torch.load(Path(two["checkpoints_dir"]) / "last.pt", weights_only=False)
    assert not any("_orig_mod" in k for k in last["model_state_dict"])


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("eval")
    write_dataset(root / "data")
    write_checkpoint(root / "model.pt", jax_variables(BASE, HW, seed=1), epoch=3)
    return root


@pytest.mark.parametrize("batch", [3, 4])
def test_evaluate_on_two_ranks_equals_the_jax_cli_and_one_rank(eval_root, batch) -> None:
    argv = ["--checkpoint", str(eval_root / "model.pt"), "--height", str(HW[0]), "--width",
            str(HW[1]), "--base-channels", str(BASE), "--dataset-root",
            str(eval_root / "data"), "--split", "all", "--batch-size", str(batch),
            "--num-workers", "0", "--device", "cpu"]
    want = jax_evaluate.evaluate(jax_evaluate.build_parser().parse_args(
        argv + ["--aot-cache", "off", "--mesh-devices", "2"]))
    two = evaluate.main(argv + ["--mesh-devices", "2"])
    one = evaluate.main(argv + ["--mesh-devices", "1"])
    assert two.keys() == want.keys() == one.keys()
    for got in (two, one):
        for key in ("checkpoint", "checkpoint_epoch", "split", "samples", "valid_pixels"):
            assert got[key] == want[key], key
        for key in ("mae", "rmse", "nll", "sigma", "loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
