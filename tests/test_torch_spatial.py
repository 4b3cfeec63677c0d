"""The port's height sharding (``--spatial-devices``) held against its one-rank
path and the JAX package's ``(data, spatial)`` mesh on the CPU.

Ranks are processes: the children of a farm join one gloo group through a
``file://`` rendezvous under the test's tmp dir and import only torch and the
port. The JAX side runs in this process on two of the eight virtual CPU
devices ``conftest.py`` provides.

Tolerances:
- the halo exchange against padding the whole tensor and cutting the
  stripes, forward and backward: exact (integer-valued data; each halo
  element has one writer, and a row's gradient sums at most three integers);
- a spatial mesh's train step vs one rank over the whole images, in
  float32: as ``tests/test_torch_distributed.py`` holds two data-parallel
  ranks against one (its ``_assert_step_matches``): LossStats, the whole gradient (relative to its norm)
  and the BatchNorm running statistics within RTOL = 1e-5 relative, each
  parameter's gradient within LEAF_RTOL = 1e-4 of its norm, the weights
  after AdamW's first step within 1e-6, or 2 lr where a gradient is below
  1e-6 (there AdamW's first update is decided by float noise). The stripes
  convolve and sum in another order than the whole image, and the
  cross-rank BatchNorm computes E[x^2] - E[x]^2; with the augmentation on,
  the gray means are summed over the stripes;
- the augmented stripes against one rank's augmentation of the whole
  images: AUG_ATOL = 1e-5 (the gray means' sum order; the factors and the
  noise are the same draws);
- a 1 x 2 forward and train step against JAX on the mesh: the forward
  within 2e-5 (``tests/test_spatial.py``'s), the step within
  ``tests/test_torch_train_step.py``'s float32 tolerances (atol 1e-4, 2 lr
  where a gradient is quiet);
- the planted fault (halo rows replaced by zeros) must miss one rank's
  gradient by at least 10 x RTOL (whole) and 10 x LEAF_RTOL (largest leaf);
- predict's gathered stripes vs one rank: 1e-5; the window rows and batch
  blocks are numpy: exact.

The trainer and evaluate CLIs' ``--mesh-devices 2 --spatial-devices 2``
against one rank (and the JAX evaluate CLI), and ``--spatial-devices 2`` on
one rank raising, are the spatial cases of ``test_flags_without_a_mechanism_raise``
in ``tests/test_torch_trainer.py`` and ``tests/test_torch_serving.py``.
"""

import json
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_distributed import _assert_step_matches
from test_torch_serving import write_dataset
from test_torch_train_step import _assert_weights_close

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.parallel import distributed as j_distributed
from stereo_depth_estimation_tpu.parallel import mesh as j_mesh
from stereo_depth_estimation_tpu.parallel import train_step as J
from stereo_depth_estimation_tpu.parallel import window as j_window
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import state_dict_from_jax
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
from stereo_depth_estimation_tpu_torch.ops.augment_cuda import augment_stereo_batch_fused
from stereo_depth_estimation_tpu_torch.parallel import distributed, mesh, window
from stereo_depth_estimation_tpu_torch.parallel import train_step as P

REPO = Path(__file__).resolve().parent.parent
BASE, W = 4, 32
EVEN, UNEVEN = (32, W), (48, W)  # 16/16 and 32/16 rows over two stripes
LR, WD, SEED = 1e-3, 1e-4, 5
RTOL, LEAF_RTOL, AUG_ATOL = 1e-5, 1e-4, 1e-5
FARM_TIMEOUT = 240.0


def run_farm(source: str, root: Path, n: int, *argv: str) -> list[tuple[str, str]]:
    return distributed.run_process_farm(
        source, lambda i: [str(i), str(root), str(REPO), *argv],
        num_processes=n, timeout=FARM_TIMEOUT, cwd=str(REPO),
    )


# ---------------------------------------------------------------------------
# The halo exchange.
# ---------------------------------------------------------------------------

# (name, stripe heights, rows, dtype): the group is the first len(heights)
# ranks of a farm of three.
HALO_CASES = [
    ("three", [3, 2, 4], 1, "float32"),
    ("one-row", [1, 1, 1], 1, "float32"),
    ("two-of-three", [2, 1], 1, "float32"),
    ("two-rows", [2, 3, 2], 2, "float32"),
    ("bf16", [3, 2, 4], 1, "bfloat16"),
]

_HALO_CHILD = textwrap.dedent("""
    import json, os, sys
    rank, root, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cases = json.loads(sys.argv[4])
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    import torch.distributed as dist
    from stereo_depth_estimation_tpu_torch.ops.halo import SpatialGroup

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", world_size=3,
                            rank=rank)
    groups = {3: dist.group.WORLD, 2: dist.new_group([0, 1])}
    out = {}
    for name, heights, rows, dtype in cases:
        size = len(heights)
        if rank >= size:
            continue
        spatial = SpatialGroup(groups[size], rank, size)
        data = np.load(f"{root}/halo_{name}.npz")
        start = sum(heights[:rank])
        x = torch.from_numpy(data["x"][:, start:start + heights[rank]]).to(
            getattr(torch, dtype)).requires_grad_()
        padded = spatial.pad(x, rows)
        g = torch.from_numpy(data["g" + str(rank)]).to(padded.dtype)
        (padded * g).sum().backward()
        u8 = torch.from_numpy(data["u8"][:, start:start + heights[rank]])
        extended, top = spatial.extend(u8, rows)
        out[name] = {"padded": padded.detach().float(), "grad": x.grad.float(),
                     "extended": extended, "top": top}
    torch.save(out, f"{root}/halo{rank}.pt")
    dist.destroy_process_group()
    print("RESULT ok", flush=True)
    # Leave without the interpreter's teardown, where gloo's threads can
    # abort a finished child ("terminate called without an active exception").
    os._exit(0)
""")


@pytest.fixture(scope="module")
def halo_farm(tmp_path_factory):
    root = tmp_path_factory.mktemp("halo")
    rng = np.random.default_rng(3)
    arrays = {}
    for name, heights, rows, _ in HALO_CASES:
        h = sum(heights)
        x = rng.integers(-8, 9, (2, h, 5, 3)).astype(np.float32)
        grads = {f"g{r}": rng.integers(-8, 9, (2, hr + 2 * rows, 5, 3)).astype(np.float32)
                 for r, hr in enumerate(heights)}
        u8 = rng.integers(0, 256, (2, h, 5, 6), dtype=np.uint8)
        np.savez(root / f"halo_{name}.npz", x=x, u8=u8, **grads)
        arrays[name] = {"x": x, "u8": u8, **grads}
    run_farm(_HALO_CHILD, root, 3, json.dumps(HALO_CASES))
    return [torch.load(root / f"halo{r}.pt", weights_only=False) for r in range(3)], arrays


@pytest.mark.parametrize("case", HALO_CASES, ids=[c[0] for c in HALO_CASES])
def test_halo_exchange_equals_padding_the_whole_tensor(halo_farm, case) -> None:
    """Each stripe's padded tensor is the zero-padded whole tensor's rows
    around it, and its gradient the whole tensor's gradient's rows, when
    every stripe's padded tensor is weighted by its own upstream gradient;
    ``extend`` adds the neighbours' rows and nothing at the image's edges."""
    ranks, arrays = halo_farm
    name, heights, rows, _ = case
    data = arrays[name]
    x = torch.from_numpy(data["x"]).requires_grad_()
    whole = torch.nn.functional.pad(x, (0, 0, 0, 0, rows, rows))
    total, start = 0.0, 0
    for r, h in enumerate(heights):
        window = whole[:, start:start + h + 2 * rows]
        got = ranks[r][name]
        assert torch.equal(got["padded"], window.detach()), (name, r)
        total = total + (window * torch.from_numpy(data[f"g{r}"])).sum()
        lo, hi = max(start - rows, 0), min(start + h + rows, sum(heights))
        assert got["top"] == start - lo
        assert torch.equal(got["extended"], torch.from_numpy(data["u8"][:, lo:hi])), (name, r)
        start += h
    total.backward()
    start = 0
    for r, h in enumerate(heights):
        assert torch.equal(ranks[r][name]["grad"], x.grad[:, start:start + h]), (name, r)
        start += h
    if len(heights) < 3:
        assert name not in ranks[2]


def test_a_halo_wider_than_the_stripe_raises() -> None:
    from stereo_depth_estimation_tpu_torch.ops.halo import SpatialGroup

    with pytest.raises(ValueError, match="halo of 2 rows around a stripe of 1"):
        SpatialGroup(None, 0, 2).pad(torch.zeros(1, 1, 2, 1), 2)


# ---------------------------------------------------------------------------
# Train steps on spatial meshes.
# ---------------------------------------------------------------------------

def _batch(seed: int, n: int, hw: tuple[int, int]) -> dict[str, np.ndarray]:
    """uint8 pairs and float32 targets. The first rows of every image are
    invalid and the bottom half of the second half of the batch, so the
    stripes' valid counts differ; the second half's pixels are darker."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, 256, (n, *hw, 6), dtype=np.uint8)
    inputs[n // 2:] //= 2
    target = rng.uniform(0.5, 8.0, (n, *hw)).astype(np.float32)
    target[:, :3] = 0.0
    target[n // 2:, hw[0] // 2:] = 0.0
    return {"input": inputs, "target": target}


# name -> (global batch, augmentation config as AugmentConfig kwargs or None)
STEP_CASES = {
    "aug-even": (_batch(1, 4, EVEN), {"blur_prob": 1.0}),
    "aug-uneven": (_batch(2, 4, UNEVEN), {"blur_prob": 1.0}),
    "aug-plain-uneven": (_batch(3, 4, UNEVEN), {"blur_prob": 1.0, "impl": "plain"}),
    "still-uneven": (_batch(4, 4, UNEVEN), None),
}

# One child of a farm of ``world`` ranks on a (world / 2, 2) mesh: joins the
# gloo group, runs each case of cases.json on its block and saves what it
# saw as rank<r>.pt. With argv[5] == "full" it also runs the predict, eval,
# planted-fault and compiled cases of the 1 x 2 mesh.
_STEP_CHILD = textwrap.dedent("""
    import json, os, sys
    rank, root, repo, world, extra = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                      int(sys.argv[4]), sys.argv[5])
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from stereo_depth_estimation_tpu_torch.models import StereoUNet
    from stereo_depth_estimation_tpu_torch.ops import halo
    from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
    from stereo_depth_estimation_tpu_torch.parallel import train_step as P
    from stereo_depth_estimation_tpu_torch.parallel.distributed import initialize_multihost
    from stereo_depth_estimation_tpu_torch.parallel.mesh import make_mesh, shard_batch_to_mesh

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    initialize_multihost(f"file://{root}/rendezvous", world, rank, device=cpu)
    mesh = make_mesh(cpu, spatial=2)
    init = torch.load(f"{root}/init.pt")
    cases = json.loads(open(f"{root}/cases.json").read())
    data = np.load(f"{root}/batches.npz")

    def build(compile=None):
        model = StereoUNet(base_channels=4, device=cpu, bn_group=mesh.group,
                           spatial_group=mesh.spatial_group)
        model.load_state_dict(init, strict=False)
        return P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4), 5,
                                    mesh, compile=compile)

    def step(name, aug, **kwargs):
        state = build(kwargs.pop("compile", None))
        whole = {"input": data[name + ":input"], "target": data[name + ":target"]}
        batch = shard_batch_to_mesh(whole, mesh)
        config = None if aug is None else AugmentConfig(**aug)
        height = whole["input"].shape[1]
        state, stats = P.make_train_step(config, mesh, height)(state, batch)
        model = state.model
        got = {
            "block": list(batch["input"].shape[:2]),
            "stats": [float(s) for s in stats],
            "weights": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        }
        if config is not None:
            # The augmentation alone, from a fresh generator of the data row.
            state.generator = torch.Generator().manual_seed(P.rank_seed(5, mesh))
            start, _ = mesh.height_block(height)
            got["augmented"] = P._augmented_inputs(
                state, batch["input"], config, halo.Stripe(mesh.spatial_group, start, height))
        return got

    out = {"mesh": [mesh.data_index, mesh.spatial_index, mesh.spatial_group.index]}
    for name, aug in cases.items():
        out[name] = step(name, aug)
    if extra == "full":
        name = "still-uneven"
        whole = data[name + ":input"]
        state = build()
        out["predict"] = P.make_predict_fn(state.model, mesh)(torch.from_numpy(whole))
        batch = shard_batch_to_mesh({"input": whole, "target": data[name + ":target"]}, mesh)
        out["eval"] = [float(s) for s in P.make_eval_step(mesh)(state, batch)]
        # Zero halos: the planted fault.
        real_pad = halo.SpatialGroup.pad
        halo.SpatialGroup.pad = lambda self, x, rows=1: torch.nn.functional.pad(
            x, (0, 0, 0, 0, rows, rows))
        out["zero-halo"] = step(name, None)
        halo.SpatialGroup.pad = real_pad
        from torch._dynamo.utils import counters
        graphs = counters["stats"]["unique_graphs"]
        out["compiled"] = step(name, None, compile=P.CompileOptions(backend="aot_eager"))
        out["compiled"]["graphs"] = counters["stats"]["unique_graphs"] - graphs
    torch.save(out, f"{root}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print("RESULT ok", flush=True)
    # Leave without the interpreter's teardown, where gloo's threads can
    # abort a finished child ("terminate called without an active exception").
    os._exit(0)
""")


@pytest.fixture(scope="module")
def jax_init():
    model = JaxUNet(base_channels=BASE)
    tx = J.make_adamw(LR, WD)
    state = jax.jit(lambda key: J.create_train_state(model, key, UNEVEN, tx))(
        jax.random.key(0))
    return model, tx, state


def _step_farm(root: Path, init: dict, world: int, cases: dict, extra: str) -> list[dict]:
    torch.save(init, root / "init.pt")
    (root / "cases.json").write_text(json.dumps({k: v[1] for k, v in cases.items()}))
    np.savez(root / "batches.npz", **{f"{name}:{k}": v for name, (b, _) in cases.items()
                                      for k, v in b.items()})
    run_farm(_STEP_CHILD, root, world, str(world), extra)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def init(jax_init) -> dict:
    _, _, jstate = jax_init
    return state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})


@pytest.fixture(scope="module")
def farm_1x2(tmp_path_factory, init) -> list[dict]:
    return _step_farm(tmp_path_factory.mktemp("s1x2"), init, 2, STEP_CASES, "full")


@pytest.fixture(scope="module")
def farm_2x2(tmp_path_factory, init) -> list[dict]:
    cases = {"aug-uneven": (_batch(6, 4, UNEVEN), {"blur_prob": 1.0})}
    return _step_farm(tmp_path_factory.mktemp("s2x2"), init, 4, cases, "steps"), cases


def _one_rank_step(init: dict, batch: dict, aug: AugmentConfig | None, seed: int = SEED):
    model = StereoUNet(base_channels=BASE, device="cpu")
    model.load_state_dict(init, strict=False)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), seed)
    return P.make_train_step(aug)(state, {k: torch.from_numpy(v) for k, v in batch.items()})


def _gaps(grads: dict, state: P.TrainState) -> tuple[float, float]:
    """(whole-gradient gap relative to its norm, the largest leaf's gap
    relative to that leaf's norm) of ``grads`` against ``state``'s."""
    want = {k: p.grad for k, p in state.model.named_parameters()}
    whole = torch.cat([g.flatten() for g in want.values()]).norm()
    gap = torch.cat([(grads[k] - g).flatten() for k, g in want.items()]).norm()
    leaf = max(float((grads[k] - g).norm() / g.norm()) for k, g in want.items())
    return float(gap / whole), leaf


def _assert_ranks_equal(ranks: list[dict], name: str) -> None:
    for other in ranks[1:]:
        assert other[name]["stats"] == ranks[0][name]["stats"]
        for key, value in ranks[0][name]["weights"].items():
            assert torch.equal(other[name]["weights"][key], value), key


@pytest.mark.parametrize("name", [k for k, v in STEP_CASES.items() if v[1] is not None])
def test_1x2_augmented_step_equals_one_rank(farm_1x2, init, name) -> None:
    """A 1 x 2 mesh draws what one rank draws (its one data row's generator
    is seeded as one rank's), so its augmented step, the blur on every view,
    is one rank's step over the whole images."""
    ranks = farm_1x2
    batch, aug = STEP_CASES[name]
    h = batch["input"].shape[1]
    assert [r["mesh"] for r in ranks] == [[0, 0, 0], [0, 1, 1]]
    blocks = [r[name]["block"] for r in ranks]
    assert blocks == [[4, stop - start] for start, stop in mesh.height_blocks(h, 2)]
    assert blocks[0] != blocks[1] or h == EVEN[0]
    _assert_ranks_equal(ranks, name)
    config = AugmentConfig(**aug)
    want = P._augmented_inputs(
        P.TrainState(model=StereoUNet(base_channels=BASE, device="cpu"), optimizer=None,
                     generator=torch.Generator().manual_seed(SEED)),
        torch.from_numpy(batch["input"]), config)
    got = torch.cat([r[name]["augmented"] for r in ranks], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=AUG_ATOL)
    state, stats = _one_rank_step(init, batch, config)
    got = ranks[0][name]
    _assert_step_matches(got["stats"], got["grads"], got["weights"], state, stats)


def test_2x2_augmented_step_equals_one_rank(farm_2x2, init) -> None:
    """Rank r of a 2 x 2 mesh is data row r // 2, stripe r % 2. Each data
    row augments its rows with its own generator; one rank, given those
    rows' augmentations as its float input, takes the same step."""
    ranks, cases = farm_2x2
    batch, aug = cases["aug-uneven"]
    assert [r["mesh"] for r in ranks] == [[0, 0, 0], [0, 1, 1], [1, 0, 0], [1, 1, 1]]
    assert [r["aug-uneven"]["block"] for r in ranks] == [[2, 32], [2, 16]] * 2
    _assert_ranks_equal(ranks, "aug-uneven")
    config = AugmentConfig(**aug)
    rows = []
    for d in range(2):
        seed = P.rank_seed(SEED, mesh.Mesh(torch.device("cpu"), 4, 2 * d, spatial=2))
        half = torch.from_numpy(batch["input"][2 * d:2 * d + 2])
        rows.append(augment_stereo_batch_fused(torch.Generator().manual_seed(seed), half,
                                               config))
        got = torch.cat([ranks[2 * d + s]["aug-uneven"]["augmented"] for s in range(2)], 1)
        torch.testing.assert_close(got, rows[-1], rtol=0, atol=AUG_ATOL)
    assert not torch.equal(rows[0], augment_stereo_batch_fused(
        torch.Generator().manual_seed(SEED), torch.from_numpy(batch["input"][:2]), config))
    floats = {"input": torch.cat(rows).numpy(), "target": batch["target"]}
    state, stats = _one_rank_step(init, floats, None)
    got = ranks[0]["aug-uneven"]
    _assert_step_matches(got["stats"], got["grads"], got["weights"], state, stats)


def test_zero_halos_miss_the_one_rank_gradient(farm_1x2, init) -> None:
    """The planted fault: with the halo rows replaced by zeros the 1 x 2
    step misses one rank's gradient by far more than the tolerances."""
    ranks = farm_1x2
    state, _ = _one_rank_step(init, STEP_CASES["still-uneven"][0], None)
    clean = _gaps(ranks[0]["still-uneven"]["grads"], state)
    fault = _gaps(ranks[0]["zero-halo"]["grads"], state)
    assert clean[0] <= RTOL and clean[1] <= LEAF_RTOL
    assert fault[0] >= 10 * RTOL and fault[1] >= 10 * LEAF_RTOL, fault


def test_compiled_1x2_step_equals_the_eager_step(farm_1x2) -> None:
    """With ``--compile`` (aot_eager, fullgraph: one graph, the halo and
    BatchNorm all-reduces traced inside it) the 1 x 2 step equals the eager
    one within 1e-6."""
    for r in farm_1x2:
        got, want = r["compiled"], r["still-uneven"]
        assert got["graphs"] == 1
        np.testing.assert_allclose(got["stats"], want["stats"], rtol=1e-6)
        for key, g in want["grads"].items():
            assert float((got["grads"][key] - g).norm()) <= 1e-6 * float(g.norm()), key


def test_1x2_predict_and_eval_equal_one_rank(farm_1x2, init) -> None:
    batch = STEP_CASES["still-uneven"][0]
    model = StereoUNet(base_channels=BASE, device="cpu")
    model.load_state_dict(init, strict=False)
    disp, logvar = P.make_predict_fn(model)(torch.from_numpy(batch["input"]))
    state = P.TrainState(model=model, optimizer=None, generator=None)
    stats = P.make_eval_step()(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for r in farm_1x2:
        got_disp, got_logvar = r["predict"]
        assert got_disp.shape == disp.shape == batch["target"].shape
        torch.testing.assert_close(got_disp, disp, rtol=0, atol=1e-5)
        torch.testing.assert_close(got_logvar, logvar, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["eval"], [float(s) for s in stats], rtol=RTOL)


def test_1x2_forward_and_step_equal_jax_spatial_mesh(farm_1x2, jax_init) -> None:
    """The JAX package's model and step on ``make_mesh(devices[:2],
    spatial=2)``, run as ``tests/test_spatial.py`` runs them."""
    model, tx, jstate = jax_init
    batch = STEP_CASES["still-uneven"][0]
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2], spatial=2)
    assert dict(jmesh.shape) == {"data": 1, "spatial": 2}
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    sharded = j_mesh.shard_batch_to_mesh(dict(batch), jmesh)
    with jax.default_matmul_precision("highest"):
        fwd = jax.jit(lambda v, x: model.apply(v, x.astype(jnp.float32) / 255.0,
                                               train=False, return_uncertainty=True))
        jdisp, jlogvar = fwd(j_mesh.replicate_to_mesh(variables, jmesh), sharded["input"])
        state = j_mesh.replicate_to_mesh(jax.tree.map(jnp.copy, jstate), jmesh)
        jnew, jstats = J.make_train_step(model, tx, None)(state, sharded)
    got_disp, got_logvar = farm_1x2[0]["predict"]
    np.testing.assert_allclose(got_disp.numpy(), np.asarray(jdisp)[..., 0], atol=2e-5)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(jlogvar)[..., 0], atol=2e-5)
    got = farm_1x2[0]["still-uneven"]
    np.testing.assert_allclose(got["stats"], [float(s) for s in jstats], rtol=RTOL, atol=1e-4)
    port = P.TrainState(model=StereoUNet(base_channels=BASE, device="cpu"), optimizer=None,
                        generator=None)
    port.model.load_state_dict(got["weights"])
    _assert_weights_close(port, jax.device_get(jnew))


# ---------------------------------------------------------------------------
# Mesh geometry and per-rank feeding, against the JAX shards.
# ---------------------------------------------------------------------------

def test_height_blocks_are_whole_16_row_blocks() -> None:
    assert mesh.height_blocks(240, 2) == [(0, 128), (128, 240)]
    assert mesh.height_blocks(48, 2) == [(0, 32), (32, 48)]
    assert mesh.height_blocks(32, 2) == [(0, 16), (16, 32)]
    assert mesh.height_blocks(240, 4) == [(0, 64), (64, 128), (128, 192), (192, 240)]
    assert mesh.height_blocks(64, 1) == [(0, 64)]
    for height, spatial in ((32, 3), (40, 2), (16, 2)):
        with pytest.raises(ValueError, match="does not split"):
            mesh.height_blocks(height, spatial)
    one = mesh.Mesh(torch.device("cpu"), 6, 5, spatial=3)
    assert (one.data_size, one.data_index, one.spatial_index) == (2, 1, 2)
    assert one.height_block(240) == (160, 240)


def test_spatial_that_does_not_factor_raises() -> None:
    with pytest.raises(ValueError, match="do not factor"):
        mesh.check_factors(6, 4)
    with pytest.raises(ValueError, match="do not factor"):
        mesh.make_mesh(torch.device("cpu"), spatial=2)  # no group: one rank
    assert mesh.make_mesh(torch.device("cpu"), spatial=1) == mesh.Mesh(torch.device("cpu"))
    with pytest.raises(ValueError, match="do not factor"):
        distributed.run_ranks(lambda m: m, (), device=torch.device("cpu"), local_ranks=3,
                              spatial=2)


def _jax_blocks(jarray, jmesh) -> list[np.ndarray]:
    """The shards of a JAX array, in the order of the mesh's devices."""
    shards = {s.device: np.asarray(s.data) for s in jarray.addressable_shards}
    return [shards[d] for d in jmesh.devices.flatten()]


@pytest.mark.parametrize("pad_to", [None, 8], ids=["mesh-pad", "pad-to-8"])
def test_multihost_batcher_blocks_equal_jax_shards(pad_to) -> None:
    """On a (4, 2) mesh of eight ranks each rank's block (rows and height
    stripe) equals the JAX batcher's shard on that device; JAX's full-rank
    mask is the rank's target > 0 and its rank-1 row flags."""
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:8], spatial=2)

    def fetch(idx):
        idx = np.asarray(idx)
        rows = np.arange(EVEN[0], dtype=np.float32)[None, :, None]
        target = (idx[:, None, None] * 100 + rows + np.zeros((1, 1, W))).astype(np.float32)
        target[:, :2] = 0.0
        return {"input": np.repeat(target[..., None], 6, axis=-1).astype(np.uint8),
                "target": target}

    for indices in (np.array([4, 9, 1, 7, 3]), np.array([2]), np.arange(8)[::-1]):
        theirs = j_distributed.MultihostBatcher(fetch, jmesh, pad_to=pad_to)(indices)
        for r in range(8):
            ours = distributed.MultihostBatcher(
                fetch, mesh.Mesh(torch.device("cpu"), 8, r, spatial=2), pad_to=pad_to)(indices)
            want = {k: _jax_blocks(v, jmesh)[r] for k, v in theirs.items()}
            for key in ("input", "target"):
                np.testing.assert_array_equal(ours[key], want[key], err_msg=key)
            full = (ours["target"] > 0) & ours["valid_mask"][:, None, None]
            np.testing.assert_array_equal(full, want["valid_mask"])


@pytest.mark.parametrize("n,budget", [(13, 10**9), (13, 50)], ids=["pinned", "rotating"])
def test_window_blocks_per_rank_equal_jax_shards(n, budget) -> None:
    """Each rank of a (2, 2) mesh stages the block (window rows x height
    stripe) that the JAX window's shard on that device holds; samples carry
    their id and rows their index."""
    batch_size, per_sample = 4, 10

    def fetch(idx):
        idx = np.asarray(idx)
        rows = np.arange(EVEN[0], dtype=np.uint8)[None, :, None, None]
        images = (idx.astype(np.uint8)[:, None, None, None] * 64 + rows
                  + np.zeros((1, 1, 2, 6), np.uint8))
        return {"input": images, "target": images[..., 0].astype(np.float16)}

    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:4], spatial=2)
    theirs = j_window.HBMWindowLoader(fetch, n, batch_size, jmesh, per_sample, budget * 4,
                                      seed=3)
    ours = [window.HBMWindowLoader(fetch, n, batch_size, torch.device("cpu"), per_sample,
                                   window.default_hbm_budget_bytes(budget / (1 << 30), 4),
                                   seed=3, mesh=mesh.Mesh(torch.device("cpu"), 4, r, spatial=2))
            for r in range(4)]
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
            for (images, targets), (j_images, j_targets) in zip(staged, jax_windows):
                np.testing.assert_array_equal(images.numpy(), _jax_blocks(j_images, jmesh)[r])
                np.testing.assert_array_equal(targets.numpy(),
                                              _jax_blocks(j_targets, jmesh)[r])


def test_shard_batch_gives_each_rank_its_block() -> None:
    batch = {"input": np.arange(5 * 48).reshape(5, 48, 1, 1) + np.zeros((1, 1, 2, 6)),
             "target": np.ones((5, 48, 2), np.float32)}
    blocks = [mesh.shard_batch_to_mesh(batch, mesh.Mesh(torch.device("cpu"), 4, r, spatial=2))
              for r in range(4)]
    assert [tuple(b["input"].shape) for b in blocks] == [(3, 32, 2, 6), (3, 16, 2, 6)] * 2
    assert [b["valid_mask"].tolist() for b in blocks] == [[True] * 3] * 2 + [
        [True, True, False]] * 2
    assert blocks[3]["input"][0, 0, 0, 0] == 3 * 48 + 32


def test_one_stripe_a_row_builds_no_halo(monkeypatch) -> None:
    """With one stripe a data row (``--spatial-devices 1``) the model has
    only plain 3x3 convolutions and no halo code runs: a step on a
    data-parallel rank's mesh needs no height and cuts no rows."""
    from stereo_depth_estimation_tpu_torch.models.unet import HaloConv2d
    from stereo_depth_estimation_tpu_torch.ops import halo

    monkeypatch.setattr(halo, "_exchange", lambda *a: pytest.fail("a halo exchange ran"))
    for spatial_group in (None, halo.SpatialGroup(None, 0, 1)):
        model = StereoUNet(base_channels=BASE, device="cpu", spatial_group=spatial_group)
        assert not any(isinstance(m, HaloConv2d) for m in model.modules())
    rank = mesh.Mesh(torch.device("cpu"), 2, 1)
    assert rank.spatial_group is None and rank.height_block(48) == (0, 48)
    batch = _batch(7, 4, UNEVEN)
    assert mesh.shard_batch_to_mesh(batch, rank)["input"].shape == (2, *UNEVEN, 6)
    model = StereoUNet(base_channels=BASE, device="cpu")
    state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), SEED)
    step = P.make_train_step(AugmentConfig(blur_prob=1.0), mesh.Mesh(torch.device("cpu")))
    _, stats = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(stats.valid_count) > 0


def test_seeds_follow_the_data_row() -> None:
    cpu = torch.device("cpu")
    assert P.rank_seed(7, mesh.Mesh(cpu, 2, 1, spatial=2)) == 7  # one data row
    row = [P.rank_seed(7, mesh.Mesh(cpu, 4, r, spatial=2)) for r in range(4)]
    assert row[0] == row[1] != row[2] == row[3]
    assert row[2] == P.rank_seed(7, mesh.Mesh(cpu, 2, 1))  # data row 1 = rank 1 of 2


# ---------------------------------------------------------------------------
# The CLIs.
# ---------------------------------------------------------------------------

def _trainer_flags(root: Path) -> list[str]:
    return ["--dataset-root", str(root / "data"), "--height", str(UNEVEN[0]), "--width",
            str(W), "--epochs", "1", "--batch-size", "4", "--val-fraction", "0.25",
            "--device", "cpu", "--compute-dtype", "float32", "--base-channels", str(BASE),
            "--num-workers", "0", "--log-every-batches", "2",
            "--mlflow-tracking-uri", str(root / "runs")]


@pytest.fixture(scope="module")
def trainer_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("trainer")
    write_dataset(root / "data", per_scene=6)
    return root


_TRAIN_CHILD = textwrap.dedent("""
    import json, os, sys
    pid, root, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from stereo_depth_estimation_tpu_torch.training import trainer
    summary = trainer.main(json.loads(sys.argv[4]) + [
        "--packed-cache-root", f"{root}/packed", "--output-dir", f"{root}/outputs",
        "--preview-samples", "2", "--multihost", "--spatial-devices", "2",
        "--coordinator-address", f"file://{root}/rendezvous",
        "--num-processes", "2", "--process-id", str(pid)])
    summary.pop("state")
    print("RESULT " + json.dumps(summary), flush=True)
    # Leave without the interpreter's teardown, where gloo's threads can
    # abort a finished child ("terminate called without an active exception").
    os._exit(0)
""")


def test_multihost_spatial_trainer_on_the_device_resident_set(trainer_root, tmp_path) -> None:
    """``--multihost --num-processes 2 --spatial-devices 2`` with the
    augmentation on, pinned on the packed cache: both ranks see the same
    global metrics, rank 0 alone writes the checkpoints and the previews,
    from whole images."""
    flags = _trainer_flags(trainer_root) + ["--mlflow-tracking-uri", str(tmp_path / "runs")]
    farm = run_farm(_TRAIN_CHILD, tmp_path, 2, json.dumps(flags))
    first, follower = (json.loads(line) for line, _ in farm)
    assert follower["run_id"] == "multihost-follower" != first["run_id"]
    assert first["device_resident"] == follower["device_resident"] == "pinned"
    assert first["global_step"] == follower["global_step"] == 2
    for a, b in zip(first["epochs"], follower["epochs"]):
        for key in ("train_mae", "val_mae", "val_nll"):
            assert a[key] == b[key] and np.isfinite(a[key]), key
    run = tmp_path / "outputs" / first["run_id"]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["best.pt", "last.pt"]
    previews = sorted((run / "mlflow_previews").rglob("*.png"))
    assert len(previews) == 2
    assert Image.open(previews[0]).size == (4 * W, UNEVEN[0])  # whole images
