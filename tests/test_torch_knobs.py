"""The StereoUNet's off-default knobs (``fused_block``, ``skip_impl``
"split"/"hybrid", ``remat``, ``bn_stats_dtype``) and flat AdamW
(``parallel/flat_adamw.py``), held against the port's default model and
optimizer and against the JAX package's counterparts on the CPU.

Base 4, 32x48, weights from the JAX package's init carried across by
``state_dict_from_jax``, seeded numpy inputs. Tolerances:

- a float32 knob against the port's default model (train-mode forward,
  gradients of one loss, BatchNorm running statistics): KNOB_TOL = 1e-5,
  the gradients relative to the model's largest gradient. The knobs sum
  in another order (two half convolutions, E[x^2] - E[x]^2 against
  PyTorch's two-pass variance); measured up to 1.3e-6;
- a float32 knob against the JAX model with the same knob:
  tests/test_torch_model.py's atol 1e-4 on outputs and running statistics,
  and 1e-4 of the largest gradient (measured 4e-5 and 2.4e-5);
- ``bn_stats_dtype=bfloat16`` against the JAX model with it: BF16_TOL =
  2e-2 on outputs, on gradients (of the largest) and on running
  statistics. Both round each layer's mean and mean square to bfloat16
  (2^-9 relative); a statistic within float noise of a rounding boundary
  rounds the other way in the other framework, and the network amplifies
  that step. Measured 6.8e-3, 5.0e-3 and 3.4e-3;
- ``remat`` leaves the running statistics exactly as the model without it
  (the recompute's second train-mode pass updates nothing): equal;
- flat AdamW against the JAX ``flat_adamw`` fed the same gradients for 5
  updates: parameters within 1e-6 (the same float32 formula); against
  ``torch.optim.AdamW`` fed the same gradients for 5 updates under a
  schedule: parameters within 2e-6 relative and 1e-7 absolute (JAX's
  tests/test_train_step.py::test_flat_adamw_matches_optax holds its two
  optimizers to those); one train step against the JAX step body with
  ``flat_adamw``: tests/test_torch_train_step.py's tolerances; a
  zero-valid batch: a no-op, exactly;
- ``fused_block`` and ``remat`` on a 1 x 2 spatial mesh of two gloo ranks
  against one rank of the default model: tests/test_torch_distributed.py's
  ``_assert_step_matches`` (1e-5 of the whole gradient, 1e-4 of a leaf).
"""

import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_distributed import _assert_step_matches
from test_torch_spatial import run_farm
from test_torch_train_step import (
    _assert_stats_close,
    _assert_weights_close,
    _batch,
    _torch_batch,
)

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.parallel import train_step as J
from stereo_depth_estimation_tpu.parallel.flat_adamw import flat_adamw
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import (
    load_torch_state_dict,
    state_dict_from_jax,
)
from stereo_depth_estimation_tpu_torch.parallel import train_step as P
from stereo_depth_estimation_tpu_torch.parallel.flat_adamw import make_flat_adamw
from stereo_depth_estimation_tpu_torch.training import checkpoint

BASE, HW = 4, (32, 48)
LR, WD = 1e-3, 1e-4
KNOB_TOL, JAX_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
# name -> the knob's keyword arguments (the dtype as a name, for both packages)
KNOBS = {
    "fused_block": {"fused_block": True},
    "split": {"skip_impl": "split"},
    "hybrid": {"skip_impl": "hybrid"},
    "remat": {"remat": True},
    "bn_stats_bf16": {"bn_stats_dtype": "bfloat16"},
}


def _kwargs(knob: str, dtypes) -> dict:
    return {k: getattr(dtypes, v) if k == "bn_stats_dtype" else v
            for k, v in KNOBS[knob].items()}


@pytest.fixture(scope="module")
def variables():
    model = JaxUNet(base_channels=BASE)
    return jax.jit(lambda key: model.init(key, jnp.zeros((2, *HW, 6)), train=False,
                                          return_uncertainty=True))(jax.random.key(0))


def _inputs() -> tuple[np.ndarray, np.ndarray]:
    x = np.random.default_rng(3).uniform(0, 1, (2, *HW, 6)).astype(np.float32)
    target = np.random.default_rng(4).uniform(0, 10, (2, *HW, 1)).astype(np.float32)
    return x, target


def _port(variables, **kwargs) -> StereoUNet:
    model = StereoUNet(base_channels=BASE, device="cpu", **kwargs)
    missing, unexpected = load_torch_state_dict(model, state_dict_from_jax(variables))
    assert not missing and not unexpected
    return model.train()


def _port_run(model: StereoUNet):
    """Train-mode outputs, the gradients of the JAX test's loss and the
    running statistics."""
    x, target = map(torch.from_numpy, _inputs())
    model.zero_grad(set_to_none=True)
    disp, logvar = model(x, return_uncertainty=True)
    (torch.abs(disp - target) * torch.exp(-logvar) + logvar).mean().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (disp.detach(), logvar.detach()), grads, stats


def _jax_run(variables, **kwargs):
    """The same through the JAX StereoUNet with ``kwargs``, in the port's
    key layout."""
    x, target = map(jnp.asarray, _inputs())
    model = JaxUNet(base_channels=BASE, **kwargs)

    def loss(params):
        (disp, logvar), updated = model.apply(
            {**variables, "params": params}, x, train=True, return_uncertainty=True,
            mutable=["batch_stats"])
        return jnp.mean(jnp.abs(disp - target) * jnp.exp(-logvar) + logvar), (
            disp, logvar, updated)

    with jax.default_matmul_precision("highest"):
        (_, (disp, logvar, updated)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"])
    stats = state_dict_from_jax({"params": variables["params"], **updated})
    stats = {k: v for k, v in stats.items() if k.endswith(("running_mean", "running_var"))}
    outs = (torch.from_numpy(np.array(disp)), torch.from_numpy(np.array(logvar)))
    return outs, state_dict_from_jax({"params": grads}), stats


def _assert_runs_close(got, want, tol: float) -> None:
    (outs, grads, stats), (w_outs, w_grads, w_stats) = got, want
    for a, b in zip(outs, w_outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol)
    scale = max(float(g.abs().max()) for g in w_grads.values())
    assert grads.keys() == w_grads.keys()
    for key, g in w_grads.items():
        assert float((grads[key] - g).abs().max()) <= tol * scale, key
    assert stats.keys() == w_stats.keys()
    for key, s in w_stats.items():
        np.testing.assert_allclose(stats[key].numpy(), s.numpy(), rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("knob", [k for k in KNOBS if k != "bn_stats_bf16"])
def test_float32_knob_equals_the_default_model(variables, knob) -> None:
    model = _port(variables, **_kwargs(knob, torch))
    assert model.state_dict().keys() == _port(variables).state_dict().keys()
    _assert_runs_close(_port_run(model), _port_run(_port(variables)), KNOB_TOL)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_equals_the_jax_model_with_it(variables, knob) -> None:
    tol = BF16_TOL if knob == "bn_stats_bf16" else JAX_TOL
    _assert_runs_close(_port_run(_port(variables, **_kwargs(knob, torch))),
                       _jax_run(variables, **_kwargs(knob, jnp)), tol)


@pytest.mark.parametrize("knob", ["fused_block", "hybrid"])
def test_knob_eval_forward_equals_the_default_model(variables, knob) -> None:
    x = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        want = _port(variables).eval()(x, return_uncertainty=True)
        got = _port(variables, **_kwargs(knob, torch)).eval()(x, return_uncertainty=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=KNOB_TOL)


@pytest.mark.parametrize("skip_impl", ["split", "hybrid"])
def test_fused_block_with_a_split_skip_raises(skip_impl) -> None:
    with pytest.raises(ValueError, match="fused_block takes skip_impl 'concat' only"):
        StereoUNet(base_channels=BASE, device="cpu", fused_block=True, skip_impl=skip_impl)


def test_remat_keeps_the_running_statistics_eager_and_compiled(variables) -> None:
    """A train step with ``remat`` (each block recomputed in the backward)
    leaves the weights and the running statistics the step without it
    leaves; compiled (aot_eager, fullgraph) too, in one graph."""
    from torch._dynamo.utils import counters

    batch = _torch_batch(_batch(1))
    states = {}
    for name, remat, options in (("plain", False, None), ("remat", True, None),
                                 ("compiled", True, P.CompileOptions(backend="aot_eager"))):
        model = _port(variables, remat=remat)
        torch._dynamo.reset()
        graphs = counters["stats"]["unique_graphs"]
        state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD),
                                     compile=options)
        states[name] = P.make_train_step(None)(state, batch)[0].model.state_dict()
        if options is not None:
            assert counters["stats"]["unique_graphs"] - graphs == 1
    for name in ("remat", "compiled"):
        for key, want in states["plain"].items():
            if key.endswith(("running_mean", "running_var", "num_batches_tracked")):
                assert torch.equal(states[name][key], want), (name, key)
            else:
                torch.testing.assert_close(states[name][key], want, rtol=0, atol=1e-6)
    assert int(states["remat"]["enc1.block.1.num_batches_tracked"]) == 1


def test_planted_hybrid_fault_is_caught(variables, monkeypatch) -> None:
    """A hybrid backward that swaps the two input gradients misses the
    default model's gradients by far more than KNOB_TOL."""
    from stereo_depth_estimation_tpu_torch.models import unet

    real = unet._ConcatConv.backward

    def swapped(ctx, dz):
        d_up, d_skip, dw, none = real(ctx, dz)
        return d_skip, d_up, dw, none

    monkeypatch.setattr(unet._ConcatConv, "backward", staticmethod(swapped))
    got = _port_run(_port(variables, skip_impl="hybrid"))[1]
    want = _port_run(_port(variables))[1]
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(float((got[k] - g).abs().max()) for k, g in want.items()) / scale
    assert worst > 100 * KNOB_TOL


# -- flat AdamW -----------------------------------------------------------

def test_flat_adamw_equals_jax_flat_adamw_on_the_same_gradients() -> None:
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i for k, s in shapes.items()}
             for i in range(5)]
    tx = flat_adamw(LR, WD)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    tensors = [torch.from_numpy(params[k].copy()).requires_grad_() for k in shapes]
    opt = make_flat_adamw(tensors, LR, WD)
    for g in grads:
        updates, opt_state = update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for t, k in zip(tensors, shapes):
            t.grad = torch.from_numpy(g[k])
        opt.step()
    assert int(opt_state.count) == float(opt.count) == 5
    for t, k in zip(tensors, shapes):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(opt.mu.numpy(), np.asarray(opt_state.mu), rtol=1e-6, atol=1e-9)


def _state(variables, factory) -> P.TrainState:
    model = _port(variables)
    return P.create_train_state(model, factory(model.parameters(), LR, WD), 0)


def test_flat_adamw_updates_equal_adamw_updates() -> None:
    """Five updates from the same gradients under a warmup-cosine schedule
    (the train step sets the learning rate from the update count): the two
    forms of AdamW's update round differently, nothing else. (Over real
    train steps the two trajectories part after the first: where a gradient
    is float noise, AdamW's next update lands anywhere in [-lr, lr].)"""
    rng = np.random.default_rng(1)
    shapes = [(8, 4, 3, 3), (8,), (1, 8, 1, 1)]
    start = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** -i for s in shapes]
             for i in range(5)]
    params = {}
    for name, factory in (("flat", make_flat_adamw), ("adamw", P.make_adamw)):
        tensors = [torch.from_numpy(a.copy()).requires_grad_() for a in start]
        opt = factory(tensors, LR, WD, "cosine", total_steps=6, warmup_steps=2)
        for g in grads:
            for t, gi in zip(tensors, g):
                t.grad = torch.from_numpy(gi)
            P._set_learning_rate(opt)
            opt.step()
        params[name] = tensors
        assert float(opt.state[tensors[0]]["step"]) == 5.0
    for a, b in zip(params["flat"], params["adamw"]):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-7)


def test_flat_adamw_step_matches_the_jax_step_body(variables) -> None:
    model = JaxUNet(base_channels=BASE)
    tx = flat_adamw(LR, WD)
    jstate = jax.jit(lambda key: J.create_train_state(model, key, HW, tx))(jax.random.key(0))
    batch = _batch(1)
    with jax.default_matmul_precision("highest"):
        jnew, jstats = jax.jit(J._make_step_body(model, tx, None))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = _state({"params": jstate.params, "batch_stats": jstate.batch_stats},
                   make_flat_adamw)
    state, stats = P.make_train_step(None)(state, _torch_batch(batch))
    _assert_stats_close(stats, jstats)
    # _assert_weights_close reads the first step's gradient from optax's mu:
    # here it is the flat mu, unravelled into the parameter tree.
    _, unravel = ravel_pytree(jstate.params)
    view = SimpleNamespace(params=jnew.params, batch_stats=jnew.batch_stats,
                           opt_state=[SimpleNamespace(mu=unravel(jnew.opt_state.mu))])
    _assert_weights_close(state, view)


def test_flat_adamw_zero_valid_batch_is_a_noop(variables, tmp_path) -> None:
    state = _state(variables, make_flat_adamw)
    step = P.make_train_step(None)
    state, _ = step(state, _torch_batch(_batch(1)))
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = (state.optimizer.mu.clone(), state.optimizer.nu.clone())
    batch = _batch(2)
    batch["target"][:] = 0.0
    state, stats = step(state, _torch_batch(batch))
    assert float(stats.valid_count) == 0.0 and float(state.optimizer.count) == 1.0
    for key, value in weights.items():
        assert torch.equal(state.model.state_dict()[key], value), key
    assert torch.equal(state.optimizer.mu, moments[0])
    assert torch.equal(state.optimizer.nu, moments[1])
    # Its state saves in torch.optim.AdamW's per-parameter layout and loads
    # back into the flat buffers.
    path = checkpoint.save_checkpoint(tmp_path, "last", state, epoch=1, config={}, metrics={})
    saved = torch.load(path, weights_only=False)["optimizer_state_dict"]["state"]
    params = list(state.model.parameters())
    assert len(saved) == len(params)
    assert all(saved[i]["exp_avg"].shape == p.shape and float(saved[i]["step"]) == 1.0
               for i, p in enumerate(params))
    fresh = _state(variables, make_flat_adamw)
    checkpoint.load_train_state(path, fresh)
    assert torch.equal(fresh.optimizer.mu, moments[0])
    assert torch.equal(fresh.optimizer.nu, moments[1])
    assert float(fresh.optimizer.count) == 1.0


# -- fused_block and remat on a spatial mesh ------------------------------

_CHILD = textwrap.dedent("""
    import sys
    rank, root, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from stereo_depth_estimation_tpu_torch.models import StereoUNet
    from stereo_depth_estimation_tpu_torch.parallel import train_step as P
    from stereo_depth_estimation_tpu_torch.parallel.distributed import initialize_multihost
    from stereo_depth_estimation_tpu_torch.parallel.mesh import make_mesh, shard_batch_to_mesh

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    initialize_multihost(f"file://{root}/rendezvous", 2, rank, device=cpu)
    mesh = make_mesh(cpu, spatial=2)
    model = StereoUNet(base_channels=4, device=cpu, bn_group=mesh.group,
                       spatial_group=mesh.spatial_group, fused_block=True, remat=True)
    model.load_state_dict(torch.load(f"{root}/init.pt"), strict=False)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), 1e-3, 1e-4), 5, mesh)
    data = np.load(f"{root}/batch.npz")
    batch = shard_batch_to_mesh({"input": data["input"], "target": data["target"]}, mesh)
    state, stats = P.make_train_step(None, mesh)(state, batch)
    torch.save({"stats": [float(s) for s in stats],
                "weights": {k: v.clone() for k, v in model.state_dict().items()},
                "grads": {k: p.grad.clone() for k, p in model.named_parameters()}},
               f"{root}/rank{rank}.pt")
    print("RESULT ok", flush=True)
""")


def test_fused_remat_spatial_step_equals_one_rank(variables, tmp_path) -> None:
    """Two ranks as a 1 x 2 mesh (stripes of 32 and 16 rows), every block
    fused and recomputed, the halo pads outside the fused function: one step
    equals one rank's step of the default model over the whole images."""
    init = state_dict_from_jax(variables)
    torch.save(init, tmp_path / "init.pt")
    batch = _batch(7)
    batch = {"input": np.concatenate([batch["input"]] * 2, axis=1)[:, :48],
             "target": np.concatenate([batch["target"]] * 2, axis=1)[:, :48]}
    np.savez(tmp_path / "batch.npz", **batch)
    run_farm(_CHILD, tmp_path, 2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["stats"] == ranks[1]["stats"]
    model = StereoUNet(base_channels=BASE, device="cpu")
    model.load_state_dict(init, strict=False)
    state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), 5)
    state, stats = P.make_train_step(None)(state, _torch_batch(batch))
    got = ranks[0]
    _assert_step_matches(got["stats"], got["grads"], got["weights"], state, stats)
    for key, value in ranks[1]["weights"].items():
        assert torch.equal(value, got["weights"][key]), key

