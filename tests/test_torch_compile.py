"""The port's compiled training step (``--compile``) and its compile cache on
the CPU, held against the eager port and the JAX package.

- The four kernels are ``torch.library`` custom ops: ``opcheck`` runs each
  one's schema, fake, autograd and AOT-dispatch tests on CPU tensors.
- ``torch.compile(model, fullgraph=True)`` traces the StereoUNet in one
  graph. Under ``aot_eager`` (no code generation) its forward and gradients
  equal the eager port's within 1e-6, its forward the JAX StereoUNet's
  within tests/test_torch_model.py's 1e-4, and a compiled train step meets
  ``tests/test_torch_train_step.py``'s tolerances against the JAX step
  body. Under Inductor on the CPU (C++ kernels built with g++) forward and
  gradients stay within 1e-5 of eager (gradients relative to the model's
  largest gradient): the generated kernels fuse and sum in another order.
- The trainer CLI with ``--compile --compile-backend aot_eager`` gives the
  eager run's metrics within 1e-5, and its checkpoints carry the plain
  reference keys, which the JAX package's loader reads and its evaluate CLI
  scores as the port scored them (1e-4, the serving tests' tolerance).
- ``parallel/aot_cache.py``'s directory rule is the JAX module's; a cache
  directory that is not private is not loaded, a corrupt blob is compiled
  anew, and pruning keeps ``SDE_AOT_CACHE_KEEP`` blobs.
- In bf16 the model's zero-padded channels (``models/unet.py``) trace into
  the one graph, which its padded-convolution count does not recompile, and
  the compiled model equals the eager one within 1e-6.
Base 4, 32x48, float32 but for that case.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_data import make_dataset
from test_torch_train_step import (
    _assert_stats_close,
    _assert_weights_close,
    _batch,
    _torch_batch,
    _variables,
)

from stereo_depth_estimation_tpu.eval import evaluate as jax_evaluate
from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.models.compat import export_torch_state_dict
from stereo_depth_estimation_tpu.parallel import aot_cache as jax_aot_cache
from stereo_depth_estimation_tpu.parallel import train_step as J
from stereo_depth_estimation_tpu.training.checkpoint import load_model_variables as jax_load
from stereo_depth_estimation_tpu_torch.models import StereoUNet, unet
from stereo_depth_estimation_tpu_torch.models.compat import (
    load_torch_state_dict,
    state_dict_from_jax,
)
from stereo_depth_estimation_tpu_torch.ops import augment_cuda, pool
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig, sample_factors
from stereo_depth_estimation_tpu_torch.parallel import aot_cache
from stereo_depth_estimation_tpu_torch.parallel import train_step as P
from stereo_depth_estimation_tpu_torch.training import trainer

BASE, HW = 4, (32, 48)
LR, WD = 1e-3, 1e-4
AOT_EAGER_TOL = 1e-6  # the same aten ops in the same order: equal in practice
INDUCTOR_TOL = 1e-5  # generated kernels fuse and sum in another order
METRIC_RTOL = 1e-5


def _op_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 12, 16), generator=g)
    y, idx = pool.maxpool2x2_fwd_plain(x)
    images = torch.randint(0, 256, (2, 10, 14, 6), dtype=torch.uint8, generator=g)
    factors = sample_factors(g, 4, AugmentConfig(blur_prob=1.0))
    packed = augment_cuda._pack_factors(images, factors, 2)
    return {
        "maxpool2x2_fwd f32": (pool.maxpool2x2_fwd, (x.requires_grad_(),), {}),
        "maxpool2x2_fwd bf16": (pool.maxpool2x2_fwd,
                                (x.detach().bfloat16().requires_grad_(),), {}),
        "maxpool2x2_bwd": (pool.maxpool2x2_bwd, (torch.randn_like(y), idx), {}),
        "pointwise_chain": (augment_cuda.pointwise_chain, (images, packed, 5),
                            {"out_dtype": torch.bfloat16}),
        "gray_means": (augment_cuda.gray_means, (images, factors["brightness"]), {}),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_custom_ops_pass_opcheck(name) -> None:
    op, args, kwargs = _op_cases()[name]
    torch.library.opcheck(op, args, kwargs)


@pytest.fixture(scope="module")
def jax_setup():
    model = JaxUNet(base_channels=BASE)
    tx = J.make_adamw(LR, WD)
    init = jax.jit(lambda key: J.create_train_state(model, key, HW, tx))
    return model, tx, init(jax.random.key(0))


def _port_model(jax_state) -> StereoUNet:
    model = StereoUNet(base_channels=BASE, device="cpu")
    missing, unexpected = load_torch_state_dict(model, state_dict_from_jax(_variables(jax_state)))
    assert not missing and not unexpected
    return model


def _forward_and_grads(module: torch.nn.Module, model: StereoUNet, x: torch.Tensor):
    """Train-mode forward with uncertainty, then the gradients of a fixed
    weighted sum of both heads; returns outputs, gradients and buffers."""
    model.zero_grad(set_to_none=True)
    disp, logvar = module(x, return_uncertainty=True)
    w = torch.linspace(-1.0, 1.0, disp.numel()).reshape(disp.shape)
    ((disp * w).sum() + (logvar * w).square().sum()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return (disp.detach(), logvar.detach()), grads, buffers


def _assert_close(got, want, tol: float) -> None:
    (outs, grads, buffers), (w_outs, w_grads, w_buffers) = got, want
    for a, b in zip(outs, w_outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)
    # Gradients on the model's own scale, its largest gradient: a bias's
    # gradient is a sum over every pixel with cancellation, which another
    # summation order moves by ~2e-5 of its own size under Inductor.
    scale = max(float(g.abs().max()) for g in w_grads.values())
    for key, g in w_grads.items():
        assert float((grads[key] - g).abs().max()) <= tol * scale, key
    for key, b in w_buffers.items():
        np.testing.assert_allclose(buffers[key].numpy(), b.numpy(), rtol=tol, atol=tol,
                                   err_msg=key)


def _assert_forward_matches_jax(jax_state, x: torch.Tensor, outs) -> None:
    """Train-mode outputs against the JAX StereoUNet from the same variables:
    tests/test_torch_model.py's float32 tolerance, atol 1e-4."""
    (jdisp, jlogvar), _ = JaxUNet(base_channels=BASE).apply(
        _variables(jax_state), jnp.asarray(x.numpy()), train=True, return_uncertainty=True,
        mutable=["batch_stats"])
    for got, want in zip(outs, (jdisp, jlogvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _compiled_vs_eager(jax_state, backend: str):
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, *HW, 6)).astype(np.float32))
    model = _port_model(jax_state)
    want = _forward_and_grads(model, model, x)
    model = _port_model(jax_state)
    torch._dynamo.reset()
    from torch._dynamo.utils import counters

    graphs = counters["stats"]["unique_graphs"]
    compiled = P.compile_model(model, P.CompileOptions(backend=backend))
    got = _forward_and_grads(compiled, model, x)
    _assert_forward_matches_jax(jax_state, x, got[0])
    return got, want, counters["stats"]["unique_graphs"] - graphs


def test_aot_eager_model_is_one_graph_equal_to_eager_and_jax(jax_setup) -> None:
    got, want, graphs = _compiled_vs_eager(jax_setup[2], "aot_eager")
    assert graphs == 1  # fullgraph: the pools stay in the graph as custom ops
    _assert_close(got, want, AOT_EAGER_TOL)


def test_inductor_model_equals_eager_and_jax(jax_setup) -> None:
    got, want, graphs = _compiled_vs_eager(jax_setup[2], "xla")  # "xla" names Inductor
    assert graphs == 1
    _assert_close(got, want, INDUCTOR_TOL)


def test_aot_eager_bf16_model_pads_in_its_graph_and_equals_eager() -> None:
    """bf16 compute: the input's zero channels, enc1's padded weight and the
    heads' padded weight (``models/unet.py``) are three ``F.pad`` calls in
    the one graph, which the padded-convolution count does not recompile
    (an eager forward counts 2, a compiled call none); outputs, gradients
    and running statistics after two calls equal the eager model's."""
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, *HW, 6)).astype(np.float32))

    def model():
        return StereoUNet(base_channels=BASE, compute_dtype=torch.bfloat16, device="cpu",
                          generator=torch.Generator().manual_seed(4))

    eager = model()
    _forward_and_grads(eager, eager, x)
    before = unet.padded_convs.launches
    want = _forward_and_grads(eager, eager, x)
    assert unet.padded_convs.launches - before == 2
    pads = []

    def backend(gm, example_inputs):
        pads.append(sum(getattr(n.target, "__name__", "") == "pad" for n in gm.graph.nodes))
        return torch._dynamo.lookup_backend("aot_eager")(gm, example_inputs)

    port = model()
    torch._dynamo.reset()
    compiled = P.compile_model(port, P.CompileOptions(backend=backend))
    _forward_and_grads(compiled, port, x)
    before = unet.padded_convs.launches
    got = _forward_and_grads(compiled, port, x)
    assert unet.padded_convs.launches == before
    assert pads == [3]  # one graph, compiled once
    _assert_close(got, want, AOT_EAGER_TOL)


def test_compiled_step_matches_jax_step_body_f32(jax_setup) -> None:
    """One compiled train step (aot_eager; augmentation, loss, gate and AdamW
    eager) against the JAX step body: tests/test_torch_train_step.py's
    tolerances. Then the compiled eval step (a second graph) against JAX's."""
    model, tx, jstate = jax_setup
    batch = _batch(1)
    body = jax.jit(J._make_step_body(model, tx, None))
    with jax.default_matmul_precision("highest"):
        jnew, jstats = body(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port_model(jstate)
    torch._dynamo.reset()
    state = P.create_train_state(port, P.make_adamw(port.parameters(), LR, WD), 0,
                                 compile=P.CompileOptions(backend="aot_eager"))
    assert state.compiled is not None and state.replica is None
    state, stats = P.make_train_step(None)(state, _torch_batch(batch))
    _assert_stats_close(stats, jstats)
    _assert_weights_close(state, jnew)
    assert next(iter(state.model.state_dict())) == "enc1.block.0.weight"  # plain keys

    eval_batch = _batch(2)
    jeval = jax.jit(J.make_eval_step(model))(
        jnew, {k: jnp.asarray(v) for k, v in eval_batch.items()})
    _assert_stats_close(P.make_eval_step()(state, _torch_batch(eval_batch)), jeval)


def test_a_compile_failure_raises() -> None:
    """A backend that fails makes the step raise: nothing falls back to the
    eager model."""

    def broken(gm, example_inputs):
        raise RuntimeError("planted compiler failure")

    model = StereoUNet(base_channels=BASE, device="cpu")
    torch._dynamo.reset()
    state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), 0,
                                 compile=P.CompileOptions(backend=broken))
    with pytest.raises(Exception, match="planted compiler failure"):
        P.make_train_step(None)(state, _torch_batch(_batch(1)))
    with pytest.raises(Exception, match="Invalid backend"):
        P.compile_model(model, P.CompileOptions(backend="no-such-backend"))


def _trainer_flags(root: Path, *extra: str) -> list[str]:
    return [
        "--dataset-root", str(root / "data"), "--height", str(HW[0]), "--width", str(HW[1]),
        "--epochs", "2", "--batch-size", "4", "--val-fraction", "0.25", "--device", "cpu",
        "--compute-dtype", "float32", "--base-channels", str(BASE), "--no-augment",
        "--preview-samples", "1", "--log-every-batches", "2", "--num-workers", "0",
        "--init-checkpoint", str(root / "init.pt"), *extra,
    ]


def test_compiled_trainer_matches_eager_with_plain_checkpoints(tmp_path, jax_setup) -> None:
    make_dataset(tmp_path / "data", scenes=(("scene_a", 12),))  # 9 train, 3 val
    torch.save({"model_state_dict": _port_model(jax_setup[2]).state_dict(), "epoch": 0},
               tmp_path / "init.pt")
    runs = {}
    for name, extra in (("eager", ()), ("compiled", ("--compile", "--compile-backend",
                                                     "aot_eager", "--aot-cache", "off"))):
        torch._dynamo.reset()
        runs[name] = trainer.main(_trainer_flags(
            tmp_path, "--mlflow-tracking-uri", str(tmp_path / f"{name}_runs"),
            "--output-dir", str(tmp_path / name), *extra))
    eager, compiled = runs["eager"], runs["compiled"]
    assert compiled["state"].compiled is not None and eager["state"].compiled is None
    assert compiled["global_step"] == eager["global_step"] == 2 * 3
    for a, b in zip(compiled["epochs"], eager["epochs"]):
        for key in (k for k in b if k.startswith(("train_", "val_"))):
            np.testing.assert_allclose(a[key], b[key], rtol=METRIC_RTOL, err_msg=key)

    last = {name: torch.load(Path(r["checkpoints_dir"]) / "last.pt", weights_only=False)
            for name, r in runs.items()}
    keys = list(last["compiled"]["model_state_dict"])
    assert keys == list(last["eager"]["model_state_dict"])
    assert not any("_orig_mod" in k for k in keys)
    assert last["compiled"]["optimizer_state_dict"].keys() == \
        last["eager"]["optimizer_state_dict"].keys()

    # The JAX package reads it: the loader its export and evaluate use takes
    # every key, and the export's conversion gives the checkpoint back.
    path = Path(compiled["checkpoints_dir"]) / "last.pt"
    template = JaxUNet(base_channels=BASE).init(
        jax.random.key(0), jnp.zeros((1, *HW, 6)), train=False, return_uncertainty=True)
    variables, meta = jax_load(path, template)
    assert meta["epoch"] == 2 and not meta["missing_keys"] and not meta["unexpected_keys"]
    for key, value in export_torch_state_dict(variables).items():
        np.testing.assert_array_equal(
            value, last["compiled"]["model_state_dict"][key].numpy(), err_msg=key)
    # The JAX evaluate CLI scores the checkpoint as the port's trainer
    # scored its last epoch on the same split.
    argv = ["--checkpoint", str(path), "--height", str(HW[0]), "--width", str(HW[1]),
            "--base-channels", str(BASE), "--dataset-root", str(tmp_path / "data"),
            "--split", "val", "--val-fraction", "0.25", "--batch-size", "4",
            "--num-workers", "0", "--aot-cache", "off", "--mesh-devices", "1"]
    score = jax_evaluate.evaluate(jax_evaluate.build_parser().parse_args(argv))
    assert score["checkpoint_epoch"] == 2
    for key in ("mae", "rmse", "nll"):
        np.testing.assert_allclose(score[key], compiled["epochs"][-1][f"val_{key}"],
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("arg", ["auto", "off", "some/dir"])
def test_resolve_aot_dir_equals_jax(arg, tmp_path) -> None:
    assert aot_cache.resolve_aot_dir(arg, tmp_path) == jax_aot_cache.resolve_aot_dir(arg, tmp_path)


def _blob(cache_dir: Path, name: str) -> Path:
    path = cache_dir / f"aot_{name}.bin"
    path.write_bytes(b"not a cache artifact")
    return path


def test_unsafe_cache_is_not_loaded_and_a_corrupt_blob_is_recompiled(tmp_path, capsys) -> None:
    cache = aot_cache.CompileCache(tmp_path / "cache", "d1")
    assert not cache.load()  # nothing there yet: the directory is made private
    assert (tmp_path / "cache").stat().st_mode & 0o777 == 0o700
    blob = _blob(tmp_path / "cache", "d1")
    (tmp_path / "cache").chmod(0o770)  # group-writable: refused, left alone
    assert not cache.load() and blob.exists()
    assert "refusing to load" in capsys.readouterr().err
    (tmp_path / "cache").chmod(0o700)
    blob.chmod(0o666)
    assert not cache.load() and blob.exists()
    blob.chmod(0o600)
    assert not cache.load() and not cache.loaded  # corrupt: deleted, compile anew
    assert not blob.exists() and "deleting it" in capsys.readouterr().err

    # The step still runs and, once finished, reports that it compiled.
    step = cache.wrap(lambda x: x + 1, "step")
    assert step(1) == 2 and step(2) == 3
    cache.finish()
    assert cache.reports["step"]["source"] in ("compiled", "compiled-unsaved")


def test_pruning_keeps_the_most_recent_blobs(tmp_path, monkeypatch) -> None:
    import os

    monkeypatch.setenv("SDE_AOT_CACHE_KEEP", "3")
    blobs = [_blob(tmp_path, f"b{i}") for i in range(6)]
    for i, path in enumerate(blobs):
        os.utime(path, (1000 + i, 1000 + i))
    aot_cache.prune_lru(tmp_path, keep=blobs[0])  # the blob just saved stays
    assert sorted(p.name for p in tmp_path.glob("aot_*.bin")) == sorted(
        p.name for p in (blobs[0], *blobs[3:]))
    monkeypatch.setenv("SDE_AOT_CACHE_KEEP", "0")  # 0: no pruning
    aot_cache.prune_lru(tmp_path, keep=blobs[0])
    assert len(list(tmp_path.glob("aot_*.bin"))) == 4


def test_digest_separates_settings() -> None:
    cpu = torch.device("cpu")
    base = {"compile_mode": "default", "compile_backend": "xla", "base_channels": 32,
            "compute_dtype": "bfloat16", "ranks": 2, "rank": 0}
    digest = aot_cache.cache_digest(base, cpu)
    assert digest == aot_cache.cache_digest(dict(base), cpu)
    for key, value in (("rank", 1), ("compile_mode", "max-autotune"), ("base_channels", 16)):
        assert aot_cache.cache_digest({**base, key: value}, cpu) != digest
