"""Batch-statistic BatchNorm + ReLU on the kernels of ``ops/batchnorm.py``
(BN1-BN4), held against the JAX package and PyTorch's own BatchNorm on the
CPU, where every op runs its plain version.

The same numpy inputs go through both. Tolerances:

- BN1's statistics against the flax ``BatchNorm``'s (its running statistics
  after one step at momentum 1: the batch mean, and the unbiased variance,
  taken back to the biased one): float32 within 1e-6 relative to the mean
  square E[x^2] (the sums add in another order); bf16 statistics within one
  bf16 ulp of each mean (both round the float32 mean to bf16, and a mean
  within float noise of a rounding boundary goes the other way);
- ``_BatchNormReLU`` forward and backward against the flax ``BatchNorm`` +
  ReLU under ``jax.vjp``, and ``_FusedConvBNReLU`` against JAX
  ``_fused_conv_bn_relu`` (matmul precision highest), float32: 1e-5 of each
  output's largest magnitude (sums in another order; measured ~1e-7);
- the folded epilogue's plain version against the textbook formulas below
  (``_moments``, ``_scale``, ``_update_running``, ``_dz_coefficients``) on
  the same sums: bitwise, but for the values through 1 / sqrt(var + eps),
  which the epilogue rounds twice (as the kernel does) and ``torch.rsqrt``
  once more or less: within EPILOGUE_RTOL;
- ``opcheck`` on each op (schema, fake, dispatch, mutated buffers);
- a ``ConvBlock`` compiled (aot_eager, fullgraph) against eager: one graph,
  outputs, gradients and running statistics within 1e-6 (the same ops in
  the same order);
- a ConvBlock and a whole default StereoUNet in training against copies
  whose BatchNorms are ``nn.BatchNorm2d`` then ReLU: within 1e-5
  (E[x^2] - E[x]^2 against a two-pass variance).
"""

from copy import deepcopy as copy_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import unet as J
from stereo_depth_estimation_tpu_torch.models import ConvBlock, StereoUNet
from stereo_depth_estimation_tpu_torch.models import unet as U
from stereo_depth_estimation_tpu_torch.ops import batchnorm

EPS = 1e-5
MOMENTUM = 0.1
TOL = 1e-5
COMPILE_TOL = 1e-6
EPILOGUE_RTOL = 1e-6  # a few float32 ulps


# The textbook per-channel arithmetic of a batch-statistic BatchNorm, as
# separate PyTorch ops: what the kernels' epilogue computes.


def _moments(total: torch.Tensor, c: int):
    """(mean, var, n) from BN1's (2C + 1) sums; var = E[x^2] - E[x]^2."""
    n = total[2 * c]
    mean = total[:c] / n
    return mean, total[c:2 * c] / n - mean * mean, n


def _scale(var, gamma, eps: float = EPS):
    return torch.rsqrt(var + eps) * gamma


def _update_running(running_mean, running_var, tracked, mean, var, n, m: float = MOMENTUM):
    """nn.BatchNorm2d's running update: the biased ``var`` goes in unbiased."""
    tracked.add_(1)
    unbiased = var * (n / (n - 1.0).clamp(min=1.0))
    running_mean.mul_(1.0 - m).add_(m * mean)
    running_var.mul_(1.0 - m).add_(m * unbiased)


def _dz_coefficients(total, inv, scale, n):
    """BN4's t1 and t2 from BN3's sums: dbeta = the first sum, dgamma = the
    second times inv."""
    c = total.shape[0] // 2
    dbeta, dgamma = total[:c], total[c:] * inv
    return scale * (dbeta / n), scale * (inv * dgamma / n)


def _running(c: int):
    """Fresh (running_mean, running_var, num_batches_tracked)."""
    return torch.zeros(c), torch.ones(c), torch.zeros((), dtype=torch.long)


def _x(shape, seed: int, shift: float = 0.7) -> np.ndarray:
    """NHWC float32 normals with a per-channel offset."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 1.5, shape) + shift * rng.normal(size=shape[-1])).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the channels_last (N, C, H, W) view the model holds."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _flax_stats(x: np.ndarray, stats_dtype) -> tuple[np.ndarray, np.ndarray]:
    """(mean, biased var) of the flax BatchNorm's training statistics."""
    bn = J.BatchNorm(momentum=1.0, stats_dtype=stats_dtype)
    variables = bn.init(jax.random.key(0), jnp.asarray(x), use_running_average=True)
    _, updated = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    n = x.size // x.shape[-1]
    mean = np.asarray(updated["batch_stats"]["mean"])
    var = np.asarray(updated["batch_stats"]["var"]).astype(np.float64) * (n - 1) / n
    return mean, var


def test_bn_stats_f32_equal_flax_statistics() -> None:
    x = _x((2, 12, 20, 6), seed=0)
    total = batchnorm.bn_stats(batchnorm.rows(_nchw(x)), False)
    assert total.shape == (13,) and float(total[12]) == 2 * 12 * 20
    mean, var, _ = _moments(total, 6)
    want_mean, want_var = _flax_stats(x, jnp.float32)
    scale = (x.astype(np.float64) ** 2).mean(axis=(0, 1, 2))
    np.testing.assert_array_less(np.abs(mean.numpy() - want_mean), 1e-6 * scale)
    np.testing.assert_array_less(np.abs(var.numpy() - want_var), 1e-6 * scale)


def test_bn_stats_bf16_means_within_one_ulp_of_flax() -> None:
    x = _x((2, 12, 20, 6), seed=1)
    n = 2 * 12 * 20
    total = batchnorm.bn_stats(batchnorm.rows(_nchw(x)), True)
    mean, mean_sq = (total[:6] / n).numpy(), (total[6:12] / n).numpy()
    want_mean, want_var = _flax_stats(x, jnp.bfloat16)
    want_sq = want_var + want_mean.astype(np.float64) ** 2
    for got, want in ((mean, want_mean), (mean_sq, want_sq)):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert np.all(np.abs(got - want) <= ulp * (1 + 1e-3)), (got, want)
        # The means are bf16 values.
        assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())


def _flax_bn_relu(x, scale, bias, dy, relu: bool):
    """flax BatchNorm (+ ReLU) under jax.vjp: y, the gradients of x, the
    scale and the bias for the cotangent ``dy``, and the running mean and
    var after the step."""
    bn = J.BatchNorm()

    def f(xx, s, b):
        variables = {"params": {"scale": s, "bias": b},
                     "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
        y, updated = bn.apply(variables, xx, use_running_average=False,
                              mutable=["batch_stats"])
        return (jax.nn.relu(y) if relu else y), updated["batch_stats"]

    y, vjp, running = jax.vjp(f, *map(jnp.asarray, (x, scale, bias)), has_aux=True)
    return (y, *vjp(jnp.asarray(dy)), running["mean"], running["var"])


def _assert_close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * scale, f"{what}: {err} of {scale}"


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_batchnorm_relu_forward_and_backward_equal_flax(relu) -> None:
    x = _x((2, 12, 20, 6), seed=2)
    dy = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    rng = np.random.default_rng(4)
    scale = (1.0 + 0.3 * rng.normal(size=6)).astype(np.float32)
    bias = (0.3 * rng.normal(size=6)).astype(np.float32)
    want = _flax_bn_relu(x, scale, bias, dy, relu)

    xt = _nchw(x).clone(memory_format=torch.channels_last).requires_grad_()
    gamma = torch.from_numpy(scale).requires_grad_()
    beta = torch.from_numpy(bias).requires_grad_()
    running_mean, running_var, tracked = _running(6)
    y = U._BatchNormReLU.apply(xt, gamma, beta, running_mean, running_var, tracked, EPS,
                               MOMENTUM, False, None, relu)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert int(tracked) == 1
    y.backward(_nchw(dy))
    _assert_close(y.permute(0, 2, 3, 1), want[0], "y")
    _assert_close(xt.grad.permute(0, 2, 3, 1), want[1], "dx")
    _assert_close(gamma.grad, want[2], "dscale")
    _assert_close(beta.grad, want[3], "dbias")
    _assert_close(running_mean, want[4], "running mean")
    _assert_close(running_var, want[5], "running var")
    if relu:
        assert float((y == 0).float().mean()) > 0.2  # the mask matters


def test_fused_conv_bn_relu_equals_jax_forward_and_vjp() -> None:
    x = _x((2, 12, 20, 5), seed=5, shift=0.0)
    rng = np.random.default_rng(6)
    kernel = (0.3 * rng.normal(size=(3, 3, 5, 6))).astype(np.float32)
    scale = (1.0 + 0.3 * rng.normal(size=6)).astype(np.float32)
    bias = (0.3 * rng.normal(size=6)).astype(np.float32)
    dy = rng.normal(size=(2, 12, 20, 6)).astype(np.float32)
    cfg = J._FusedBNConfig(eps=EPS, compute_dtype=jnp.float32, stats_dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        (y, mean, var), vjp = jax.vjp(lambda *a: J._fused_conv_bn_relu(cfg, *a),
                                      *map(jnp.asarray, (x, kernel, scale, bias)))
        dx, dkernel, dscale, dbias = vjp((jnp.asarray(dy), jnp.zeros(6), jnp.zeros(6)))

    xt = _nchw(x).clone(memory_format=torch.channels_last).requires_grad_()
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_()
    gamma = torch.from_numpy(scale).requires_grad_()
    beta = torch.from_numpy(bias).requires_grad_()
    # At momentum 1 the running buffers take the batch's mean and unbiased var.
    running_mean, running_var, tracked = _running(6)
    yt = U._FusedConvBNReLU.apply(xt, weight, gamma, beta, running_mean, running_var, tracked,
                                  (1, 1), EPS, 1.0, False, None)
    yt.backward(_nchw(dy))
    n = x.size // 5
    assert int(tracked) == 1
    _assert_close(yt.permute(0, 2, 3, 1), y, "y")
    _assert_close(running_mean, mean, "mean")
    _assert_close(running_var * ((n - 1) / n), var, "var")
    _assert_close(xt.grad.permute(0, 2, 3, 1), dx, "dx")
    _assert_close(weight.grad.permute(2, 3, 1, 0), dkernel, "dkernel")
    _assert_close(gamma.grad, dscale, "dscale")
    _assert_close(beta.grad, dbias, "dbias")


def _op_cases():
    g = torch.Generator().manual_seed(0)
    m, c = 60, 6
    x = torch.randn((m, c), generator=g)
    dy = torch.randn((m, c), generator=g)
    gamma, beta = 1.0 + 0.2 * torch.randn((c,), generator=g), torch.randn((c,), generator=g)
    stats = batchnorm.bn_moments_plain(batchnorm.bn_stats_plain(x, False), gamma, *_running(c),
                                       EPS, MOMENTUM)
    coef = batchnorm.bn_relu_backward_plain(dy, x, stats, beta, EPS, True)[1]
    sums = batchnorm.bn_relu_bwd_sums_plain(dy, x, stats, beta, True)
    xb, dyb = x.bfloat16(), dy.bfloat16()
    # The channels_last (N, C, H, W) activations the model passes: (2, 6, 5, 6).
    x4, dy4 = (v.view(2, 5, 6, c).permute(0, 3, 1, 2) for v in (x, dy))
    return {
        "bn_stats f32": (batchnorm.bn_stats, (x, False)),
        "bn_stats bf16 statistics": (batchnorm.bn_stats, (x, True)),
        "bn_stats bf16": (batchnorm.bn_stats, (xb, False)),
        "bn_relu_forward f32": (batchnorm.bn_relu_forward,
                                (x, gamma, beta, *_running(c), EPS, MOMENTUM, False, True)),
        "bn_relu_forward bf16 channels_last": (
            batchnorm.bn_relu_forward,
            (x4.bfloat16(), gamma, beta, *_running(c), EPS, MOMENTUM, True, False)),
        "bn_moments": (batchnorm.bn_moments, (2 * batchnorm.bn_stats_plain(x, False), gamma,
                                              *_running(c), EPS, MOMENTUM)),
        "bn_relu_fwd relu": (batchnorm.bn_relu_fwd, (x, stats, beta, True)),
        "bn_relu_fwd bf16": (batchnorm.bn_relu_fwd, (xb, stats, beta, False)),
        "bn_relu_fwd channels_last": (batchnorm.bn_relu_fwd, (x4, stats, beta, True)),
        "bn_relu_bwd_sums relu": (batchnorm.bn_relu_bwd_sums, (dy, x, stats, beta, True)),
        "bn_relu_bwd_sums bf16": (batchnorm.bn_relu_bwd_sums, (dyb, xb, stats, beta, False)),
        "bn_relu_backward relu": (batchnorm.bn_relu_backward,
                                  (dy, x, stats, beta, EPS, True)),
        "bn_relu_backward bf16 channels_last": (
            batchnorm.bn_relu_backward,
            (dy4.bfloat16(), x4.bfloat16(), stats, beta, EPS, False)),
        "bn_bwd_coefficients": (batchnorm.bn_bwd_coefficients, (2 * sums, sums, stats, EPS)),
        "bn_relu_bwd_dx relu": (batchnorm.bn_relu_bwd_dx, (dy, x, stats, beta, coef, True)),
        "bn_relu_bwd_dx bf16": (batchnorm.bn_relu_bwd_dx, (dyb, xb, stats, beta, coef, False)),
        "bn_relu_bwd_dx channels_last": (batchnorm.bn_relu_bwd_dx,
                                         (dy4, x4, stats, beta, coef, True)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_batchnorm_ops_pass_opcheck(name) -> None:
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


def test_ops_on_cpu_are_the_plain_versions() -> None:
    for name, (op, args) in _op_cases().items():
        plain = getattr(batchnorm, f"{op._name.split('::')[-1]}_plain")
        # Fresh arguments for each: some ops update buffers in place.
        want = plain(*_op_cases()[name][1])
        got = op(*args)
        for g, w in zip(*((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))):
            assert torch.equal(g, w) and g.stride() == w.stride(), name


def test_rows_refuses_a_tensor_that_is_not_channels_last() -> None:
    x = torch.randn(2, 6, 4, 5)
    with pytest.raises(ValueError, match="channels_last"):
        batchnorm.rows(x)
    view = batchnorm.rows(x.contiguous(memory_format=torch.channels_last))
    assert view.shape == (40, 6) and view.is_contiguous()
    with pytest.raises(ValueError, match="bn_stats_dtype must be float32 or bfloat16"):
        U.MeshBatchNorm2d(6, stats_dtype=torch.float16)


def _mesh_block(stats_dtype) -> ConvBlock:
    """A ConvBlock: its BatchNorms are MeshBatchNorm2d (no group)."""
    torch.manual_seed(0)
    block = ConvBlock(5, 6, bn_stats_dtype=stats_dtype)
    assert all(type(block.block[i]) is U.MeshBatchNorm2d for i in (1, 4))
    assert all(block.block[i].group is None for i in (1, 4))
    return block.to(memory_format=torch.channels_last).train()


class _LibraryBatchNorm(torch.nn.BatchNorm2d):
    """PyTorch's own BatchNorm, then ReLU, where the model asks for both."""

    def forward_relu(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self(x))


def _library_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose every BatchNorm is nn.BatchNorm2d (then
    ReLU), with the same parameters and buffers."""
    copy = copy_module(model)
    for name, module in list(copy.named_modules()):
        if isinstance(module, U.MeshBatchNorm2d):
            parent, _, leaf = name.rpartition(".")
            library = _LibraryBatchNorm(module.num_features).to(memory_format=torch.channels_last)
            library.load_state_dict(module.state_dict())
            setattr(copy.get_submodule(parent), leaf, library)
    assert not any(isinstance(m, U.MeshBatchNorm2d) for m in copy.modules())
    return copy.train()


def _plain_block() -> ConvBlock:
    """The same ConvBlock with nn.BatchNorm2d and ReLU."""
    return _library_copy(_mesh_block(torch.float32))


@pytest.mark.parametrize("stats_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mesh_batchnorm_block_compiles_in_one_graph(stats_dtype) -> None:
    from torch._dynamo.utils import counters

    x = _nchw(_x((2, 12, 20, 5), seed=7)).contiguous(memory_format=torch.channels_last)
    runs = []
    for compiled in (False, True):
        block = _mesh_block(stats_dtype)
        fn = block
        if compiled:
            torch._dynamo.reset()
            graphs = counters["stats"]["unique_graphs"]
            fn = torch.compile(block, backend="aot_eager", fullgraph=True)
        y = fn(x)
        (y * y).sum().backward()
        if compiled:
            assert counters["stats"]["unique_graphs"] - graphs == 1
        runs.append((y.detach(), {k: p.grad for k, p in block.named_parameters()},
                     {k: v for k, v in block.state_dict().items()
                      if "running" in k or "tracked" in k}))
    (y0, g0, s0), (y1, g1, s1) = runs
    assert float((y0 == 0).float().mean()) > 0.2  # the ReLU was taken in
    assert all(int(v) == 1 for k, v in s1.items() if "tracked" in k)
    torch.testing.assert_close(y1, y0, rtol=0, atol=COMPILE_TOL)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=COMPILE_TOL, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=COMPILE_TOL, msg=k)


def _train_pass(model, x, **kwargs):
    """One training forward and backward of ``model`` on ``x`` (sum of the
    squared outputs): outputs, gradients, running statistics."""
    out = model(x, **kwargs)
    out = out if isinstance(out, tuple) else (out,)
    sum((o * o).sum() for o in out).backward()
    return ([o.detach() for o in out], {k: p.grad for k, p in model.named_parameters()},
            {k: v for k, v in model.state_dict().items() if "running" in k or "tracked" in k})


def _assert_runs_close(got, want) -> None:
    (y0, g0, s0), (y1, g1, s1) = got, want
    for a, b in zip(y0, y1):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL * max(float(b.abs().max()), 1.0))
    assert g0.keys() == g1.keys() and s0.keys() == s1.keys()
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=0, atol=TOL * float(g1[k].abs().max()),
                                   msg=k)
    for k in s0:
        torch.testing.assert_close(s0[k], s1[k], rtol=0, atol=TOL, msg=k)


def test_mesh_batchnorm_relu_equals_batchnorm2d_then_relu() -> None:
    """A float32 MeshBatchNorm2d (no group) in a ConvBlock gives what
    nn.BatchNorm2d then nn.ReLU give: outputs, gradients and running
    statistics within 1e-5 (E[x^2] - E[x]^2 against a two-pass variance)."""
    x = _nchw(_x((2, 12, 20, 5), seed=8)).contiguous(memory_format=torch.channels_last)
    _assert_runs_close(_train_pass(_mesh_block(torch.float32), x),
                       _train_pass(_plain_block(), x))


def test_default_stereo_unet_trains_on_the_batchnorm_ops(monkeypatch) -> None:
    """The default StereoUNet in training runs every BatchNorm + ReLU on the
    ops (one ``bn_relu_forward``, BN1 with its epilogue and BN2, a
    BatchNorm in the forward, one ``bn_relu_backward``, BN3 with its
    epilogue and BN4, in the backward; no other BatchNorm), and gives what a
    copy on nn.BatchNorm2d then ReLU gives: outputs, every gradient and the
    running statistics within 1e-5."""
    model = StereoUNet(base_channels=4, device="cpu",
                       generator=torch.Generator().manual_seed(3)).train()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 18 and all(type(m) is U.MeshBatchNorm2d and m.group is None
                                  for m in bns)
    library = _library_copy(model)
    x = torch.from_numpy(_x((2, 32, 48, 6), seed=9))

    calls = dict.fromkeys(("bn_relu_forward", "bn_relu_backward", "bn_stats", "bn_moments",
                           "bn_relu_fwd", "bn_relu_bwd_sums", "bn_bwd_coefficients",
                           "bn_relu_bwd_dx", "batch_norm"), 0)

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    for name in calls:
        if name == "batch_norm":
            monkeypatch.setattr(torch.nn.functional, name,
                                counted(name, torch.nn.functional.batch_norm))
        else:
            monkeypatch.setattr(batchnorm, name, counted(name, getattr(batchnorm, name)))
    got = _train_pass(model, x, return_uncertainty=True)
    assert calls == {**dict.fromkeys(calls, 0), "bn_relu_forward": 18,
                     "bn_relu_backward": 18}, calls
    assert all(int(m.num_batches_tracked) == 1 for m in bns)
    _assert_runs_close(got, _train_pass(library, x, return_uncertainty=True))


@pytest.mark.parametrize("grouped", [False, True], ids=["one_rank", "all_reduced"])
def test_folded_epilogue_equals_moments_scale_running_and_dz_coefficients(
        grouped, monkeypatch) -> None:
    """The epilogue of BN1's and BN3's second pass (plain version), through
    ``_bn_forward`` and ``_bn_backward``: with no group folded into the
    reductions' ops, with a group run alone after the all-reduce (here one
    that doubles the sums: two ranks holding the same shard). Against the
    textbook formulas on the same sums: mean, var, scale, running buffers
    and count, t1, t2, dgamma and dbeta (this rank's share with a group)."""
    c = 6
    x = _nchw(_x((2, 12, 20, c), seed=10)).contiguous(memory_format=torch.channels_last)
    dy = _nchw(np.random.default_rng(11).normal(size=(2, 12, 20, c)).astype(np.float32))
    rng = np.random.default_rng(12)
    gamma = torch.from_numpy((1.0 + 0.3 * rng.normal(size=c)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.normal(size=c)).astype(np.float32))
    ranks = 2 if grouped else 1
    group = object() if grouped else None
    reduces = []

    def all_reduce(t, group=None):
        reduces.append(t.shape[0])
        t.mul_(ranks)

    monkeypatch.setattr(U.dist, "all_reduce", all_reduce)
    coefs = []

    def spy(name, fn, coef_of):
        def run(*args):
            out = fn(*args)
            coefs.append(coef_of(out))
            return out
        monkeypatch.setattr(batchnorm, name, run)

    # The coefficients, from the op that forms them on each path.
    if grouped:
        spy("bn_bwd_coefficients", batchnorm.bn_bwd_coefficients, lambda out: out)
    else:
        spy("bn_relu_backward", batchnorm.bn_relu_backward, lambda out: out[1])
    running = _running(c)
    y, stats = U._bn_forward(x, gamma, beta, running, EPS, MOMENTUM, False, group, True)
    dz, dgamma, dbeta = U._bn_backward(dy, x, stats, beta, EPS, group, True)
    assert reduces == ([2 * c + 1, 2 * c] if grouped else [])

    sums = batchnorm.bn_stats_plain(x, False) * ranks
    mean, var, n = _moments(sums, c)
    want_running = _running(c)
    _update_running(*want_running, mean, var, n)
    assert torch.equal(stats[:c], mean) and torch.equal(stats[c:2 * c], var)
    assert float(stats[3 * c]) == float(n) == ranks * x.numel() / c
    torch.testing.assert_close(stats[2 * c:3 * c], _scale(var, gamma), rtol=EPILOGUE_RTOL,
                               atol=0)
    for got, want, what in zip(running, want_running, ("mean", "var", "tracked")):
        assert torch.equal(got, want), what
    assert torch.equal(y, batchnorm.bn_relu_fwd_plain(x, stats, beta, True))

    scale = stats[2 * c:3 * c]
    local = batchnorm.bn_relu_bwd_sums_plain(dy, x, stats, beta, True)
    inv = torch.rsqrt(var + EPS)
    t1, t2 = _dz_coefficients(local * ranks, inv, scale, n)
    (coef,) = coefs
    assert torch.equal(dbeta, local[:c]) and torch.equal(coef[:c], local[:c])
    torch.testing.assert_close(dgamma, local[c:] * inv, rtol=EPILOGUE_RTOL, atol=0)
    assert torch.equal(coef[2 * c:3 * c], t1)
    torch.testing.assert_close(coef[3 * c:], t2, rtol=EPILOGUE_RTOL, atol=0)
    assert torch.equal(dz, batchnorm.bn_relu_bwd_dx_plain(dy, x, stats, beta, coef, True))
