"""Batch-statistic BatchNorm + ReLU on the four kernels of
``ops/batchnorm.py`` (BN1-BN4), held against the JAX package on the CPU,
where every custom op runs its plain version.

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
- ``opcheck`` on each custom op (schema, fake, dispatch);
- a ``ConvBlock`` of ``MeshBatchNorm2d`` compiled (aot_eager, fullgraph)
  against eager: one graph, outputs, gradients and running statistics
  within 1e-6 (the same ops in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import unet as J
from stereo_depth_estimation_tpu_torch.models import ConvBlock
from stereo_depth_estimation_tpu_torch.models import unet as U
from stereo_depth_estimation_tpu_torch.ops import batchnorm

EPS = 1e-5
TOL = 1e-5
COMPILE_TOL = 1e-6


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
    mean, var, _ = U._moments(total, 6)
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
    """flax BatchNorm (+ ReLU) under jax.vjp: y and the gradients of x, the
    scale and the bias for the cotangent ``dy``."""
    bn = J.BatchNorm()

    def f(xx, s, b):
        variables = {"params": {"scale": s, "bias": b},
                     "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
        y, _ = bn.apply(variables, xx, use_running_average=False, mutable=["batch_stats"])
        return jax.nn.relu(y) if relu else y

    y, vjp = jax.vjp(f, *map(jnp.asarray, (x, scale, bias)))
    return (y, *vjp(jnp.asarray(dy)))


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
    y, mean, var, n = U._BatchNormReLU.apply(xt, gamma, beta, EPS, torch.float32, None, relu)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert float(n) == x.size // 6
    y.backward(_nchw(dy))
    _assert_close(y.permute(0, 2, 3, 1), want[0], "y")
    _assert_close(xt.grad.permute(0, 2, 3, 1), want[1], "dx")
    _assert_close(gamma.grad, want[2], "dscale")
    _assert_close(beta.grad, want[3], "dbias")
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
    yt, mt, vt, _ = U._FusedConvBNReLU.apply(xt, weight, gamma, beta, (1, 1), EPS,
                                             torch.float32, None)
    yt.backward(_nchw(dy))
    _assert_close(yt.permute(0, 2, 3, 1), y, "y")
    _assert_close(mt, mean, "mean")
    _assert_close(vt, var, "var")
    _assert_close(xt.grad.permute(0, 2, 3, 1), dx, "dx")
    _assert_close(weight.grad.permute(2, 3, 1, 0), dkernel, "dkernel")
    _assert_close(gamma.grad, dscale, "dscale")
    _assert_close(beta.grad, dbias, "dbias")


def _op_cases():
    g = torch.Generator().manual_seed(0)
    m, c = 60, 6
    x = torch.randn((m, c), generator=g)
    dy = torch.randn((m, c), generator=g)
    vec = [torch.randn((c,), generator=g) for _ in range(5)]
    mean, scale, beta, t1, t2 = vec
    xb, dyb = x.bfloat16(), dy.bfloat16()
    return {
        "bn_stats f32": (batchnorm.bn_stats, (x, False)),
        "bn_stats bf16 statistics": (batchnorm.bn_stats, (x, True)),
        "bn_stats bf16": (batchnorm.bn_stats, (xb, False)),
        "bn_relu_fwd relu": (batchnorm.bn_relu_fwd, (x, mean, scale, beta, True)),
        "bn_relu_fwd bf16": (batchnorm.bn_relu_fwd, (xb, mean, scale, beta, False)),
        "bn_relu_bwd_sums relu": (batchnorm.bn_relu_bwd_sums, (dy, x, mean, scale, beta, True)),
        "bn_relu_bwd_sums bf16": (batchnorm.bn_relu_bwd_sums,
                                  (dyb, xb, mean, scale, beta, False)),
        "bn_relu_bwd_dx relu": (batchnorm.bn_relu_bwd_dx,
                                (dy, x, mean, scale, beta, t1, t2, True)),
        "bn_relu_bwd_dx bf16": (batchnorm.bn_relu_bwd_dx,
                                (dyb, xb, mean, scale, beta, t1, t2, False)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_batchnorm_ops_pass_opcheck(name) -> None:
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


def test_ops_on_cpu_are_the_plain_versions() -> None:
    for name, (op, args) in _op_cases().items():
        plain = getattr(batchnorm, f"{op._name.split('::')[-1]}_plain")
        assert torch.equal(op(*args), plain(*args)), name


def test_rows_refuses_a_tensor_that_is_not_channels_last() -> None:
    x = torch.randn(2, 6, 4, 5)
    with pytest.raises(ValueError, match="channels_last"):
        batchnorm.rows(x)
    view = batchnorm.rows(x.contiguous(memory_format=torch.channels_last))
    assert view.shape == (40, 6) and view.is_contiguous()
    with pytest.raises(ValueError, match="bn_stats_dtype must be float32 or bfloat16"):
        U.MeshBatchNorm2d(6, stats_dtype=torch.float16)


def _mesh_block(stats_dtype) -> ConvBlock:
    """A ConvBlock whose BatchNorms are MeshBatchNorm2d (no group)."""
    torch.manual_seed(0)
    block = ConvBlock(5, 6, bn_stats_dtype=stats_dtype)
    if stats_dtype == torch.float32:
        block.block[1] = U.MeshBatchNorm2d(6)
        block.block[4] = U.MeshBatchNorm2d(6)
    assert all(isinstance(block.block[i], U.MeshBatchNorm2d) for i in (1, 4))
    return block.to(memory_format=torch.channels_last).train()


def _plain_block() -> ConvBlock:
    """The same ConvBlock with nn.BatchNorm2d and nn.ReLU."""
    torch.manual_seed(0)
    return ConvBlock(5, 6).to(memory_format=torch.channels_last).train()


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
                     {k: v for k, v in block.state_dict().items() if "running" in k}))
    (y0, g0, s0), (y1, g1, s1) = runs
    assert float((y0 == 0).float().mean()) > 0.2  # the ReLU was taken in
    torch.testing.assert_close(y1, y0, rtol=0, atol=COMPILE_TOL)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=COMPILE_TOL, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=COMPILE_TOL, msg=k)


def test_mesh_batchnorm_relu_equals_batchnorm2d_then_relu() -> None:
    """A float32 MeshBatchNorm2d (no group) in a ConvBlock gives what
    nn.BatchNorm2d then nn.ReLU give: outputs, gradients and running
    statistics within 1e-5 (E[x^2] - E[x]^2 against a two-pass variance)."""
    x = _nchw(_x((2, 12, 20, 5), seed=8)).contiguous(memory_format=torch.channels_last)
    runs = []
    for block in (_mesh_block(torch.float32), _plain_block()):
        y = block(x)
        (y * y).sum().backward()
        runs.append((y.detach(), {k: p.grad for k, p in block.named_parameters()},
                     {k: v for k, v in block.state_dict().items() if "running" in k}))
    (y0, g0, s0), (y1, g1, s1) = runs
    torch.testing.assert_close(y0, y1, rtol=0, atol=TOL)
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=0, atol=TOL * float(g1[k].abs().max()),
                                   msg=k)
    for k in s0:
        torch.testing.assert_close(s0[k], s1[k], rtol=0, atol=TOL, msg=k)

