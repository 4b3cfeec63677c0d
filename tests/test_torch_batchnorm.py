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
  ReLU under ``jax.vjp``, float32: 1e-5 of each output's largest magnitude
  (sums in another order; measured ~1e-7);
- those three at each of SHAPES: the StereoUNet's 6 channels, 4 channels at
  batch 1, 36 channels over a row count that is no multiple of a power of
  two, and a channels_last_3d (N, C, D, H, W) volume as PSMNet's BatchNorms
  take it (the flax BatchNorm sees its rows as (N * D, H, W, C));
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
  (E[x^2] - E[x]^2 against a two-pass variance);
- a base-4 StereoUNet with ``bn_stats_dtype=bfloat16`` against the JAX
  model with it, from the JAX init (train-mode outputs, the gradients of one
  loss, the running statistics): BF16_TOL = 2e-2 on outputs, on gradients
  (of the largest) and on running statistics. Both round each layer's mean
  and mean square to bfloat16 (2^-9 relative); a statistic within float
  noise of a rounding boundary rounds the other way in the other framework,
  and the network amplifies that step. Measured 6.8e-3, 5.0e-3 and 3.4e-3.
"""

from copy import deepcopy as copy_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.models import unet as J
from stereo_depth_estimation_tpu_torch.models import ConvBlock, StereoUNet
from stereo_depth_estimation_tpu_torch.models import unet as U
from stereo_depth_estimation_tpu_torch.models.compat import (
    load_torch_state_dict,
    state_dict_from_jax,
)
from stereo_depth_estimation_tpu_torch.ops import batchnorm

EPS = 1e-5
MOMENTUM = 0.1
TOL = 1e-5
COMPILE_TOL = 1e-6
EPILOGUE_RTOL = 1e-6  # a few float32 ulps
BF16_TOL = 2e-2
# Channels-last activations (N, H, W, C) and a volume (N, D, H, W, C).
SHAPES = {"c6": (2, 12, 20, 6), "c4_batch1": (1, 12, 20, 4), "c36_ragged": (3, 7, 11, 36),
          "volume": (2, 3, 6, 10, 8)}


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
    """NHWC numpy -> the channels_last (N, C, H, W) view the model holds; an
    NDHWC volume -> its channels_last_3d (N, C, D, H, W) view."""
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t.permute(0, 4, 1, 2, 3)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_nchw``: channels last again."""
    return t.permute(0, 2, 3, 1) if t.ndim == 4 else t.permute(0, 2, 3, 4, 1)


def _layout(ndim: int) -> torch.memory_format:
    return torch.channels_last if ndim == 4 else torch.channels_last_3d


def _flax_rows(x: np.ndarray) -> np.ndarray:
    """``x`` as the (N, H, W, C) the flax BatchNorm reduces over its first
    three axes: a volume's N and D taken together."""
    return x.reshape(-1, *x.shape[-3:])


def _flax_stats(x: np.ndarray, stats_dtype) -> tuple[np.ndarray, np.ndarray]:
    """(mean, biased var) of the flax BatchNorm's training statistics."""
    x = _flax_rows(x)
    bn = J.BatchNorm(momentum=1.0, stats_dtype=stats_dtype)
    variables = bn.init(jax.random.key(0), jnp.asarray(x), use_running_average=True)
    _, updated = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    n = x.size // x.shape[-1]
    mean = np.asarray(updated["batch_stats"]["mean"])
    var = np.asarray(updated["batch_stats"]["var"]).astype(np.float64) * (n - 1) / n
    return mean, var


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_bn_stats_f32_equal_flax_statistics(shape) -> None:
    x = _x(shape, seed=0)
    c, n = shape[-1], x.size // shape[-1]
    total = batchnorm.bn_stats(batchnorm.rows(_nchw(x)), False)
    assert total.shape == (2 * c + 1,) and float(total[2 * c]) == n
    mean, var, _ = _moments(total, c)
    want_mean, want_var = _flax_stats(x, jnp.float32)
    scale = (_flax_rows(x).astype(np.float64) ** 2).mean(axis=(0, 1, 2))
    np.testing.assert_array_less(np.abs(mean.numpy() - want_mean), 1e-6 * scale)
    np.testing.assert_array_less(np.abs(var.numpy() - want_var), 1e-6 * scale)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_bn_stats_bf16_means_within_one_ulp_of_flax(shape) -> None:
    x = _x(shape, seed=1)
    c, n = shape[-1], x.size // shape[-1]
    total = batchnorm.bn_stats(batchnorm.rows(_nchw(x)), True)
    mean, mean_sq = (total[:c] / n).numpy(), (total[c:2 * c] / n).numpy()
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
    var after the step; y and the gradient of x in ``x``'s shape."""
    bn = J.BatchNorm()
    c = x.shape[-1]

    def f(xx, s, b):
        variables = {"params": {"scale": s, "bias": b},
                     "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
        y, updated = bn.apply(variables, xx, use_running_average=False,
                              mutable=["batch_stats"])
        return (jax.nn.relu(y) if relu else y), updated["batch_stats"]

    y, vjp, running = jax.vjp(f, *map(jnp.asarray, (_flax_rows(x), scale, bias)),
                              has_aux=True)
    dx, dscale, dbias = vjp(jnp.asarray(_flax_rows(dy)))
    return (y.reshape(x.shape), dx.reshape(x.shape), dscale, dbias, running["mean"],
            running["var"])


def _assert_close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * scale, f"{what}: {err} of {scale}"


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_batchnorm_relu_forward_and_backward_equal_flax(relu, shape) -> None:
    x = _x(shape, seed=2)
    c = shape[-1]
    dy = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    rng = np.random.default_rng(4)
    scale = (1.0 + 0.3 * rng.normal(size=c)).astype(np.float32)
    bias = (0.3 * rng.normal(size=c)).astype(np.float32)
    want = _flax_bn_relu(x, scale, bias, dy, relu)

    layout = _layout(len(shape))
    xt = _nchw(x).clone(memory_format=layout).requires_grad_()
    gamma = torch.from_numpy(scale).requires_grad_()
    beta = torch.from_numpy(bias).requires_grad_()
    running_mean, running_var, tracked = _running(c)
    y = U._BatchNormReLU.apply(xt, gamma, beta, running_mean, running_var, tracked, EPS,
                               MOMENTUM, False, None, relu)
    assert y.is_contiguous(memory_format=layout)
    assert int(tracked) == 1
    y.backward(_nchw(dy))
    _assert_close(_nhwc(y), want[0], "y")
    _assert_close(_nhwc(xt.grad), want[1], "dx")
    _assert_close(gamma.grad, want[2], "dscale")
    _assert_close(beta.grad, want[3], "dbias")
    _assert_close(running_mean, want[4], "running mean")
    _assert_close(running_var, want[5], "running var")
    if relu:
        assert float((y == 0).float().mean()) > 0.2  # the mask matters


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
    # A channels_last_3d volume as PSMNet passes: (2, 6, 3, 2, 5).
    x5, dy5 = (v.view(2, 3, 2, 5, c).permute(0, 4, 1, 2, 3) for v in (x, dy))
    # 36 channels over 77 rows (no multiple of a power of two but 1).
    x36, dy36 = torch.randn((7, 11, 36), generator=g), torch.randn((7, 11, 36), generator=g)
    x36, dy36 = (v.view(1, 7, 11, 36).permute(0, 3, 1, 2) for v in (x36, dy36))
    g36, b36 = 1.0 + 0.2 * torch.randn((36,), generator=g), torch.randn((36,), generator=g)
    stats36 = batchnorm.bn_moments_plain(batchnorm.bn_stats_plain(batchnorm.rows(x36), False),
                                         g36, *_running(36), EPS, MOMENTUM)
    coef36 = batchnorm.bn_relu_backward_plain(batchnorm.rows(dy36), batchnorm.rows(x36),
                                              stats36, b36, EPS, True)[1]
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
        "bn_relu_forward channels_last_3d": (
            batchnorm.bn_relu_forward,
            (x5, gamma, beta, *_running(c), EPS, MOMENTUM, False, True)),
        "bn_relu_backward bf16 channels_last_3d": (
            batchnorm.bn_relu_backward,
            (dy5.bfloat16(), x5.bfloat16(), stats, beta, EPS, True)),
        "bn_stats C36 ragged bf16 statistics": (batchnorm.bn_stats, (x36, True)),
        "bn_relu_bwd_dx C36 ragged": (batchnorm.bn_relu_bwd_dx,
                                      (dy36, x36, stats36, b36, coef36, True)),
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


def _mesh_block(stats_dtype, in_channels: int = 5, out_channels: int = 6) -> ConvBlock:
    """A ConvBlock: its BatchNorms are MeshBatchNorm2d (no group)."""
    torch.manual_seed(0)
    block = ConvBlock(in_channels, out_channels, bn_stats_dtype=stats_dtype)
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


def _plain_block(in_channels: int = 5, out_channels: int = 6) -> ConvBlock:
    """The same ConvBlock with nn.BatchNorm2d and ReLU."""
    return _library_copy(_mesh_block(torch.float32, in_channels, out_channels))


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


# (input shape (N, H, W, C_in), output channels) of a ConvBlock.
BLOCKS = {"c6": ((2, 12, 20, 5), 6), "c4_batch1": ((1, 12, 20, 3), 4),
          "c36_ragged": ((3, 7, 11, 5), 36)}


@pytest.mark.parametrize("shape, out_channels", BLOCKS.values(), ids=BLOCKS.keys())
def test_mesh_batchnorm_relu_equals_batchnorm2d_then_relu(shape, out_channels) -> None:
    """A float32 MeshBatchNorm2d (no group) in a ConvBlock gives what
    nn.BatchNorm2d then nn.ReLU give: outputs, gradients and running
    statistics within 1e-5 (E[x^2] - E[x]^2 against a two-pass variance)."""
    x = _nchw(_x(shape, seed=8)).contiguous(memory_format=torch.channels_last)
    _assert_runs_close(_train_pass(_mesh_block(torch.float32, shape[-1], out_channels), x),
                       _train_pass(_plain_block(shape[-1], out_channels), x))


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


# -- a StereoUNet with bn_stats_dtype bfloat16 against the JAX model with it --

MODEL_BASE, MODEL_HW = 4, (32, 48)


@pytest.fixture(scope="module")
def variables():
    model = JaxUNet(base_channels=MODEL_BASE)
    return jax.jit(lambda key: model.init(key, jnp.zeros((2, *MODEL_HW, 6)), train=False,
                                          return_uncertainty=True))(jax.random.key(0))


def _model_inputs() -> tuple[np.ndarray, np.ndarray]:
    x = np.random.default_rng(3).uniform(0, 1, (2, *MODEL_HW, 6)).astype(np.float32)
    target = np.random.default_rng(4).uniform(0, 10, (2, *MODEL_HW, 1)).astype(np.float32)
    return x, target


def _port_run(model: StereoUNet):
    """Train-mode outputs, the gradients of one loss and the running
    statistics."""
    x, target = map(torch.from_numpy, _model_inputs())
    model.zero_grad(set_to_none=True)
    disp, logvar = model(x, return_uncertainty=True)
    (torch.abs(disp - target) * torch.exp(-logvar) + logvar).mean().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (disp.detach(), logvar.detach()), grads, stats


def _jax_run(variables):
    """The same through the JAX StereoUNet with ``bn_stats_dtype`` bfloat16,
    in the port's key layout."""
    x, target = map(jnp.asarray, _model_inputs())
    model = JaxUNet(base_channels=MODEL_BASE, bn_stats_dtype=jnp.bfloat16)

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


def _assert_model_runs_close(got, want, tol: float) -> None:
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


def test_bn_stats_bf16_model_equals_the_jax_model_with_it(variables) -> None:
    model = StereoUNet(base_channels=MODEL_BASE, device="cpu", bn_stats_dtype=torch.bfloat16)
    missing, unexpected = load_torch_state_dict(model, state_dict_from_jax(variables))
    assert not missing and not unexpected
    _assert_model_runs_close(_port_run(model.train()),
                             _jax_run(variables), BF16_TOL)
