"""The port's 2x2 max pool (``ops/pool.py``) held against the JAX package on
the CPU: pool_lab's Pallas kernels K2/K3 in interpret mode, and
``models/unet.py::max_pool_2x2`` with its ``jax.grad``.

The pool only selects, so every comparison is exact (tolerance 0): values
compare equal (NaN where NaN), indices and gradients are identical. Inputs
are post-ReLU normals rounded to a coarse grid, so windows hold many ties.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_depth_estimation_tpu.models.unet import max_pool_2x2 as jax_max_pool_2x2
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.ops import pool

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(2, 16, 24, 8), (2, 12, 16, 16), (2, 6, 10, 3), (1, 4, 6, 6)]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def pool_lab():
    spec = importlib.util.spec_from_file_location("pool_lab", ROOT / "scripts" / "pool_lab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tie_rich(shape, seed: int, nan_at: int | None = None) -> np.ndarray:
    """Post-ReLU values on a 1/4 grid (ties in most windows). ``nan_at``
    puts one NaN at that window position (0..3) of the first window."""
    rng = np.random.default_rng(seed)
    x = np.round(np.maximum(rng.normal(size=shape), 0.0) * 4) / 4
    x = x.astype(np.float32)
    if nan_at is not None:
        x[0, nan_at // 2, nan_at % 2, 0] = np.nan
    return x


def _to_torch(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t, dtype=np.float32) if jnp.issubdtype(t.dtype, jnp.floating) \
        else np.asarray(t)


def _assert_same(a, b) -> None:
    np.testing.assert_array_equal(_np(a), _np(b))  # NaN positions must match too


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nan_at", [None, 0, 1, 2, 3])
def test_plain_equals_pool_lab_pallas_interpret(pool_lab, shape, dtype, nan_at) -> None:
    _, jdt, tdt = DTYPES[dtype]
    x = _tie_rich(shape, seed=sum(shape), nan_at=nan_at)
    jy, jidx = pool_lab.maxpool2x2_pallas_fwd(jnp.asarray(x, jdt), interpret=True)
    y, idx = pool.maxpool2x2_fwd_plain(_to_torch(x, tdt))
    assert y.dtype == tdt and idx.dtype == torch.uint8
    _assert_same(y, jy)
    _assert_same(idx, jidx)
    if nan_at is not None:
        assert int(idx[0, 0, 0, 0]) == 3 and bool(torch.isnan(y[0, 0, 0, 0]))

    dy = np.random.default_rng(1).normal(size=y.shape).astype(np.float32)
    jdx = pool_lab.maxpool2x2_pallas_bwd(jnp.asarray(dy, jdt), jidx, interpret=True)
    dx = pool.maxpool2x2_bwd_plain(_to_torch(dy, tdt), idx)
    assert dx.dtype == tdt and dx.shape == shape
    _assert_same(dx, jdx)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_plain_equals_max_pool_2x2_and_its_grad(shape, dtype) -> None:
    """Forward against reduce_window, backward against jax.grad's
    select_and_scatter. A NaN at window position 3 is routed the same way by
    both rules; at positions 0-2 select_and_scatter's running ``>=`` may move
    on from the NaN, where pool_lab's kernels (and the port) name position 3."""
    _, jdt, tdt = DTYPES[dtype]
    x = _tie_rich(shape, seed=7, nan_at=3)
    jx = jnp.asarray(x, jdt)
    dy = np.random.default_rng(2).normal(size=(shape[0], shape[1] // 2, shape[2] // 2,
                                               shape[3])).astype(np.float32)
    jdy = jnp.asarray(dy, jdt)
    jy = jax_max_pool_2x2(jx)
    jdx = jax.grad(lambda v: jnp.sum(jax_max_pool_2x2(v).astype(jnp.float32)
                                     * jdy.astype(jnp.float32)))(jx)

    y, idx = pool.maxpool2x2_fwd_plain(_to_torch(x, tdt))
    _assert_same(y, jy)
    _assert_same(pool.maxpool2x2_bwd_plain(_to_torch(dy, tdt), idx), jdx.astype(jdt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_equals_plain_backward(dtype) -> None:
    """max_pool_2x2 (the custom op and its autograd) on an NCHW channels_last
    tensor: its output is the plain forward as a channels_last view, and
    autograd's gradient is the plain backward of the incoming gradient,
    channels_last or not."""
    x = _tie_rich((2, 8, 12, 16), seed=3)
    xt = _to_torch(x, dtype).permute(0, 3, 1, 2).requires_grad_(True)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = pool.max_pool_2x2(xt)
    assert y.dtype == dtype and y.shape == (2, 16, 4, 6)
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref_y, ref_idx = pool.maxpool2x2_fwd_plain(_to_torch(x, dtype))
    assert torch.equal(y.permute(0, 2, 3, 1), ref_y)

    dy = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 16, 4, 6))).to(dtype)
    (grad,) = torch.autograd.grad(y, xt, dy)  # NCHW-contiguous dy: copied before K3
    assert grad.dtype == dtype and grad.is_contiguous(memory_format=torch.channels_last)
    expected = pool.maxpool2x2_bwd_plain(dy.permute(0, 2, 3, 1).contiguous(), ref_idx)
    assert torch.equal(grad.permute(0, 2, 3, 1), expected)

    y = pool.max_pool_2x2(xt)
    dy_cl = dy.contiguous(memory_format=torch.channels_last)
    (grad_cl,) = torch.autograd.grad(y, xt, dy_cl)  # channels_last dy: taken as it is
    assert torch.equal(grad_cl, grad)

    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert pool.max_pool_2x2(xt.detach().float()).dtype == torch.float32
    with torch.inference_mode():
        assert torch.equal(pool.max_pool_2x2(xt.detach()), y.detach())


def test_autograd_gradient_equals_torch_max_pool_grad() -> None:
    """On tie-rich inputs without NaN, the first-max rule is PyTorch's
    max_pool2d rule too: the gradients are identical."""
    x = torch.from_numpy(_tie_rich((2, 8, 12, 4), seed=5)).permute(0, 3, 1, 2)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    dy = torch.randn((2, 4, 4, 6), generator=torch.Generator().manual_seed(0))
    (ga,) = torch.autograd.grad(pool.max_pool_2x2(a), a, dy)
    (gb,) = torch.autograd.grad(torch.nn.functional.max_pool2d(b, 2), b, dy)
    assert torch.equal(ga, gb)


def test_kernels_refuse_cpu_tensors_and_bad_inputs() -> None:
    x = torch.zeros((2, 4, 4, 8))
    fwd_before = pool.maxpool2x2_fwd_cuda.launches
    bwd_before = pool.maxpool2x2_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pool.maxpool2x2_fwd_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pool.maxpool2x2_bwd_cuda(x[:, :2, :2], torch.zeros((2, 2, 2, 8), dtype=torch.uint8))
    assert pool.maxpool2x2_fwd_cuda.launches == fwd_before
    assert pool.maxpool2x2_bwd_cuda.launches == bwd_before
    # The dispatching wrappers send CPU tensors to the plain versions.
    y, idx = pool.maxpool2x2_fwd(x)
    assert y.shape == idx.shape == (2, 2, 2, 8)
    assert pool.maxpool2x2_bwd(y, idx).shape == x.shape
    assert pool.maxpool2x2_fwd_cuda.launches == fwd_before


class _SdeOps(TorchDispatchMode):
    """Records every call of an ``sde_torch::`` op: (name, first input's shape)."""

    def __init__(self) -> None:
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "sde_torch":
            self.seen.append((func._schema.name, tuple(args[0].shape)))
        return func(*args, **(kwargs or {}))


def test_model_pools_through_max_pool_2x2(monkeypatch) -> None:
    """The StereoUNet's four pools are calls of the op sde_torch::maxpool2x2_fwd
    at the four levels' shapes (NHWC), its backward four calls of
    sde_torch::maxpool2x2_bwd, and F.max_pool2d is never called."""

    def forbidden(*args, **kwargs):
        raise AssertionError("F.max_pool2d was called")

    monkeypatch.setattr(torch.nn.functional, "max_pool2d", forbidden)
    model = StereoUNet(base_channels=4, device="cpu")
    with _SdeOps() as ops:
        disp = model(torch.zeros((1, 32, 48, 6)))
        disp.sum().backward()
    # The BatchNorms' ops run between them.
    pools = [op for op in ops.seen if op[0].startswith("sde_torch::maxpool")]
    levels = [(1, 32, 48, 4), (1, 16, 24, 8), (1, 8, 12, 16), (1, 4, 6, 32)]
    assert pools[:4] == [("sde_torch::maxpool2x2_fwd", s) for s in levels]
    pooled = [(n, h // 2, w // 2, c) for n, h, w, c in reversed(levels)]
    assert pools[4:] == [("sde_torch::maxpool2x2_bwd", s) for s in pooled]
