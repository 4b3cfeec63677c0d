"""2x2/stride-2 max pool through hand-written CUDA kernels (``csrc/maxpool.cu``).

Counterpart of ``stereo_depth_estimation_tpu/models/unet.py::max_pool_2x2``
computed the way the JAX package's own Pallas pool kernels compute it
(``scripts/pool_lab.py``): the forward returns the pooled values and, per
output, the uint8 position 0..3 of the FIRST maximum in window order (0,0),
(0,1), (1,0), (1,1); the backward routes dy to that position. A window that
holds a NaN pools to NaN and has index 3 (every ``>=`` against NaN is false).

- ``maxpool2x2_fwd_plain`` / ``maxpool2x2_bwd_plain``: the plain PyTorch
  versions (reshape-based, like pool_lab's ``maxpool2x2_xla_reshape_*``), on
  NHWC tensors.
- ``maxpool2x2_fwd_cuda`` / ``maxpool2x2_bwd_cuda``: the kernels K2 and K3;
  they take CUDA tensors only, raise on anything else, and count their
  launches in ``.launches``.
- ``maxpool2x2_fwd`` / ``maxpool2x2_bwd``: the ``torch.library`` custom ops
  ``sde_torch::maxpool2x2_fwd`` / ``_bwd``, with the plain version as the
  CPU implementation and the kernel as the CUDA one (no fallback from the
  kernel), fakes for tracing, and the forward's autograd (saving idx, the
  backward op for the gradient). ``torch.compile`` keeps them in its graph
  as they are.
- ``max_pool_2x2``: the op on the model's NCHW channels_last tensors, which
  the StereoUNet calls at each of its four levels.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_DTYPES = (torch.float32, torch.bfloat16)


def _windows(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    n, h, w, c = x.shape
    x6 = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x6[:, :, 0, :, 0], x6[:, :, 0, :, 1], x6[:, :, 1, :, 0], x6[:, :, 1, :, 1]


def maxpool2x2_fwd_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, C) -> y (N, H/2, W/2, C) in x's dtype, idx uint8 (first max)."""
    a0, a1, b0, b1 = _windows(x)
    y = torch.maximum(torch.maximum(a0, a1), torch.maximum(b0, b1))
    idx = torch.where(
        a0 >= y, 0, torch.where(a1 >= y, 1, torch.where(b0 >= y, 2, 3))
    ).to(torch.uint8)
    return y, idx


def maxpool2x2_bwd_plain(dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """dy, idx (N, H/2, W/2, C) -> dx (N, H, W, C): dy where idx points, else 0."""
    n, h2, w2, c = dy.shape
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    parts = torch.stack([torch.where(idx == k, dy, zero) for k in range(4)])
    dx6 = parts.reshape(2, 2, n, h2, w2, c).permute(2, 3, 0, 4, 1, 5)
    return dx6.reshape(n, 2 * h2, 2 * w2, c)


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA max-pool kernels take CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or x.ndim != 4:
        raise ValueError(
            f"{what} must be (N, H, W, C) float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous (NHWC)")


class _PoolLibrary:
    """ctypes handles of ``csrc/maxpool.cu``, bound at first launch."""

    def __init__(self) -> None:
        self._lib = None

    def get(self):
        if self._lib is None:
            lib = load_library("maxpool")
            for fn in (lib.maxpool2x2_fwd, lib.maxpool2x2_bwd):
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            lib.maxpool_error_string.argtypes = [ctypes.c_int]
            lib.maxpool_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


_library = _PoolLibrary()


def _launch(name: str, ptrs: tuple[int, int, int], shape, dtype) -> None:
    lib = _library.get()
    bf16 = int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*ptrs, *shape, bf16, stream)
    if code != 0:
        reason = lib.maxpool_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {reason}")


class MaxPoolForwardKernel:
    """K2: launches ``maxpool2x2_fwd`` on the current stream. ``launches``
    counts the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _check_x(x, "x")
        n, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"max pool 2x2 needs even height and width, got {h}x{w}")
        y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
        idx = torch.empty(y.shape, dtype=torch.uint8, device=x.device)
        if y.numel() == 0:
            return y, idx
        with torch.cuda.device(x.device):
            _launch("maxpool2x2_fwd", (x.data_ptr(), y.data_ptr(), idx.data_ptr()),
                    (n, h, w, c), x.dtype)
        self.launches += 1
        return y, idx


class MaxPoolBackwardKernel:
    """K3: launches ``maxpool2x2_bwd`` on the current stream. ``launches``
    counts the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        _check_x(dy, "dy")
        if idx.dtype != torch.uint8 or idx.shape != dy.shape:
            raise ValueError(
                f"idx must be uint8 of dy's shape {tuple(dy.shape)}, got "
                f"{tuple(idx.shape)} {idx.dtype}"
            )
        if idx.device != dy.device or not idx.is_contiguous():
            raise ValueError("idx must be contiguous and on dy's device")
        n, h2, w2, c = dy.shape
        dx = torch.empty((n, 2 * h2, 2 * w2, c), dtype=dy.dtype, device=dy.device)
        if dx.numel() == 0:
            return dx
        with torch.cuda.device(dy.device):
            _launch("maxpool2x2_bwd", (dy.data_ptr(), idx.data_ptr(), dx.data_ptr()),
                    (n, 2 * h2, 2 * w2, c), dy.dtype)
        self.launches += 1
        return dx


maxpool2x2_fwd_cuda = MaxPoolForwardKernel()
maxpool2x2_bwd_cuda = MaxPoolBackwardKernel()


# The custom ops: opaque to torch.compile, which keeps them in its graph as
# calls (never decomposed into the plain versions), with fakes for tracing.
# The CPU implementation is the plain version; the CUDA one is the kernel.


@torch.library.custom_op("sde_torch::maxpool2x2_fwd", mutates_args=(), device_types="cpu")
def maxpool2x2_fwd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC forward: the plain version for a CPU tensor, K2 for a CUDA one."""
    return maxpool2x2_fwd_plain(x)


@maxpool2x2_fwd.register_kernel("cuda")
def _(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return maxpool2x2_fwd_cuda(x)


@maxpool2x2_fwd.register_fake
def _(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n, h, w, c = x.shape
    y = x.new_empty((n, h // 2, w // 2, c))
    return y, x.new_empty(y.shape, dtype=torch.uint8)


@torch.library.custom_op("sde_torch::maxpool2x2_bwd", mutates_args=(), device_types="cpu")
def maxpool2x2_bwd(dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """NHWC backward: the plain version for a CPU tensor, K3 for a CUDA one."""
    return maxpool2x2_bwd_plain(dy, idx)


@maxpool2x2_bwd.register_kernel("cuda")
def _(dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return maxpool2x2_bwd_cuda(dy, idx)


@maxpool2x2_bwd.register_fake
def _(dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n, h2, w2, c = dy.shape
    return dy.new_empty((n, 2 * h2, 2 * w2, c))


def _save_index(ctx, inputs, output) -> None:
    ctx.save_for_backward(output[1])


def _pool_backward(ctx, dy: torch.Tensor, _didx) -> torch.Tensor:
    (idx,) = ctx.saved_tensors
    return maxpool2x2_bwd(dy.contiguous(), idx)


maxpool2x2_fwd.register_autograd(_pool_backward, setup_context=_save_index)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of an (N, C, H, W) tensor, H and W even; the
    name and function of the JAX package's ``models/unet.py::max_pool_2x2``.

    The op runs on the NHWC view, so a channels_last input is not copied;
    the result and the gradient are channels_last views of the kernels'
    NHWC outputs, in the input's dtype (autocast does not touch the op). An
    incoming gradient that is not channels_last is copied before K3."""
    y, _ = maxpool2x2_fwd(x.permute(0, 2, 3, 1).contiguous())
    return y.permute(0, 3, 1, 2)
