"""Batch-statistic BatchNorm + ReLU through hand-written CUDA kernels
(``csrc/batchnorm.cu``).

The JAX package leaves this arithmetic to XLA, which fuses it into the
neighbouring ops (``stereo_depth_estimation_tpu/models/unet.py:67-70`` and
``:86-88``, the flax BatchNorm; ``:133-138`` and ``:183-200``, the fused
block). The port computes it on four kernels wherever it computes the
BatchNorm itself (``models/unet.py``: ``MeshBatchNorm2d`` in training, with
the ReLU after it, and ``_FusedConvBNReLU``):

- BN1 ``bn_stats``: per-channel sum and sum of squares and the element
  count, (2C + 1) float32; with ``bf16_stats`` each sum is n times the
  bf16-rounded mean of bf16 values (of bf16-rounded squares), as the JAX
  BatchNorm's ``stats_dtype=bfloat16`` reduces them;
- BN2 ``bn_relu_fwd``: ``(x - mean) * scale + beta`` in float32, then the
  ReLU if ``relu``, stored in x's dtype;
- BN3 ``bn_relu_bwd_sums``: the sums of ``dyp`` and ``dyp * (z - mean)``,
  (2C) float32, where ``dyp`` is ``dy`` where BN2's pre-activation,
  recomputed bitwise, is above 0 (``dy`` itself with the ReLU off);
- BN4 ``bn_relu_bwd_dx``: ``dz = dyp * scale - t1 - (z - mean) * t2``,
  stored in z's dtype.

Every tensor is an (M, C) matrix, C contiguous: a channels_last activation
viewed as rows of channels (``rows``). The (C,) statistics and coefficients
are float32 and computed by the caller, so the plain version and the kernel
use the same ``scale``.

For each kernel: ``*_plain`` is the plain PyTorch version; ``*_cuda`` launches
the kernel on CUDA tensors only (anything else raises) and counts its
launches in ``.launches``; the ``torch.library`` custom op (``sde_torch::``)
runs the plain version for CPU tensors and the kernel for CUDA ones, with
a fake for tracing, so ``torch.compile`` keeps it in its graph as a call.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_DTYPES = (torch.float32, torch.bfloat16)


def rows(x: torch.Tensor) -> torch.Tensor:
    """The (N*H*W, C) view of a channels_last (N, C, H, W) tensor; raises on
    any other layout rather than copying."""
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"the BatchNorm kernels take channels_last (N, C, H, W) tensors, got "
            f"shape {tuple(x.shape)} strides {x.stride()}"
        )
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def unrows(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N*H*W, C) back to the channels_last (N, C, H, W) view of ``like``'s shape."""
    n, c, h, w = like.shape
    return y.view(n, h, w, c).permute(0, 3, 1, 2)


# The plain versions: the port's BatchNorm arithmetic as separate PyTorch
# ops, on (M, C) tensors.


def bn_stats_plain(x: torch.Tensor, bf16_stats: bool) -> torch.Tensor:
    """BN1: float32 (2C + 1,) = per-channel sum, sum of squares, count.
    With ``bf16_stats`` the sums are n times the means of the bf16 values
    and of their bf16-rounded squares, each mean rounded to bf16."""
    n = x.shape[0]
    count = torch.full((1,), n, dtype=torch.float32, device=x.device)
    if not bf16_stats:
        xf = x.float()
        return torch.cat([xf.sum(dim=0), (xf * xf).sum(dim=0), count])
    xs = x.to(torch.bfloat16)
    means = torch.cat([xs.mean(dim=0), (xs * xs).mean(dim=0)]).float()
    return torch.cat([means * n, count])


def _pre_activation(x, mean, scale, beta) -> torch.Tensor:
    return (x.float() - mean) * scale + beta


def bn_relu_fwd_plain(x, mean, scale, beta, relu: bool) -> torch.Tensor:
    """BN2: ``(x - mean) * scale + beta`` in float32, ReLU'd if ``relu``,
    in x's dtype."""
    y = _pre_activation(x, mean, scale, beta)
    return (torch.relu(y) if relu else y).to(x.dtype)


def _masked(dy, z, mean, scale, beta, relu: bool) -> torch.Tensor:
    if not relu:
        return dy.float()
    return torch.where(_pre_activation(z, mean, scale, beta) > 0, dy.float(), 0.0)


def bn_relu_bwd_sums_plain(dy, z, mean, scale, beta, relu: bool) -> torch.Tensor:
    """BN3: float32 (2C,) = sum of dyp, sum of dyp * (z - mean)."""
    dyp = _masked(dy, z, mean, scale, beta, relu)
    return torch.cat([dyp.sum(dim=0), (dyp * (z.float() - mean)).sum(dim=0)])


def bn_relu_bwd_dx_plain(dy, z, mean, scale, beta, t1, t2, relu: bool) -> torch.Tensor:
    """BN4: ``dyp * scale - t1 - (z - mean) * t2`` in z's dtype."""
    dyp = _masked(dy, z, mean, scale, beta, relu)
    return (dyp * scale - t1 - (z.float() - mean) * t2).to(z.dtype)


# The kernels' launchers.


def _check(what: str, *tensors: torch.Tensor, vectors: tuple[torch.Tensor, ...] = ()) -> None:
    """(M, C) CUDA tensors of one float32 or bf16 dtype, contiguous, and
    (C,) float32 contiguous vectors on their device."""
    first = tensors[0]
    for t in (*tensors, *vectors):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA BatchNorm kernels take CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{what}: every tensor must be on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    for t in tensors:
        if t.ndim != 2 or t.dtype not in _DTYPES:
            raise ValueError(
                f"{what} takes (M, C) float32 or bfloat16 tensors, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"{what}: tensors of one shape and dtype, got "
                             f"{tuple(t.shape)} {t.dtype} and {tuple(first.shape)} "
                             f"{first.dtype}")
    for v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (first.shape[1],):
            raise ValueError(f"{what}: (C,) float32 vectors, got {tuple(v.shape)} {v.dtype}")


class _BatchNormLibrary:
    """ctypes handles of ``csrc/batchnorm.cu``, bound at first launch."""

    def __init__(self) -> None:
        self._lib = None

    def get(self):
        if self._lib is None:
            lib = load_library("batchnorm")
            ptr, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            signatures = {
                "bn_stats": [ptr, ptr, ptr, i64, i64, i, i, ptr],
                "bn_relu_fwd": [ptr, ptr, ptr, ptr, ptr, i64, i64, i, i, ptr],
                "bn_relu_bwd_sums": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i, i, ptr],
                "bn_relu_bwd_dx": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i, i,
                                   ptr],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bn_error_string.argtypes = [ctypes.c_int]
            lib.bn_error_string.restype = ctypes.c_char_p
            lib.bn_max_chunks.restype = ctypes.c_int
            self._lib = lib
        return self._lib


_library = _BatchNormLibrary()


class _Kernel:
    """One launcher of ``csrc/batchnorm.cu``. ``launches`` counts its
    launches, and nothing else."""

    name = ""

    def __init__(self) -> None:
        self.launches = 0

    def _launch(self, device: torch.device, *args) -> None:
        lib = _library.get()
        with torch.cuda.device(device):
            code = getattr(lib, self.name)(*args, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{lib.bn_error_string(code).decode()}")
        self.launches += 1

    @staticmethod
    def _partials(x: torch.Tensor) -> torch.Tensor:
        """The reductions' scratch: (bn_max_chunks(), 2C) float32."""
        chunks = _library.get().bn_max_chunks()
        return torch.empty((chunks, 2 * x.shape[1]), dtype=torch.float32, device=x.device)


class BatchNormStatsKernel(_Kernel):
    """BN1: launches ``bn_stats`` on the current stream."""

    name = "bn_stats"

    def __call__(self, x: torch.Tensor, bf16_stats: bool) -> torch.Tensor:
        _check(self.name, x)
        m, c = x.shape
        out = torch.empty((2 * c + 1,), dtype=torch.float32, device=x.device)
        self._launch(x.device, x.data_ptr(), out.data_ptr(), self._partials(x).data_ptr(),
                     m, c, int(x.dtype == torch.bfloat16), int(bf16_stats))
        return out


class BatchNormReluForwardKernel(_Kernel):
    """BN2: launches ``bn_relu_fwd`` on the current stream."""

    name = "bn_relu_fwd"

    def __call__(self, x, mean, scale, beta, relu: bool) -> torch.Tensor:
        _check(self.name, x, vectors=(mean, scale, beta))
        y = torch.empty_like(x)
        self._launch(x.device, x.data_ptr(), mean.data_ptr(), scale.data_ptr(),
                     beta.data_ptr(), y.data_ptr(), *x.shape,
                     int(x.dtype == torch.bfloat16), int(relu))
        return y


class BatchNormReluBackwardSumsKernel(_Kernel):
    """BN3: launches ``bn_relu_bwd_sums`` on the current stream."""

    name = "bn_relu_bwd_sums"

    def __call__(self, dy, z, mean, scale, beta, relu: bool) -> torch.Tensor:
        _check(self.name, dy, z, vectors=(mean, scale, beta))
        out = torch.empty((2 * z.shape[1],), dtype=torch.float32, device=z.device)
        self._launch(z.device, dy.data_ptr(), z.data_ptr(), mean.data_ptr(),
                     scale.data_ptr(), beta.data_ptr(), out.data_ptr(),
                     self._partials(z).data_ptr(), *z.shape,
                     int(z.dtype == torch.bfloat16), int(relu))
        return out


class BatchNormReluBackwardDxKernel(_Kernel):
    """BN4: launches ``bn_relu_bwd_dx`` on the current stream."""

    name = "bn_relu_bwd_dx"

    def __call__(self, dy, z, mean, scale, beta, t1, t2, relu: bool) -> torch.Tensor:
        _check(self.name, dy, z, vectors=(mean, scale, beta, t1, t2))
        dz = torch.empty_like(z)
        self._launch(z.device, dy.data_ptr(), z.data_ptr(), mean.data_ptr(),
                     scale.data_ptr(), beta.data_ptr(), t1.data_ptr(), t2.data_ptr(),
                     dz.data_ptr(), *z.shape, int(z.dtype == torch.bfloat16), int(relu))
        return dz


bn_stats_cuda = BatchNormStatsKernel()
bn_relu_fwd_cuda = BatchNormReluForwardKernel()
bn_relu_bwd_sums_cuda = BatchNormReluBackwardSumsKernel()
bn_relu_bwd_dx_cuda = BatchNormReluBackwardDxKernel()


# The custom ops: the plain version is the CPU implementation, the kernel
# the CUDA one (no fallback from the kernel), with fakes for tracing.


@torch.library.custom_op("sde_torch::bn_stats", mutates_args=(), device_types="cpu")
def bn_stats(x: torch.Tensor, bf16_stats: bool) -> torch.Tensor:
    """BN1 on (M, C) ``x``: the plain version for a CPU tensor, the kernel
    for a CUDA one."""
    return bn_stats_plain(x, bf16_stats)


@bn_stats.register_kernel("cuda")
def _(x, bf16_stats):
    return bn_stats_cuda(x, bf16_stats)


@bn_stats.register_fake
def _(x, bf16_stats):
    return x.new_empty((2 * x.shape[1] + 1,), dtype=torch.float32)


@torch.library.custom_op("sde_torch::bn_relu_fwd", mutates_args=(), device_types="cpu")
def bn_relu_fwd(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                beta: torch.Tensor, relu: bool) -> torch.Tensor:
    """BN2 on (M, C) ``x``: the plain version for a CPU tensor, the kernel
    for a CUDA one."""
    return bn_relu_fwd_plain(x, mean, scale, beta, relu)


@bn_relu_fwd.register_kernel("cuda")
def _(x, mean, scale, beta, relu):
    return bn_relu_fwd_cuda(x, mean, scale, beta, relu)


@bn_relu_fwd.register_fake
def _(x, mean, scale, beta, relu):
    return torch.empty_like(x)


@torch.library.custom_op("sde_torch::bn_relu_bwd_sums", mutates_args=(), device_types="cpu")
def bn_relu_bwd_sums(dy: torch.Tensor, z: torch.Tensor, mean: torch.Tensor,
                     scale: torch.Tensor, beta: torch.Tensor, relu: bool) -> torch.Tensor:
    """BN3 on (M, C) ``dy`` and ``z``: the plain version for CPU tensors, the
    kernel for CUDA ones."""
    return bn_relu_bwd_sums_plain(dy, z, mean, scale, beta, relu)


@bn_relu_bwd_sums.register_kernel("cuda")
def _(dy, z, mean, scale, beta, relu):
    return bn_relu_bwd_sums_cuda(dy, z, mean, scale, beta, relu)


@bn_relu_bwd_sums.register_fake
def _(dy, z, mean, scale, beta, relu):
    return z.new_empty((2 * z.shape[1],), dtype=torch.float32)


@torch.library.custom_op("sde_torch::bn_relu_bwd_dx", mutates_args=(), device_types="cpu")
def bn_relu_bwd_dx(dy: torch.Tensor, z: torch.Tensor, mean: torch.Tensor,
                   scale: torch.Tensor, beta: torch.Tensor, t1: torch.Tensor,
                   t2: torch.Tensor, relu: bool) -> torch.Tensor:
    """BN4 on (M, C) ``dy`` and ``z``: the plain version for CPU tensors, the
    kernel for CUDA ones."""
    return bn_relu_bwd_dx_plain(dy, z, mean, scale, beta, t1, t2, relu)


@bn_relu_bwd_dx.register_kernel("cuda")
def _(dy, z, mean, scale, beta, t1, t2, relu):
    return bn_relu_bwd_dx_cuda(dy, z, mean, scale, beta, t1, t2, relu)


@bn_relu_bwd_dx.register_fake
def _(dy, z, mean, scale, beta, t1, t2, relu):
    return torch.empty_like(z)
