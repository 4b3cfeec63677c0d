"""Batch-statistic BatchNorm + ReLU through hand-written CUDA kernels
(``csrc/batchnorm.cu``).

The JAX package leaves this arithmetic to XLA, which fuses it into the
neighbouring ops (``stereo_depth_estimation_tpu/models/unet.py:67-70`` and
``:86-88``, the flax BatchNorm; ``:133-138`` and ``:183-200``, the fused
block). The port computes every training BatchNorm on four kernels
(``models/unet.py``: ``MeshBatchNorm2d``, with the ReLU after it):

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

BN2, BN3 and BN4 read the mean and scale from ``stats``, (3C + 1) float32 =
mean, var = E[x^2] - E[x]^2 (biased), scale = gamma / sqrt(var + eps) and
n, and BN4 reads t1, t2 from ``coef``, (4C) float32 = dbeta, dgamma, t1,
t2. Both come from a per-channel epilogue in the second pass of BN1 and of
BN3, written once:

- ``bn_relu_forward``: BN1 with the epilogue (``stats``, and
  nn.BatchNorm2d's running update in place: momentum, the unbiased var,
  ``num_batches_tracked`` + 1), then BN2: a training forward from one call;
- ``bn_relu_backward``: BN3 with the epilogue (``coef``), then BN4;
- with a group of several ranks the sums are all-reduced before the
  epilogue, which then runs alone on them: ``bn_moments`` after BN1,
  ``bn_bwd_coefficients`` after BN3 (dbeta and dgamma stay this rank's).

An activation is an (M, C) matrix, C contiguous, a channels_last (N, C, H,
W) tensor or a channels_last_3d (N, C, D, H, W) volume, each one such
matrix in memory (``rows``); an op returns its activation in the layout it
took.

For each op: ``*_plain`` is the plain PyTorch version; ``*_cuda`` launches
the kernel on CUDA tensors only (anything else raises) and counts its
launches in ``.launches``; the op itself (``torch.ops.sde_torch.*``,
registered with ``torch.library.Library``, whose eager dispatch costs a few
microseconds) runs the plain version for CPU tensors and the kernel for CUDA
ones, with a fake for tracing, so ``torch.compile`` keeps it in its graph as
a call. The ops that update the running buffers declare them mutated.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_DTYPES = (torch.float32, torch.bfloat16)


def rows(x: torch.Tensor) -> torch.Tensor:
    """The (N*H*W, C) view of a channels_last (N, C, H, W) tensor, or the
    (N*D*H*W, C) view of a channels_last_3d (N, C, D, H, W) volume; raises
    on any other layout rather than copying."""
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    if x.ndim == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        return x.permute(0, 2, 3, 4, 1).reshape(-1, x.shape[1])
    raise ValueError(
        f"the BatchNorm kernels take channels_last (N, C, H, W) tensors or "
        f"channels_last_3d (N, C, D, H, W) volumes, got shape {tuple(x.shape)} "
        f"strides {x.stride()}"
    )


def unrows(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Rows back to the channels_last (N, C, H, W) or channels_last_3d (N, C,
    D, H, W) view of ``like``'s shape."""
    if like.ndim == 4:
        n, c, h, w = like.shape
        return y.view(n, h, w, c).permute(0, 3, 1, 2)
    n, c, d, h, w = like.shape
    return y.view(n, d, h, w, c).permute(0, 4, 1, 2, 3)


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    return x if x.ndim == 2 else rows(x)


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rows ``y`` in the layout of the activation ``x``."""
    return y if x.ndim == 2 else unrows(y, x)


# The plain versions: the port's BatchNorm arithmetic as separate PyTorch
# ops. Every step of the per-channel epilogue is one correctly rounded
# operation, as in the kernel, so both give the same bits from the same sums.


def bn_stats_plain(x: torch.Tensor, bf16_stats: bool) -> torch.Tensor:
    """BN1: float32 (2C + 1,) = per-channel sum, sum of squares, count.
    With ``bf16_stats`` the sums are n times the means of the bf16 values
    and of their bf16-rounded squares, each mean rounded to bf16."""
    x = _as_rows(x)
    n = x.shape[0]
    count = torch.full((1,), n, dtype=torch.float32, device=x.device)
    if not bf16_stats:
        xf = x.float()
        return torch.cat([xf.sum(dim=0), (xf * xf).sum(dim=0), count])
    xs = x.to(torch.bfloat16)
    means = torch.cat([xs.mean(dim=0), (xs * xs).mean(dim=0)]).float()
    return torch.cat([means * n, count])


def _inv_std(var: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sqrt(var + eps).reciprocal()


def bn_moments_plain(sums, gamma, running_mean, running_var, num_batches_tracked,
                     eps: float, momentum: float) -> torch.Tensor:
    """The forward epilogue on BN1's (2C + 1) sums: float32 (3C + 1,) =
    mean, var = E[x^2] - E[x]^2, scale = gamma / sqrt(var + eps), n; and
    nn.BatchNorm2d's running update in place (the unbiased var, n / (n - 1),
    into ``running_var``; ``num_batches_tracked`` + 1)."""
    c = gamma.shape[0]
    n = sums[2 * c:]
    mean = sums[:c] / n
    var = sums[c:2 * c] / n - mean * mean
    scale = _inv_std(var, eps) * gamma
    num_batches_tracked.add_(1)
    unbiased = var * (n / (n - 1.0).clamp(min=1.0))
    running_mean.mul_(1.0 - momentum).add_(momentum * mean)
    running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
    return torch.cat([mean, var, scale, n])


# The elementwise passes below run in place on their first result: the same
# operations in the same order, without a new tensor each.


def _centred(x, stats) -> torch.Tensor:
    """x - mean, float32, a new tensor."""
    return x.float() - stats[:x.shape[1]]


def _pre_activation(x, stats, beta) -> torch.Tensor:
    c = x.shape[1]
    return _centred(x, stats).mul_(stats[2 * c:3 * c]).add_(beta)


def bn_relu_fwd_plain(x, stats, beta, relu: bool) -> torch.Tensor:
    """BN2: ``(x - mean) * scale + beta`` in float32, ReLU'd if ``relu``,
    in x's dtype."""
    y = _pre_activation(_as_rows(x), stats, beta)
    return _like((y.relu_() if relu else y).to(x.dtype), x)


def _masked(dy, z, stats, beta, relu: bool) -> torch.Tensor:
    """dyp: dy in float32 where BN2's pre-activation is above 0, else 0 (also
    where it is NaN). ReLU's backward on the pre-activation with its NaNs
    read as 0 gives exactly that, in a tenth of ``torch.where``'s time on a
    CPU."""
    if not relu:
        return dy.float()
    pre = _pre_activation(z, stats, beta).nan_to_num_(nan=0.0)
    return torch.ops.aten.threshold_backward(dy.float(), pre, 0.0)


def _grad_sums(dyp, centred) -> torch.Tensor:
    return torch.cat([dyp.sum(dim=0), (centred * dyp).sum(dim=0)])


def bn_relu_bwd_sums_plain(dy, z, stats, beta, relu: bool) -> torch.Tensor:
    """BN3: float32 (2C,) = sum of dyp, sum of dyp * (z - mean)."""
    dy, z = _as_rows(dy), _as_rows(z)
    return _grad_sums(_masked(dy, z, stats, beta, relu), _centred(z, stats))


def bn_bwd_coefficients_plain(total, local, stats, eps: float) -> torch.Tensor:
    """The backward epilogue on BN3's (2C) sums ``total``: float32 (4C,) =
    dbeta, dgamma (both from ``local``, this rank's sums: the first sum and
    the second times 1 / sqrt(var + eps)), t1 = scale * dbeta / n and t2 =
    scale * (dgamma / sqrt(var + eps)) / n of the total."""
    c = total.shape[0] // 2
    var, scale, n = stats[c:2 * c], stats[2 * c:3 * c], stats[3 * c:]
    inv = _inv_std(var, eps)
    t1 = scale * (total[:c] / n)
    t2 = scale * (inv * (total[c:] * inv) / n)
    return torch.cat([local[:c], local[c:] * inv, t1, t2])


def _dz(dyp, centred, stats, coef, like) -> torch.Tensor:
    """dyp * scale - t1 - (z - mean) * t2 in ``like``'s dtype and layout
    (``centred`` is used up)."""
    c = dyp.shape[1]
    dz = (dyp * stats[2 * c:3 * c]).sub_(coef[2 * c:3 * c]).sub_(centred.mul_(coef[3 * c:]))
    return _like(dz.to(like.dtype), like)


def bn_relu_bwd_dx_plain(dy, z, stats, beta, coef, relu: bool) -> torch.Tensor:
    """BN4: ``dyp * scale - t1 - (z - mean) * t2`` in z's dtype."""
    dyr, zr = _as_rows(dy), _as_rows(z)
    return _dz(_masked(dyr, zr, stats, beta, relu), _centred(zr, stats), stats, coef, z)


def bn_relu_forward_plain(x, gamma, beta, running_mean, running_var, num_batches_tracked,
                          eps: float, momentum: float, bf16_stats: bool,
                          relu: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A training BatchNorm (+ ReLU) forward: BN1 with its epilogue, then
    BN2. (y, stats); the running buffers updated in place."""
    stats = bn_moments_plain(bn_stats_plain(x, bf16_stats), gamma, running_mean, running_var,
                             num_batches_tracked, eps, momentum)
    return bn_relu_fwd_plain(x, stats, beta, relu), stats


def bn_relu_backward_plain(dy, z, stats, beta, eps: float,
                           relu: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A training BatchNorm (+ ReLU) backward: BN3 with its epilogue, then
    BN4. (dz, coef), coef = dbeta, dgamma, t1, t2 of its own sums."""
    dyr, zr = _as_rows(dy), _as_rows(z)
    dyp, centred = _masked(dyr, zr, stats, beta, relu), _centred(zr, stats)
    sums = _grad_sums(dyp, centred)
    coef = bn_bwd_coefficients_plain(sums, sums, stats, eps)
    return _dz(dyp, centred, stats, coef, z), coef


# The kernels' launchers.


def _cuda(what: str, t: torch.Tensor) -> int:
    """The CUDA device index of ``t``; raises for any other device."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA BatchNorm kernels take CUDA tensors, got {t.device} "
                         f"({what})")
    return t.get_device()


def _check(what: str, *tensors: torch.Tensor) -> tuple[int, int]:
    """(M, C) of CUDA activations of one shape, dtype (float32 or bf16) and
    device, each (M, C) contiguous, channels_last (N, C, H, W) or
    channels_last_3d (N, C, D, H, W)."""
    first = tensors[0]
    index = _cuda(what, first)
    for t in tensors:
        laid = (t.is_contiguous() if t.ndim == 2 else
                t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last)
                or t.ndim == 5 and t.is_contiguous(memory_format=torch.channels_last_3d))
        if not laid or t.dtype not in _DTYPES:
            raise ValueError(f"{what} takes (M, C) contiguous, channels_last (N, C, H, W) "
                             f"or channels_last_3d (N, C, D, H, W) float32 or bfloat16 "
                             f"tensors, got {tuple(t.shape)} strides {t.stride()} {t.dtype}")
        if t.shape != first.shape or t.dtype != first.dtype or t.get_device() != index:
            raise ValueError(f"{what}: tensors of one shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} and "
                             f"{tuple(first.shape)} {first.dtype} {first.device}")
    c = first.shape[1]
    return first.numel() // c, c


def _check_vectors(what: str, index: int, *vectors: tuple[torch.Tensor, int]) -> None:
    """Contiguous float32 vectors of the given lengths on CUDA device ``index``."""
    for v, size in vectors:
        if (v.get_device() != index or v.dtype != torch.float32 or v.numel() != size
                or not v.is_contiguous()):
            raise ValueError(f"{what}: {size} contiguous float32 values on cuda:{index}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _check_running(what, index, c, running_mean, running_var, tracked) -> None:
    _check_vectors(what, index, (running_mean, c), (running_var, c))
    if tracked.get_device() != index or tracked.dtype != torch.int64 or tracked.numel() != 1:
        raise ValueError(f"{what}: num_batches_tracked must be one int64 on cuda:{index}, "
                         f"got {tuple(tracked.shape)} {tracked.dtype} on {tracked.device}")


class _BatchNormLibrary:
    """ctypes handles of ``csrc/batchnorm.cu``, bound at first launch."""

    def __init__(self) -> None:
        self._lib = None

    def get(self):
        if self._lib is None:
            lib = load_library("batchnorm")
            p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            f32, f64 = ctypes.c_float, ctypes.c_double
            signatures = {
                "bn_stats": [p, p, i64, i64, i, i, p, p],
                "bn_relu_forward": [p, p, p, p, p, p, p, p, i64, i64, i, i, i, f32, f64, p, p],
                "bn_moments": [p, p, p, p, p, p, i64, f32, f64, p],
                "bn_relu_fwd": [p, p, p, p, i64, i64, i, i, p],
                "bn_relu_bwd_sums": [p, p, p, p, p, i64, i64, i, i, p, p],
                "bn_relu_backward": [p, p, p, p, p, p, i64, i64, i, i, f32, p, p],
                "bn_bwd_coefficients": [p, p, p, p, i64, f32, p],
                "bn_relu_bwd_dx": [p, p, p, p, p, p, i64, i64, i, i, p],
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

# The reductions' scratch, (bn_max_chunks(), 2C) float32, one per device,
# stream and C: kept, as launches on one stream run in order.
_scratch: dict[tuple[int, int, int], torch.Tensor] = {}


def _partials(index: int, stream: int, c: int) -> int:
    key = (index, stream, c)
    buf = _scratch.get(key)
    if buf is None:
        chunks = _library.get().bn_max_chunks()
        buf = _scratch[key] = torch.empty((chunks, 2 * c), dtype=torch.float32,
                                          device=torch.device("cuda", index))
    return buf.data_ptr()


class _Kernel:
    """One launcher of ``csrc/batchnorm.cu``. ``launches`` counts its
    launches, and nothing else."""

    name = ""

    def __init__(self) -> None:
        self.launches = 0

    def _launch(self, index: int, c: int, *args, scratch: bool = False) -> None:
        """Launches on the current stream of CUDA device ``index``;
        ``scratch``: the reductions' partials go after ``args``. The device
        is made current and its raw stream read by the calls that
        ``torch.cuda.device`` and Inductor's launchers make, at a tenth of
        ``torch.cuda.device`` and ``current_stream()``'s host cost."""
        lib = _library.get()
        previous = torch._C._cuda_exchangeDevice(index)
        try:
            stream = torch._C._cuda_getCurrentRawStream(index)
            if scratch:
                args = (*args, _partials(index, stream, c))
            code = getattr(lib, self.name)(*args, stream)
        finally:
            torch._C._cuda_maybeExchangeDevice(previous)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{lib.bn_error_string(code).decode()}")
        self.launches += 1


def _bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _f32(size: int, like: torch.Tensor) -> torch.Tensor:
    return like.new_empty((size,), dtype=torch.float32)


class BatchNormStatsKernel(_Kernel):
    """BN1, the sums: launches ``bn_stats``."""

    name = "bn_stats"

    def __call__(self, x: torch.Tensor, bf16_stats: bool) -> torch.Tensor:
        m, c = _check(self.name, x)
        out = _f32(2 * c + 1, x)
        self._launch(x.get_device(), c, x.data_ptr(), out.data_ptr(), m, c, _bf16(x),
                     int(bf16_stats), scratch=True)
        return out


class BatchNormMomentsKernel(_Kernel):
    """The forward epilogue alone, on reduced sums: launches ``bn_moments``."""

    name = "bn_moments"

    def __call__(self, sums, gamma, running_mean, running_var, num_batches_tracked,
                 eps: float, momentum: float) -> torch.Tensor:
        index = _cuda(self.name, sums)
        c = gamma.shape[0]
        _check_vectors(self.name, index, (sums, 2 * c + 1), (gamma, c))
        _check_running(self.name, index, c, running_mean, running_var, num_batches_tracked)
        stats = _f32(3 * c + 1, sums)
        self._launch(index, c, sums.data_ptr(), stats.data_ptr(), gamma.data_ptr(),
                     running_mean.data_ptr(), running_var.data_ptr(),
                     num_batches_tracked.data_ptr(), c, eps, momentum)
        return stats


class BatchNormReluForwardKernel(_Kernel):
    """BN2: launches ``bn_relu_fwd``."""

    name = "bn_relu_fwd"

    def __call__(self, x, stats, beta, relu: bool) -> torch.Tensor:
        m, c = _check(self.name, x)
        index = x.get_device()
        _check_vectors(self.name, index, (stats, 3 * c + 1), (beta, c))
        y = torch.empty_like(x)
        self._launch(index, c, x.data_ptr(), stats.data_ptr(), beta.data_ptr(), y.data_ptr(),
                     m, c, _bf16(x), int(relu))
        return y


class BatchNormReluBackwardSumsKernel(_Kernel):
    """BN3, the sums: launches ``bn_relu_bwd_sums``."""

    name = "bn_relu_bwd_sums"

    def __call__(self, dy, z, stats, beta, relu: bool) -> torch.Tensor:
        m, c = _check(self.name, dy, z)
        index = z.get_device()
        _check_vectors(self.name, index, (stats, 3 * c + 1), (beta, c))
        out = _f32(2 * c, stats)
        self._launch(index, c, dy.data_ptr(), z.data_ptr(), stats.data_ptr(), beta.data_ptr(),
                     out.data_ptr(), m, c, _bf16(z), int(relu), scratch=True)
        return out


class BatchNormBackwardCoefficientsKernel(_Kernel):
    """The backward epilogue alone, on reduced sums: launches
    ``bn_bwd_coefficients``."""

    name = "bn_bwd_coefficients"

    def __call__(self, total, local, stats, eps: float) -> torch.Tensor:
        index = _cuda(self.name, total)
        c = total.shape[0] // 2
        _check_vectors(self.name, index, (total, 2 * c), (local, 2 * c), (stats, 3 * c + 1))
        coef = _f32(4 * c, total)
        self._launch(index, c, total.data_ptr(), local.data_ptr(), stats.data_ptr(),
                     coef.data_ptr(), c, eps)
        return coef


class BatchNormReluBackwardDxKernel(_Kernel):
    """BN4: launches ``bn_relu_bwd_dx``."""

    name = "bn_relu_bwd_dx"

    def __call__(self, dy, z, stats, beta, coef, relu: bool) -> torch.Tensor:
        m, c = _check(self.name, dy, z)
        index = z.get_device()
        _check_vectors(self.name, index, (stats, 3 * c + 1), (beta, c), (coef, 4 * c))
        dz = torch.empty_like(z)
        self._launch(index, c, dy.data_ptr(), z.data_ptr(), stats.data_ptr(), beta.data_ptr(),
                     coef.data_ptr(), dz.data_ptr(), m, c, _bf16(z), int(relu))
        return dz


class BatchNormReluForwardPass(_Kernel):
    """BN1 with the epilogue, then BN2, from one call: launches
    ``bn_relu_forward``. Returns (y, stats)."""

    name = "bn_relu_forward"

    def __call__(self, x, gamma, beta, running_mean, running_var, num_batches_tracked,
                 eps: float, momentum: float, bf16_stats: bool,
                 relu: bool) -> tuple[torch.Tensor, torch.Tensor]:
        m, c = _check(self.name, x)
        index = x.get_device()
        _check_vectors(self.name, index, (gamma, c), (beta, c))
        _check_running(self.name, index, c, running_mean, running_var, num_batches_tracked)
        stats, y = _f32(3 * c + 1, gamma), torch.empty_like(x)
        self._launch(index, c, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     running_mean.data_ptr(), running_var.data_ptr(),
                     num_batches_tracked.data_ptr(), stats.data_ptr(), y.data_ptr(), m, c,
                     _bf16(x), int(bf16_stats), int(relu), eps, momentum, scratch=True)
        return y, stats


class BatchNormReluBackwardPass(_Kernel):
    """BN3 with the epilogue, then BN4, from one call: launches
    ``bn_relu_backward``. Returns (dz, coef)."""

    name = "bn_relu_backward"

    def __call__(self, dy, z, stats, beta, eps: float,
                 relu: bool) -> tuple[torch.Tensor, torch.Tensor]:
        m, c = _check(self.name, dy, z)
        index = z.get_device()
        _check_vectors(self.name, index, (stats, 3 * c + 1), (beta, c))
        coef, dz = _f32(4 * c, stats), torch.empty_like(z)
        self._launch(index, c, dy.data_ptr(), z.data_ptr(), stats.data_ptr(), beta.data_ptr(),
                     coef.data_ptr(), dz.data_ptr(), m, c, _bf16(z), int(relu), eps,
                     scratch=True)
        return dz, coef


bn_stats_cuda = BatchNormStatsKernel()
bn_moments_cuda = BatchNormMomentsKernel()
bn_relu_fwd_cuda = BatchNormReluForwardKernel()
bn_relu_bwd_sums_cuda = BatchNormReluBackwardSumsKernel()
bn_bwd_coefficients_cuda = BatchNormBackwardCoefficientsKernel()
bn_relu_bwd_dx_cuda = BatchNormReluBackwardDxKernel()
bn_relu_forward_cuda = BatchNormReluForwardPass()
bn_relu_backward_cuda = BatchNormReluBackwardPass()


# The ops: the plain version is the CPU implementation, the kernel the CUDA
# one (no fallback from the kernel), with fakes for tracing.

_lib = torch.library.Library("sde_torch", "FRAGMENT")


def _op(schema: str, plain, cuda, fake):
    name = schema[: schema.index("(")]
    _lib.define(schema)
    _lib.impl(name, plain, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"sde_torch::{name}", fake, lib=_lib)
    return getattr(torch.ops.sde_torch, name).default


_RUNNING = "Tensor(a!) running_mean, Tensor(b!) running_var, Tensor(c!) num_batches_tracked"

bn_stats = _op(
    "bn_stats(Tensor x, bool bf16_stats) -> Tensor",
    bn_stats_plain, bn_stats_cuda,
    lambda x, bf16_stats: _f32(2 * x.shape[1] + 1, x))
bn_moments = _op(
    f"bn_moments(Tensor sums, Tensor gamma, {_RUNNING}, float eps, float momentum) -> Tensor",
    bn_moments_plain, bn_moments_cuda,
    lambda sums, gamma, *args: _f32(3 * gamma.shape[0] + 1, sums))
bn_relu_fwd = _op(
    "bn_relu_fwd(Tensor x, Tensor stats, Tensor beta, bool relu) -> Tensor",
    bn_relu_fwd_plain, bn_relu_fwd_cuda,
    lambda x, *args: torch.empty_like(x))
bn_relu_bwd_sums = _op(
    "bn_relu_bwd_sums(Tensor dy, Tensor z, Tensor stats, Tensor beta, bool relu) -> Tensor",
    bn_relu_bwd_sums_plain, bn_relu_bwd_sums_cuda,
    lambda dy, z, *args: _f32(2 * z.shape[1], z))
bn_bwd_coefficients = _op(
    "bn_bwd_coefficients(Tensor total, Tensor local, Tensor stats, float eps) -> Tensor",
    bn_bwd_coefficients_plain, bn_bwd_coefficients_cuda,
    lambda total, *args: _f32(2 * total.shape[0], total))
bn_relu_bwd_dx = _op(
    "bn_relu_bwd_dx(Tensor dy, Tensor z, Tensor stats, Tensor beta, Tensor coef, bool relu) "
    "-> Tensor",
    bn_relu_bwd_dx_plain, bn_relu_bwd_dx_cuda,
    lambda dy, z, *args: torch.empty_like(z))
bn_relu_forward = _op(
    f"bn_relu_forward(Tensor x, Tensor gamma, Tensor beta, {_RUNNING}, float eps, "
    "float momentum, bool bf16_stats, bool relu) -> (Tensor, Tensor)",
    bn_relu_forward_plain, bn_relu_forward_cuda,
    lambda x, gamma, *args: (torch.empty_like(x), _f32(3 * x.shape[1] + 1, gamma)))
bn_relu_backward = _op(
    "bn_relu_backward(Tensor dy, Tensor z, Tensor stats, Tensor beta, float eps, bool relu) "
    "-> (Tensor, Tensor)",
    bn_relu_backward_plain, bn_relu_backward_cuda,
    lambda dy, z, stats, *args: (torch.empty_like(z), _f32(4 * z.shape[1], stats)))
