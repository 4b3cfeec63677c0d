"""PSMNet's concatenation cost volume through a hand-written CUDA kernel
(``csrc/cost_volume.cu``).

From the left and right feature maps (N, C, H, W) and a depth D (the
maximum disparity over the features' stride), the volume (N, 2C, D, H, W):
at disparity d and column w >= d the left features at w and the right
features at w - d, concatenated; zeros where w < d. The published PSMNet
(``models/stackhourglass.py``) fills it with a loop of D slice copies; its
backward sums the volume's gradient back over d.

- ``cost_volume_fwd_plain`` / ``cost_volume_bwd_plain``: the plain PyTorch
  versions, on NHWC features and the NDHWC volume (a gather and an
  ``index_add_``, sums in float32).
- ``cost_volume_fwd_cuda`` / ``cost_volume_bwd_cuda``: the kernels; they
  take CUDA tensors only, raise on anything else, and count their launches
  in ``.launches``.
- ``cost_volume_fwd`` / ``cost_volume_bwd``: the ``torch.library`` custom ops
  ``sde_torch::cost_volume_fwd`` / ``_bwd``, with the plain version as the
  CPU implementation and the kernel as the CUDA one (no fallback from the
  kernel), fakes for tracing, and the forward's autograd.
- ``cost_volume``: the op on the model's channels_last features, returning
  the channels_last_3d volume the first 3D convolution reads. The NHWC and
  NDHWC tensors are those layouts' memory, so no copy runs on either side.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_DTYPES = (torch.float32, torch.bfloat16)


def _shifts(depth: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, W) of disparity d and column w: whether w holds d (w >= d), and
    the right feature's column w - d (0 where it does not)."""
    shift = (torch.arange(width, device=device)[None, :]
             - torch.arange(depth, device=device)[:, None])
    return shift >= 0, shift.clamp(min=0)


def cost_volume_fwd_plain(left: torch.Tensor, right: torch.Tensor,
                          depth: int) -> torch.Tensor:
    """left, right (N, H, W, C) -> (N, D, H, W, 2C) in their dtype."""
    valid, source = _shifts(depth, left.shape[2], left.device)
    shifted = right[:, :, source].permute(0, 2, 1, 3, 4)  # (N, D, H, W, C)
    mask = valid[None, :, None, :, None]
    zero = torch.zeros((), dtype=left.dtype, device=left.device)
    return torch.cat([torch.where(mask, left[:, None], zero),
                      torch.where(mask, shifted, zero)], dim=-1)


def cost_volume_bwd_plain(dv: torch.Tensor, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dV (N, D, H, W, 2C) -> dleft, dright (N, H, W, C) in dV's dtype, the
    sums over d taken in float32."""
    n, depth, h, w, _ = dv.shape
    valid, source = _shifts(depth, w, dv.device)
    g = torch.where(valid[None, :, None, :, None], dv.float(), 0.0)
    dleft = g[..., :channels].sum(dim=1)
    dright = torch.zeros((n, h, w, channels), dtype=torch.float32, device=dv.device)
    rows = g[..., channels:].permute(0, 2, 1, 3, 4).reshape(n, h, depth * w, channels)
    dright.index_add_(2, source.reshape(-1), rows)
    return dleft.to(dv.dtype), dright.to(dv.dtype)


def _check(t: torch.Tensor, what: str, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA cost-volume kernels take CUDA tensors, got {t.device} "
                         f"({what})")
    if t.dtype not in _DTYPES or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-D float32 or bfloat16 tensor, "
                         f"got {tuple(t.shape)} strides {t.stride()} {t.dtype}")


class _CostVolumeLibrary:
    """ctypes handles of ``csrc/cost_volume.cu``, bound at first launch."""

    def __init__(self) -> None:
        self._lib = None

    def get(self):
        if self._lib is None:
            lib = load_library("cost_volume")
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for fn in (lib.cost_volume_fwd, lib.cost_volume_bwd):
                fn.argtypes = [p, p, p, i64, i64, i64, i64, i64, ctypes.c_int, p]
                fn.restype = ctypes.c_int
            lib.cost_volume_error_string.argtypes = [ctypes.c_int]
            lib.cost_volume_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


_library = _CostVolumeLibrary()


def _launch(name: str, like: torch.Tensor, ptrs: tuple[int, int, int], shape) -> None:
    lib = _library.get()
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(*ptrs, *shape, int(like.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: {lib.cost_volume_error_string(code).decode()}")


class CostVolumeForwardKernel:
    """Launches ``cost_volume_fwd`` on the current stream. ``launches``
    counts the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
        _check(left, "left", 4)
        _check(right, "right", 4)
        if right.shape != left.shape or right.dtype != left.dtype or \
                right.device != left.device:
            raise ValueError(f"left and right must match, got {tuple(left.shape)} "
                             f"{left.dtype} {left.device} and {tuple(right.shape)} "
                             f"{right.dtype} {right.device}")
        n, h, w, c = left.shape
        out = torch.empty((n, depth, h, w, 2 * c), dtype=left.dtype, device=left.device)
        if out.numel() == 0:
            return out
        _launch("cost_volume_fwd", left, (left.data_ptr(), right.data_ptr(), out.data_ptr()),
                (n, depth, h, w, c))
        self.launches += 1
        return out


class CostVolumeBackwardKernel:
    """Launches ``cost_volume_bwd`` on the current stream. ``launches``
    counts the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, dv: torch.Tensor, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
        _check(dv, "dv", 5)
        n, depth, h, w, c2 = dv.shape
        if c2 != 2 * channels:
            raise ValueError(f"dv has {c2} channels, expected 2 x {channels}")
        dleft = torch.empty((n, h, w, channels), dtype=dv.dtype, device=dv.device)
        dright = torch.empty_like(dleft)
        if dleft.numel() == 0:
            return dleft, dright
        _launch("cost_volume_bwd", dv, (dv.data_ptr(), dleft.data_ptr(), dright.data_ptr()),
                (n, depth, h, w, channels))
        self.launches += 1
        return dleft, dright


cost_volume_fwd_cuda = CostVolumeForwardKernel()
cost_volume_bwd_cuda = CostVolumeBackwardKernel()


# The custom ops: the plain version is the CPU implementation, the kernel the
# CUDA one (no fallback from the kernel), with fakes for tracing.


@torch.library.custom_op("sde_torch::cost_volume_fwd", mutates_args=(), device_types="cpu")
def cost_volume_fwd(left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
    """NHWC features -> NDHWC volume: the plain version for CPU tensors, the
    kernel for CUDA ones."""
    return cost_volume_fwd_plain(left, right, depth)


@cost_volume_fwd.register_kernel("cuda")
def _(left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
    return cost_volume_fwd_cuda(left, right, depth)


@cost_volume_fwd.register_fake
def _(left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
    n, h, w, c = left.shape
    return left.new_empty((n, depth, h, w, 2 * c))


@torch.library.custom_op("sde_torch::cost_volume_bwd", mutates_args=(), device_types="cpu")
def cost_volume_bwd(dv: torch.Tensor, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NDHWC volume gradient -> the NHWC features' gradients: the plain
    version for CPU tensors, the kernel for CUDA ones."""
    return cost_volume_bwd_plain(dv, channels)


@cost_volume_bwd.register_kernel("cuda")
def _(dv: torch.Tensor, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    return cost_volume_bwd_cuda(dv, channels)


@cost_volume_bwd.register_fake
def _(dv: torch.Tensor, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    n, _, h, w, _ = dv.shape
    dleft = dv.new_empty((n, h, w, channels))
    return dleft, dv.new_empty((n, h, w, channels))


def _save_channels(ctx, inputs, output) -> None:
    ctx.channels = inputs[0].shape[-1]


def _volume_backward(ctx, dv: torch.Tensor):
    dleft, dright = cost_volume_bwd(dv.contiguous(), ctx.channels)
    return dleft, dright, None


cost_volume_fwd.register_autograd(_volume_backward, setup_context=_save_channels)


def cost_volume(left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
    """The (N, 2C, D, H, W) cost volume of (N, C, H, W) feature maps, as a
    channels_last_3d view of the op's NDHWC output; a channels_last input is
    not copied, another is made NHWC first. The incoming gradient, which the
    3D convolution gives channels_last_3d, is the NDHWC tensor the backward
    kernel reads."""
    volume = cost_volume_fwd(left.permute(0, 2, 3, 1).contiguous(),
                             right.permute(0, 2, 3, 1).contiguous(), depth)
    return volume.permute(0, 4, 1, 2, 3)
