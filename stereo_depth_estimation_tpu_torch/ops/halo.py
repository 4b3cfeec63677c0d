"""Halo exchange between the height stripes of a spatial group of ranks.

On a mesh that shards image height (``parallel/mesh.py``, the JAX package's
``spatial`` axis) each rank holds a stripe of rows of every image. A 3x3
convolution and the augmentation's blur read rows of the neighbouring
stripes. XLA's SPMD partitioner inserts those exchanges for the JAX package;
the port makes them here.

One exchange is one ``all_reduce`` over the spatial group of a zero buffer
of shape (S, 2, N, rows, W, C): rank s writes its first and its last
``rows`` rows into slot s and reads its neighbours' slots. Every element of
the buffer has one writer, so the sum is exact in any dtype. ``all_reduce``
is one of the two collectives that gloo runs on CUDA tensors, so one code
path serves NCCL, gloo on CUDA and gloo on the CPU
(``parallel/distributed.py``).

Tensors are NHWC, (N, h, W, C) with height at dim 1: the memory layout of
the model's channels_last activations and of the uint8 image batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class SpatialGroup:
    """The ranks of one data row of the mesh, the top stripe first: this
    rank's ``index`` among the ``size`` ranks of the ``torch.distributed``
    ``group``."""

    group: Any
    index: int
    size: int

    def sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the group, in place."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def pad(self, x: torch.Tensor, rows: int = 1) -> torch.Tensor:
        """``x`` (N, h, W, C) with ``rows`` rows of the stripe above on top
        and of the stripe below underneath, zeros at the image's top and
        bottom, as a convolution's zero padding has them: (N, h + 2 rows, W,
        C). Differentiable: the halo rows' gradients go back to the ranks
        that own those rows."""
        return _HaloPad.apply(x, self.group, self.index, self.size, rows)

    @torch.no_grad()
    def extend(self, x: torch.Tensor, rows: int) -> tuple[torch.Tensor, int]:
        """``x`` (N, h, W, C) with ``rows`` rows of each neighbouring stripe,
        and nothing added at the image's top and bottom; and the number of
        rows added on top, where ``x`` starts in the result."""
        above, below = _exchange(x[:, :rows], x[:, x.shape[1] - rows:], self.group,
                                 self.index, self.size)
        top = rows if self.index > 0 else 0
        parts = [above] if top else []
        parts.append(x)
        if self.index < self.size - 1:
            parts.append(below)
        return torch.cat(parts, dim=1), top


@dataclass(frozen=True)
class Stripe:
    """Rows [start, start + h) of images ``height`` rows high, held by
    ``spatial.index`` of its group (h is the stripe's own height)."""

    spatial: SpatialGroup
    start: int
    height: int


def _exchange(
    first: torch.Tensor, last: torch.Tensor, group, index: int, size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank sends ``first`` up and ``last`` down; returns (the ``last``
    of the rank above, the ``first`` of the rank below), zeros where there
    is no such rank. One all-reduce of (size, 2, *first.shape)."""
    if first.shape[1] == 0 or first.shape != last.shape:
        raise ValueError(f"halo rows {tuple(first.shape)} and {tuple(last.shape)}")
    buf = first.new_zeros((size, 2, *first.shape))
    buf[index, 0] = first
    buf[index, 1] = last
    dist.all_reduce(buf, group=group)
    above = buf[index - 1, 1] if index > 0 else torch.zeros_like(buf[index, 1])
    below = buf[index + 1, 0] if index < size - 1 else torch.zeros_like(buf[index, 0])
    return above, below


class _HaloPad(torch.autograd.Function):
    """(N, h, W, C) -> (N, h + 2 rows, W, C) with the neighbours' rows. The
    backward is the reverse exchange: each halo row's gradient is added into
    the row it was copied from, on the rank that owns it (with h == rows
    both neighbours' gradients land on the same rows)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, index: int, size: int, rows: int):
        h = x.shape[1]
        if not 0 < rows <= h:
            raise ValueError(f"a halo of {rows} rows around a stripe of {h}")
        ctx.group, ctx.index, ctx.size, ctx.rows = group, index, size, rows
        above, below = _exchange(x[:, :rows], x[:, h - rows:], group, index, size)
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        r, index, size = ctx.rows, ctx.index, ctx.size
        h = grad.shape[1] - 2 * r
        # The top halo's gradient belongs to the last rows of the rank above,
        # the bottom halo's to the first rows of the rank below.
        from_above, from_below = _exchange(grad[:, :r], grad[:, r + h:], ctx.group, index,
                                           size)
        dx = grad[:, r:r + h].clone()
        if index > 0:
            dx[:, :r] += from_above
        if index < size - 1:
            dx[:, h - r:] += from_below
        return dx, None, None, None, None
