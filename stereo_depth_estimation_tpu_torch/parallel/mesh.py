"""The rank group, height blocks, and static-shape batch padding with rank-1
row flags.

Counterpart of ``stereo_depth_estimation_tpu/parallel/mesh.py``. The JAX
package runs one process per host over a mesh of that host's devices; the
port runs one process per device, a rank of a ``torch.distributed`` group.
``Mesh`` describes that group as one rank sees it (world size, rank, device,
group), and ``make_mesh`` is the counterpart of the JAX ``make_mesh``.

With ``spatial`` S > 1 the ranks form the JAX package's 2-D ``(data,
spatial)`` mesh: rank r is data row r // S and spatial block r % S (JAX
reshapes the devices to (n // S, S)). Batches shard over the data rows and
image height over the S ranks of a row, as JAX's ``P(data, spatial)``; rank-1
row flags shard over the data rows only. Height is cut into blocks of 16 rows
and spatial rank s takes a contiguous run of them, as even as possible
(``height_blocks``: 240 rows over 2 ranks are 128 and 112), so every pool
level has an even local height. JAX splits height evenly and pads an uneven
shard instead; the model computes the same either way. The S ranks of a row
share a ``SpatialGroup`` for the halo exchanges (``ops/halo.py``).

- ``pad_batch_to``: the epoch's tail batch is padded up to the static batch
  size with wrap-around rows whose ``valid_mask`` flag is False: BatchNorm
  sees plausible images, and the loss and every metric sum ignore those rows
  (``train_step._targets_and_mask`` ANDs the flags with ``target > 0``).
  Every batch carries the flags, so every batch has one structure.
- ``pad_batch_for_mesh`` pads the same way to a multiple of the data rows,
  ``shard_batch_to_mesh`` then puts this rank's block on its device, and
  ``replicate_to_mesh`` broadcasts rank 0's weights, buffers and AdamW state
  after a checkpoint load.

``batch_sharding`` and ``replicated_sharding`` have no counterpart: a rank
holds its stripe of a batch as a plain tensor and its own full copy of the
weights, so there is no sharding to name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ops.halo import SpatialGroup

# Height is split in blocks of this many rows: the model's four 2x2 pools
# need a local height divisible by 16.
HEIGHT_BLOCK = 16


def check_factors(world_size: int, spatial: int) -> None:
    """Raise ``ValueError`` where ``spatial`` does not divide the ranks, as
    the JAX ``make_mesh`` does for its devices."""
    if spatial > 1 and world_size % spatial:
        raise ValueError(f"{world_size} rank(s) do not factor into spatial={spatial}")


def height_blocks(height: int, spatial: int) -> list[tuple[int, int]]:
    """The (start, stop) rows of each spatial rank's stripe: whole blocks of
    HEIGHT_BLOCK rows, the first ``blocks % spatial`` ranks one block more."""
    blocks, rest = divmod(height, HEIGHT_BLOCK)
    if rest or blocks < spatial:
        raise ValueError(
            f"height {height} does not split over spatial={spatial}: it must be a "
            f"multiple of {HEIGHT_BLOCK} with at least {spatial} blocks of {HEIGHT_BLOCK} rows"
        )
    base, extra = divmod(blocks, spatial)
    bounds, start = [], 0
    for s in range(spatial):
        stop = start + HEIGHT_BLOCK * (base + (s < extra))
        bounds.append((start, stop))
        start = stop
    return bounds


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: every rank holds the whole model and its
    block (rows x height stripe) of each batch."""

    device: torch.device
    world_size: int = 1
    rank: int = 0
    group: Any = None  # the torch.distributed group when world_size > 1
    spatial: int = 1  # ranks per data row, each a height stripe
    spatial_group: SpatialGroup | None = None  # the row's ranks when spatial > 1

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def data_size(self) -> int:
        return self.world_size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def height_block(self, height: int) -> tuple[int, int]:
        """(start, stop) of this rank's stripe of images ``height`` rows high."""
        if self.spatial == 1:
            return 0, height
        return height_blocks(height, self.spatial)[self.spatial_index]

    def stripe_of(self, batch: dict[str, Any]) -> dict[str, Any]:
        """Each array of ``batch`` with three or more dims (images, targets,
        full-rank masks: height at dim 1) cut to this rank's stripe; rank-1
        row flags as they are."""
        if self.spatial == 1:
            return batch
        out = {}
        for key, value in batch.items():
            if np.ndim(value) >= 3:
                start, stop = self.height_block(value.shape[1])
                value = value[:, start:stop]
            out[key] = value
        return out

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place; a no-op on one rank."""
        if self.distributed:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def barrier(self) -> None:
        """Wait for every rank: an all-reduce of one element on the device,
        which NCCL and gloo (on the CPU and on CUDA) all run."""
        if self.distributed:
            self.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(device: torch.device, spatial: int = 1) -> Mesh:
    """The mesh of this process: the initialised ``torch.distributed`` group,
    or one rank when there is none; with ``spatial`` > 1 a (world / spatial,
    spatial) mesh. Every rank creates every data row's group, in the same
    order (``dist.new_group`` is a collective of the world)."""
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        check_factors(1, spatial)
        return Mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    check_factors(world, spatial)
    if spatial <= 1:
        return Mesh(device, world, rank, dist.group.WORLD)
    row = None
    for first in range(0, world, spatial):
        group = dist.new_group(list(range(first, first + spatial)))
        if first == rank - rank % spatial:
            row = group
    return Mesh(device, world, rank, dist.group.WORLD, spatial,
                SpatialGroup(row, rank % spatial, spatial))


def _pad_batch_rows(batch: dict[str, Any], pad: int) -> dict[str, Any]:
    """Append ``pad`` wrap-around rows with ``valid_mask`` forced False. A
    batch without a mask gets rank-1 per-row flags; an incoming mask of any
    rank is index-padded with the new rows False."""
    n = int(next(iter(batch.values())).shape[0])
    idx = np.concatenate([np.arange(n), np.arange(pad) % n])
    mask = batch.get("valid_mask")
    if mask is None:
        mask = np.ones(len(idx), bool)
    else:
        mask = np.asarray(mask)[idx].copy()
    mask[n:] = False
    out = {k: np.asarray(v)[idx] for k, v in batch.items() if k != "valid_mask"}
    out["valid_mask"] = mask
    return out


def pad_batch_for_mesh(batch: dict[str, Any], n_devices: int) -> dict[str, Any]:
    """Pad a {input, target[, valid_mask]} batch so the leading axis is a
    multiple of ``n_devices`` (wrap rows flagged False, ``_pad_batch_rows``),
    so that every rank's stripe has one size."""
    n = int(next(iter(batch.values())).shape[0])
    pad = (-n) % n_devices
    if pad == 0:
        return batch
    return _pad_batch_rows(batch, pad)


def pad_batch_to(batch: dict[str, Any], batch_size: int) -> dict[str, Any]:
    """Pad a batch's leading axis up to exactly ``batch_size`` and give every
    batch (padded or not) an explicit ``valid_mask``; a full batch gets
    all-True rank-1 row flags. An oversize batch raises."""
    n = int(next(iter(batch.values())).shape[0])
    if n > batch_size:
        raise ValueError(
            f"batch of {n} rows exceeds the static batch_size={batch_size}"
        )
    if n < batch_size:
        return _pad_batch_rows(batch, batch_size - n)
    if "valid_mask" not in batch:
        batch = dict(batch)
        batch["valid_mask"] = np.ones(n, bool)
    return batch


def shard_batch_to_mesh(batch: dict[str, Any], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's block of a global host batch, on its device: its data
    row's rows, cut to its height stripe on a spatial mesh. A batch with a
    leading axis the data rows do not divide is padded first
    (``pad_batch_for_mesh``)."""
    batch = pad_batch_for_mesh(batch, mesh.data_size)
    stripe = int(next(iter(batch.values())).shape[0]) // mesh.data_size
    rows = slice(mesh.data_index * stripe, (mesh.data_index + 1) * stripe)
    block = mesh.stripe_of({k: np.asarray(v)[rows] for k, v in batch.items()})
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
        for k, v in block.items()
    }


def replicate_to_mesh(state, mesh: Mesh):
    """Broadcast rank 0's weights, BatchNorm buffers and AdamW state (moments
    and step counts) to every rank, in place; the train state's generator
    stays each rank's own. Returns ``state``. A no-op on one rank.

    ``DistributedDataParallel``'s constructor broadcasts the weights and
    buffers when ``create_train_state`` wraps the model, but the trainer
    loads ``--init-checkpoint`` and ``--resume`` after that, and each rank
    reads the file on its own host; AdamW's moments are never broadcast by
    the wrapper. The trainer calls this after such a load, so every rank
    continues from rank 0's copy of the file."""
    if not mesh.distributed:
        return state
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    if state.optimizer is not None:
        for p_state in state.optimizer.state.values():
            tensors += [p_state["exp_avg"], p_state["exp_avg_sq"], p_state["step"]]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)
    return state
