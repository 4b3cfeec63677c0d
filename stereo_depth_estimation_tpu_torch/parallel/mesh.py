"""The rank group, and static-shape batch padding with rank-1 row flags.

Counterpart of ``stereo_depth_estimation_tpu/parallel/mesh.py``. The JAX
package runs one process per host over a mesh of that host's devices; the
port runs one process per device, a rank of a ``torch.distributed`` group.
``Mesh`` describes that group as one rank sees it (world size, rank, device,
group), and ``make_mesh`` is the counterpart of the JAX ``make_mesh``.

- ``pad_batch_to``: the epoch's tail batch is padded up to the static batch
  size with wrap-around rows whose ``valid_mask`` flag is False: BatchNorm
  sees plausible images, and the loss and every metric sum ignore those rows
  (``train_step._targets_and_mask`` ANDs the flags with ``target > 0``).
  Every batch carries the flags, so every batch has one structure.
- ``pad_batch_for_mesh`` pads the same way to a multiple of the world size,
  ``shard_batch_to_mesh`` then puts this rank's stripe on its device, and
  ``replicate_to_mesh`` broadcasts rank 0's weights, buffers and AdamW state
  after a checkpoint load.

``batch_sharding`` and ``replicated_sharding`` have no counterpart: a rank
holds its stripe of a batch as a plain tensor and its own full copy of the
weights, so there is no sharding to name. Height sharding (the JAX
``spatial`` axis) is not ported (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group: every rank holds the
    whole model and its stripe of each batch."""

    device: torch.device
    world_size: int = 1
    rank: int = 0
    group: Any = None  # the torch.distributed group when world_size > 1

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

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


def make_mesh(device: torch.device) -> Mesh:
    """The mesh of this process: the initialised ``torch.distributed`` group,
    or one rank when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(torch.device(device))
    return Mesh(torch.device(device), dist.get_world_size(), dist.get_rank(),
                dist.group.WORLD)


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
    """This rank's stripe of a global host batch, on its device. A batch
    with an indivisible leading axis is padded first (``pad_batch_for_mesh``)."""
    batch = pad_batch_for_mesh(batch, mesh.world_size)
    stripe = int(next(iter(batch.values())).shape[0]) // mesh.world_size
    rows = slice(mesh.rank * stripe, (mesh.rank + 1) * stripe)
    return {
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[rows])).to(mesh.device)
        for k, v in batch.items()
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
