"""The train step's zero-valid gate through two hand-written CUDA kernels
(``csrc/gate.cu``).

A batch with no valid pixel must leave the train state as it was, and the
step decides that on the device, without reading the valid count on the
host: it snapshots what the step changes before the forward, and restores it
after AdamW when the count is not > 0 (NaN included), the JAX package's
``jax.tree.map(keep_if_valid, ...)``.

- ``build_table``: from the gated tensors (dense and non-overlapping, one
  device, any dtype), a ``GateTable`` of byte ranges: tensors that share
  memory (views of one buffer, or one tensor listed twice) are taken once,
  overlapping and touching ranges of one storage merged. Each range has a slot in one flat snapshot
  buffer, 16-byte aligned and shifted by the range's address mod 16; on CUDA
  the table of ranges and chunks is copied to the card once, from pinned
  memory, without a synchronise.
- ``gate_snapshot_plain`` / ``gate_restore_plain``: the plain PyTorch
  versions, a ``copy_`` per range into its slot, and a ``torch.where`` and
  ``copy_`` per range back from it.
- ``gate_snapshot_cuda`` / ``gate_restore_cuda``: the kernels, one launch
  each for the whole table; they take CUDA tables only, raise on anything
  else, and count their launches in ``.launches``.
- ``gate_snapshot`` / ``gate_restore``: the plain version for a table on the
  CPU, the kernel for one on CUDA (no fallback from the kernel).
- ``ZeroValidGate``: what a ``TrainState`` keeps: the table and its buffer,
  rebuilt only when the gated tensors' memory changes (a host check of
  their addresses and sizes, no launch), and ``restores``, an int64 counter
  on the device that every restoring call raises by one.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .._build import load_library

CHUNK = 1 << 15  # slot bytes a block copies at a time, a multiple of 16
BLOCKS_PER_SM = 4

def gate_key(tensors: list[torch.Tensor]) -> list[int]:
    """The gated tensors' addresses, then their sizes in bytes: a table
    stays right while these stay the same."""
    key = [t.data_ptr() for t in tensors]
    key += [t.nbytes for t in tensors]
    return key


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``numel`` elements of memory, each once
    (contiguous in some order of its dimensions, channels_last included)."""
    expected = 1
    for stride, size in sorted((st, s) for s, st in zip(t.shape, t.stride()) if s != 1):
        if stride != expected:
            return False
        expected *= size
    return True


@dataclass
class GateTable:
    key: list[int]
    device: torch.device
    live: list[torch.Tensor]  # a uint8 view of each range's memory
    saved: list[torch.Tensor]  # its bytes' place in ``buffer``
    buffer: torch.Tensor  # uint8, the slots
    ranges: int
    chunks: int
    # The kernel's table, int64: the live address, bytes, slot offset and
    # first chunk of each range, then the range of each chunk. On CUDA it is
    # pinned and stays referenced while its copy to the card may run.
    host_table: torch.Tensor
    device_table: torch.Tensor | None = None
    grid: int = 0  # the launch's blocks


def _ranges(tensors: list[torch.Tensor]) -> list[tuple[torch.UntypedStorage, int, int]]:
    """(storage, first byte, end byte) of the merged ranges the tensors
    cover, in no particular order."""
    spans: dict[int, tuple[torch.UntypedStorage, list[tuple[int, int]]]] = {}
    for t in tensors:
        if t.numel() == 0:
            continue
        if not _dense(t):
            raise ValueError(f"the gate copies dense, non-overlapping tensors only, got "
                             f"{tuple(t.shape)} strides {t.stride()} {t.dtype}")
        storage = t.untyped_storage()
        start = t.data_ptr() - storage.data_ptr()
        spans.setdefault(storage.data_ptr(), (storage, []))[1].append(
            (start, start + t.nbytes))
    merged = []
    for storage, intervals in spans.values():
        intervals.sort()
        lo, hi = intervals[0]
        for a, b in intervals[1:]:
            if a > hi:
                merged.append((storage, lo, hi))
                lo, hi = a, b
            else:
                hi = max(hi, b)
        merged.append((storage, lo, hi))
    return merged


def build_table(tensors: list[torch.Tensor]) -> GateTable:
    """The ``GateTable`` of ``tensors``, all on one device. Raises on a
    tensor that is not dense and non-overlapping, on mixed devices, and on
    an empty list or one of empty tensors."""
    if not tensors:
        raise ValueError("the gate needs at least one tensor")
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"the gated tensors lie on {device} and {t.device}: one device")
    key = gate_key(tensors)
    ranges = _ranges(tensors)
    if not ranges:
        raise ValueError("the gated tensors hold no bytes")
    slots, total = [], 0
    for storage, lo, hi in ranges:
        mis = (storage.data_ptr() + lo) % 16
        slots.append((total, mis))
        total += -(-(mis + hi - lo) // 16) * 16
    buffer = torch.empty(total, dtype=torch.uint8, device=device)
    live, saved, rows, owners, first = [], [], [], [], 0
    for r, ((storage, lo, hi), (offset, mis)) in enumerate(zip(ranges, slots)):
        view = torch.empty(0, dtype=torch.uint8, device=device).set_(
            storage, lo, (hi - lo,), (1,))
        live.append(view)
        saved.append(buffer[offset + mis:offset + mis + hi - lo])
        rows.append((view.data_ptr(), hi - lo, offset, first))
        chunks = -(-(mis + hi - lo) // CHUNK)
        owners += [r] * chunks
        first += chunks
    columns = [v for column in zip(*rows) for v in column] + owners
    table = GateTable(key, device, live, saved, buffer, len(ranges), first,
                      torch.tensor(columns, dtype=torch.int64))
    if device.type == "cuda":
        table.host_table = table.host_table.pin_memory()
        table.device_table = table.host_table.to(device, non_blocking=True)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        table.grid = min(first, BLOCKS_PER_SM * sms)
    return table


def gate_snapshot_plain(table: GateTable) -> None:
    """Every range into its slot."""
    for live, saved in zip(table.live, table.saved):
        saved.copy_(live)


def gate_restore_plain(table: GateTable, valid_count: torch.Tensor,
                       restores: torch.Tensor) -> None:
    """Every range back from its slot where ``valid_count > 0`` is false,
    and ``restores`` raised by one there."""
    keep = valid_count > 0
    for live, saved in zip(table.live, table.saved):
        live.copy_(torch.where(keep, live, saved))
    restores.add_(torch.logical_not(keep).to(restores.dtype))


class _GateLibrary:
    """ctypes handles of ``csrc/gate.cu``, bound at first launch."""

    def __init__(self) -> None:
        self._lib = None

    def get(self):
        if self._lib is None:
            lib = load_library("gate")
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.gate_snapshot.argtypes = [p, i64, i64, i64, p, i32, p]
            lib.gate_restore.argtypes = [p, i64, i64, i64, p, p, p, i32, p]
            lib.gate_snapshot.restype = lib.gate_restore.restype = ctypes.c_int
            lib.gate_error_string.argtypes = [ctypes.c_int]
            lib.gate_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


_library = _GateLibrary()


def _check_table(table: GateTable) -> None:
    if table.device.type != "cuda" or table.device_table is None:
        raise ValueError(f"the CUDA gate kernels take a table of CUDA tensors, got one on "
                         f"{table.device}")


def _check_scalar(t: torch.Tensor, what: str, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or t.numel() != 1:
        raise ValueError(f"{what} must be one {dtype} on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _launch(name: str, table: GateTable, *pointers: int) -> None:
    lib = _library.get()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(table.device_table.data_ptr(), table.ranges, table.chunks,
                                  CHUNK, table.buffer.data_ptr(), *pointers, table.grid,
                                  stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: {lib.gate_error_string(code).decode()}")


class GateSnapshotKernel:
    """Launches ``gate_snapshot`` on the current stream. ``launches`` counts
    the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, table: GateTable) -> None:
        _check_table(table)
        _launch("gate_snapshot", table)
        self.launches += 1


class GateRestoreKernel:
    """Launches ``gate_restore`` on the current stream. ``launches`` counts
    the launches, and nothing else."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, table: GateTable, valid_count: torch.Tensor,
                 restores: torch.Tensor) -> None:
        _check_table(table)
        _check_scalar(valid_count, "valid_count", torch.float32, table.device)
        _check_scalar(restores, "restores", torch.int64, table.device)
        _launch("gate_restore", table, valid_count.data_ptr(), restores.data_ptr())
        self.launches += 1


gate_snapshot_cuda = GateSnapshotKernel()
gate_restore_cuda = GateRestoreKernel()


def gate_snapshot(table: GateTable) -> None:
    """Every range into its slot: the plain version on the CPU, the kernel
    on CUDA."""
    if table.device.type == "cpu":
        gate_snapshot_plain(table)
    else:
        gate_snapshot_cuda(table)


def gate_restore(table: GateTable, valid_count: torch.Tensor, restores: torch.Tensor) -> None:
    """Every range back from its slot unless ``valid_count > 0``: the plain
    version on the CPU, the kernel on CUDA."""
    if table.device.type == "cpu":
        gate_restore_plain(table, valid_count, restores)
    else:
        gate_restore_cuda(table, valid_count, restores)


class ZeroValidGate:
    """The gate a ``TrainState`` keeps across steps: ``snapshot(tensors)``
    before the step changes them, ``restore(valid_count)`` after. The table
    is rebuilt (``builds`` counts it) only when the tensors' addresses or
    sizes differ from the last snapshot's, as after
    ``optimizer.load_state_dict``."""

    def __init__(self) -> None:
        self.table: GateTable | None = None
        self.restores: torch.Tensor | None = None  # int64 on the tensors' device
        self.builds = 0

    def snapshot(self, tensors: list[torch.Tensor]) -> None:
        if self.table is None or gate_key(tensors) != self.table.key:
            self.table = None  # the old buffer goes before the new one comes
            self.table = build_table(tensors)
            self.builds += 1
            if self.restores is None or self.restores.device != self.table.device:
                self.restores = torch.zeros((), dtype=torch.int64, device=self.table.device)
        gate_snapshot(self.table)

    def restore(self, valid_count: torch.Tensor) -> None:
        if self.table is None:
            raise RuntimeError("the gate restores only after a snapshot")
        gate_restore(self.table, valid_count, self.restores)
