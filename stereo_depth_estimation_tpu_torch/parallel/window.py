"""Device-resident training data: pinned or rotating windows, per rank.

Counterpart of ``stereo_depth_estimation_tpu/parallel/window.py``. The packed
training set is staged into device memory as windows of whole batches:

- **Pinned** (the set fits the byte budget): one window, staged once and
  reused every epoch; no host traffic after the first epoch's start.
- **Rotating** (the set is larger): each epoch draws a global numpy
  permutation (the JAX package's, ``np.random.default_rng((seed, 17,
  epoch))``), cuts it into equal windows (the last wrap-fills from the
  head), and a background thread gathers window k+1 from the memmap cache
  and copies it to the device (pinned host memory, a side stream) while the
  device trains on window k. At most two windows are resident, which is what
  the plan budgets.

Within a window, batches are gathered on the device by
``DeviceDataTrainStep`` (``parallel/train_step.py``): a fresh
``torch.randperm`` per pass from the train state's generator. That
permutation differs from the JAX package's ``jax.random`` one; the window
membership is the same.

On a mesh of several ranks, the set is padded with wrapped rows to a
multiple of the data rows and every window divides over them: the ranks of
data row d stage rows ``[d * local_n, (d + 1) * local_n)`` of each window,
the rows JAX data shard d holds, each rank its height stripe of them on a
spatial mesh (JAX's ``P(data, spatial)`` window sharding), and permute them
locally into batches of ``batch_size / data rows`` rows. The permutation
comes from the train state's generator, which the ranks of a data row share
(``train_step.rank_seed``), so they gather the same rows. The byte budget is
per device, so the whole plan's budget scales with the world size, as the
JAX package's scales with the mesh's devices.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..data.pipeline import to_device
from .distributed import stage_rows_multihost
from .mesh import Mesh
from .train_step import Batch, DeviceDataTrainStep, TrainState


@dataclass(frozen=True)
class WindowPlan:
    n: int                # dataset samples, padded to the data rows
    batch_size: int       # global batch
    window_samples: int   # samples staged per window (a multiple of batch_size)
    num_windows: int
    pinned: bool          # one window holding the whole set, staged once
    steps_per_window: int

    @property
    def steps_per_epoch(self) -> int:
        return self.steps_per_window * self.num_windows


def plan_windows(
    n: int,
    batch_size: int,
    bytes_per_sample: int,
    budget_bytes: int,
    data_degree: int = 1,
) -> WindowPlan:
    """Window geometry from the dataset size and a byte budget over all
    ranks: pinned when one resident copy fits, otherwise the budget is split
    in two (the current window and the one being staged behind it). The
    batch must divide over the ``data_degree`` ranks."""
    if batch_size % data_degree != 0:
        raise ValueError(
            f"batch_size={batch_size} must divide over the data axis "
            f"({data_degree} shards) for windowed training."
        )
    if n < batch_size:
        raise ValueError(
            f"dataset of {n} samples is smaller than batch_size={batch_size}"
        )
    if n * bytes_per_sample <= budget_bytes:
        return WindowPlan(
            n=n, batch_size=batch_size, window_samples=n, num_windows=1,
            pinned=True, steps_per_window=n // batch_size,
        )
    per_window_budget = budget_bytes // 2
    window_samples = (per_window_budget // bytes_per_sample) // batch_size
    window_samples *= batch_size
    if window_samples < batch_size:
        raise ValueError(
            f"HBM window budget {budget_bytes / 1e9:.2f} GB cannot hold even "
            f"one double-buffered batch of {batch_size} x "
            f"{bytes_per_sample / 1e6:.1f} MB samples."
        )
    num_windows = -(-n // window_samples)  # ceil
    return WindowPlan(
        n=n, batch_size=batch_size, window_samples=window_samples,
        num_windows=num_windows, pinned=False,
        steps_per_window=window_samples // batch_size,
    )


class HBMWindowLoader:
    """Stages packed-cache windows into device memory and serves them one
    train step at a time; see the module docstring for the two modes.

    ``fetch(indices) -> {"input": (k,H,W,6) u8, "target": (k,H,W) f16}`` is
    the packed cache's batched gather (``data/packed_cache.py``)."""

    def __init__(
        self,
        fetch: Callable[[np.ndarray], dict[str, np.ndarray]],
        n: int,
        batch_size: int,
        device: torch.device,
        bytes_per_sample: int,
        budget_bytes: int,
        seed: int = 0,
        mesh: Mesh | None = None,
    ) -> None:
        self._fetch = fetch
        self._device = device
        self._seed = seed
        self._n = n
        self._mesh = mesh if mesh is not None else Mesh(device)
        rows = self._mesh.data_size
        # Pad the sample count to the data rows with wrapped rows, so that
        # windows divide over them; the <= rows-1 repeated rows shift
        # in-window sampling odds marginally.
        padded_n = n + (-n) % rows
        self.plan = plan_windows(padded_n, batch_size, bytes_per_sample, budget_bytes, rows)
        self.local_batch = batch_size // rows
        self._pinned_window: tuple[torch.Tensor, torch.Tensor] | None = None
        if self.plan.pinned:
            self._pinned_window = self._stage(np.arange(padded_n) % n)

    def _stage(
        self, indices: np.ndarray, copy_stream=None, consumer_stream=None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's block of the window ``indices``, on the device."""
        host = stage_rows_multihost(self._fetch, indices, self._mesh)
        staged = to_device(host, self._device, copy_stream, consumer_stream)
        return staged["input"], staged["target"]

    def _epoch_window_indices(self, epoch: int) -> list[np.ndarray]:
        """Global per-epoch permutation cut into equal windows; the last
        wrap-fills from the head (every sample is in exactly one window)."""
        rng = np.random.default_rng((self._seed, 17, epoch))
        perm = rng.permutation(self.plan.n) % max(self._n, 1)
        windows = []
        ws = self.plan.window_samples
        for w in range(self.plan.num_windows):
            chunk = perm[w * ws : (w + 1) * ws]
            if len(chunk) < ws:
                chunk = np.concatenate([chunk, perm[: ws - len(chunk)]])
            windows.append(chunk)
        return windows

    def epoch_windows(self, epoch: int) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's staged windows, (images, targets) on the device."""
        if self.plan.pinned:
            assert self._pinned_window is not None
            yield self._pinned_window
            return
        yield from self._rotate(self._epoch_window_indices(epoch))

    def _rotate(
        self, window_indices: list[np.ndarray]
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        # Double-buffered rotation. The producer takes a slot BEFORE it
        # stages a window, and the consumer returns the slot only after it
        # drops the window's references, so at most two windows are
        # resident (a bounded queue alone would let a third sit in device
        # memory while its put blocks). Every wait checks `stop`, so a
        # consumer that leaves early tears the producer down promptly.
        cuda = self._device.type == "cuda"
        copy_stream = torch.cuda.Stream(self._device) if cuda else None
        consumer = torch.cuda.current_stream(self._device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()
        slots = threading.BoundedSemaphore(2)

        def acquire_slot() -> bool:
            while not stop.is_set():
                if slots.acquire(timeout=0.1):
                    return True
            return False

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for indices in window_indices:
                    if not acquire_slot():
                        return
                    if not offer(self._stage(indices, copy_stream, consumer)):
                        return
                offer(None)
            except BaseException as exc:  # raised again in the consumer
                offer(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
                del item  # release the window before handing its slot back
                slots.release()
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=60)

    def epoch_steps(
        self, epoch: int, step_fn: Callable[[TrainState, Batch], Any]
    ) -> Iterator[DeviceDataTrainStep]:
        """One item per train step of the epoch: the window's
        ``DeviceDataTrainStep`` over ``step_fn``, to be called with the
        train state (``runner(state) -> step_fn(state, gathered batch)``).
        Each rank gathers ``batch_size / data rows`` rows a step from its
        block of the window."""
        for images, targets in self.epoch_windows(epoch):
            runner = DeviceDataTrainStep(images, targets, self.local_batch, step_fn)
            for _ in range(self.plan.steps_per_window):
                yield runner
            del runner, images, targets


def default_hbm_budget_bytes(per_device_gb: float = 4.0, world_size: int = 1) -> int:
    """The device-resident byte budget of the plan: the per-device allowance
    times the number of ranks (each holds its share of every window)."""
    return int(per_device_gb * (1 << 30)) * world_size
