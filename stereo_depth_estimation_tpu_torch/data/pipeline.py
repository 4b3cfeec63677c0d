"""Batch iteration and device prefetch.

Counterpart of ``stereo_depth_estimation_tpu/data/pipeline.py``. Host threads
assemble uint8 batches (memmap gather or per-sample loader), and a background
thread copies each batch to the device ahead of the step that needs it.
``epoch_indices`` draws the JAX package's numpy permutation, so both packages
visit the samples in the same order.

On CUDA, ``to_device`` stages each array in pinned host memory and copies it
on a side stream; the prefetch thread waits for that copy, so a batch it hands
over is complete, and each device tensor is recorded on the consuming stream
so that its memory is not reused while the step still reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch


def epoch_indices(
    n: int, batch_size: int, *, shuffle: bool, seed: int, epoch: int,
    drop_last: bool = False,
) -> list[np.ndarray]:
    """Deterministic per-epoch batch index lists."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    batches = []
    for start in range(0, n, batch_size):
        chunk = order[start : start + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        batches.append(chunk)
    return batches


def batch_iterator(
    fetch: Callable[[np.ndarray], dict[str, np.ndarray]],
    n: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = False,
) -> Iterator[dict[str, np.ndarray]]:
    for idx in epoch_indices(
        n, batch_size, shuffle=shuffle, seed=seed, epoch=epoch, drop_last=drop_last
    ):
        yield fetch(idx)


def loader_fetch(
    loader, num_workers: int = 0
) -> Callable[[np.ndarray], dict[str, np.ndarray]]:
    """Batch assembly from a per-sample StereoSampleLoader; ``num_workers >
    0`` decodes samples on a thread pool (PIL and numpy release the GIL)."""

    def stack(items: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        return {
            "input": np.stack([it["input"] for it in items]),
            "target": np.stack([it["target"] for it in items]),
        }

    if num_workers <= 0:
        return lambda indices: stack([loader[int(i)] for i in indices])

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=num_workers)
    return lambda indices: stack(list(pool.map(lambda i: loader[int(i)], indices)))


def to_device(
    batch: dict[str, np.ndarray],
    device: torch.device,
    copy_stream: "torch.cuda.Stream | None" = None,
    consumer_stream: "torch.cuda.Stream | None" = None,
) -> dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``. For CUDA: pinned host buffers,
    non-blocking copies on ``copy_stream``, waited for before returning; each
    result is recorded on ``consumer_stream`` (the caching allocator then
    keeps its memory until that stream's work on it is done)."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}
    copy_stream = copy_stream or torch.cuda.current_stream(device)
    out = {}
    with torch.cuda.stream(copy_stream):
        for key, value in host.items():
            dev = value.pin_memory().to(device, non_blocking=True)
            if consumer_stream is not None:
                dev.record_stream(consumer_stream)
            out[key] = dev
    copy_stream.synchronize()
    return out


def prefetch_to_device(
    iterator: Iterator[Any],
    *,
    put: Callable[[Any], Any],
    depth: int = 2,
) -> Iterator[Any]:
    """Run ``put`` (the host-to-device copy) on a background thread, ``depth``
    batches ahead, so the copy overlaps the device's work. An exception in
    the thread is raised to the consumer; a consumer that stops early stops
    the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    error: list[BaseException] = []
    stop = threading.Event()

    def offer(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterator:
                if not offer(put(item)):
                    return
        except BaseException as exc:  # raised again in the consumer
            error.append(exc)
        finally:
            offer(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


def cuda_put(
    device: torch.device, transform: Callable[[Any], dict[str, np.ndarray]] = lambda b: b
) -> Callable[[Any], dict[str, torch.Tensor]]:
    """A ``put`` for :func:`prefetch_to_device`: ``transform`` the host batch,
    then :func:`to_device` it. On CUDA the copy runs on a side stream and its
    tensors are recorded on the stream current at this call (the step's)."""
    if device.type != "cuda":
        return lambda batch: to_device(transform(batch), device)
    consumer = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    return lambda batch: to_device(transform(batch), device, side, consumer)
