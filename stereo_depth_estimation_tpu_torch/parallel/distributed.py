"""Data-parallel training over several ranks and hosts.

Counterpart of ``stereo_depth_estimation_tpu/parallel/distributed.py``. The
JAX package runs one process per host over all that host's devices; the port
runs one process per device, each a rank of one ``torch.distributed`` group:

- ``initialize_multihost`` joins the group: NCCL for CUDA, gloo for the CPU,
  decided by the device and never a fallback (a failing NCCL raises). The
  rendezvous is ``tcp://<coordinator-address>`` (an address given with a
  scheme, such as ``file://``, is used as it is); with no address it reads
  ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` from the
  environment, as JAX auto-detects its cluster.
- ``run_ranks`` starts this process's ranks: ``--mesh-devices N`` starts N
  local ranks (``spawn``, never ``fork``: CUDA must not be initialised
  before the children start); ``--multihost`` makes each host process start
  its local ranks, global rank ``process_id * local + local_rank``.
- ``MultihostBatcher`` gives each rank only its block of every global batch
  (its data row's rows, padded with flagged wrap rows, cut to its height
  stripe on a spatial mesh), so no rank decodes the whole batch, and
  ``stage_rows_multihost`` gives a rank its block of a device-resident
  window. The ranks of one data row decode the same samples, each in its
  own process; the JAX package's host process decodes them once for its
  devices.
- ``run_process_farm`` and ``next_farm_port`` are copies of the JAX
  package's (numpy and subprocess only), for tests and ``chip_smoke.py``.

The step's device tensors go through ``all_reduce`` and ``broadcast`` only:
the collectives gloo runs on CUDA tensors, so one code path serves NCCL,
gloo on CUDA (two ranks on one card) and gloo on the CPU.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, check_factors, make_mesh

_TIMEOUT = timedelta(minutes=30)


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> bool:
    """Join the process group as rank ``process_id`` of ``num_processes``.

    With no arguments, the ``torch.distributed`` environment variables
    describe the group. ``backend`` defaults to ``default_backend(device)``.
    Does nothing if a process group already exists, as the JAX function
    returns when it is already initialised. Returns True when this call
    created the group."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and any(v is None for v in explicit):
        raise ValueError(
            "--coordinator-address, --num-processes and --process-id go together; "
            "give all three, or none to read MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
            "and RANK from the environment"
        )
    if coordinator_address is None:
        init_method, world, rank = "env://", None, None
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    dist.init_process_group(
        backend or default_backend(device), init_method=init_method,
        world_size=-1 if world is None else world, rank=-1 if rank is None else rank,
        timeout=_TIMEOUT,
    )
    return True


def is_main_process() -> bool:
    """True on global rank 0, and without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_rank() -> int:
    """This rank's index among the ranks of its host (``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def run_ranks(
    fn: Callable[..., Any],
    args: tuple,
    *,
    device: torch.device,
    local_ranks: int,
    multihost: bool = False,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    spatial: int = 1,
) -> Any:
    """Run ``fn(mesh, *args)`` on each rank of this process and return the
    result of its first rank; ``mesh`` is ``make_mesh(device, spatial)``
    over all the ranks.

    - ``multihost`` with no address flags: the environment describes the
      group, and this process is one rank of it (a launcher such as
      ``torchrun`` starts one process a rank), on ``cuda:LOCAL_RANK``;
      ``local_ranks`` must be 1.
    - ``multihost`` with the address flags: world ``num_processes *
      local_ranks``, this process's ranks from ``process_id * local_ranks``;
      with one local rank ``fn`` runs here in the group, else the local
      ranks are spawned.
    - Otherwise ``local_ranks`` ranks on this host: one runs here with no
      collective; more are spawned, meeting through a file in a fresh
      temporary directory.

    The backend is the device's (``default_backend``). ``fn`` and ``args``
    must pickle when ranks are spawned; the result of a spawned rank
    crosses back through ``torch.save``. A rank count that ``spatial`` does
    not divide raises ``ValueError`` before any rank starts, where this
    process knows the count."""
    device = torch.device(device)
    address, world, first = coordinator_address, local_ranks, 0
    if multihost and (address, num_processes, process_id) == (None, None, None):
        if local_ranks != 1:
            raise ValueError(
                "--multihost without address flags runs one rank a process (WORLD_SIZE "
                "counts them): start one process per GPU and leave --mesh-devices at 0 or 1"
            )
        if device.type == "cuda":
            device = torch.device("cuda", local_rank())
        return _run_here(fn, args, device, None, None, None, spatial)
    if multihost:
        if address is None or num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator-address, --num-processes and --process-id go together; "
                "give all three, or none to read the environment"
            )
        world, first = num_processes * local_ranks, process_id * local_ranks
    check_factors(world, spatial)
    if not multihost and local_ranks == 1:
        return fn(Mesh(device), *args)
    if multihost and local_ranks == 1:
        return _run_here(fn, args, device, address, world, first, spatial)
    workdir = Path(tempfile.mkdtemp(prefix="ranks-"))
    try:
        result_path = workdir / "result.pt"
        torch.multiprocessing.start_processes(
            _spawned_rank, nprocs=local_ranks, join=True, start_method="spawn",
            args=(fn, args, device.type, address or f"file://{workdir / 'rendezvous'}",
                  world, first, spatial, result_path,
                  max(1, (os.cpu_count() or 1) // local_ranks)),
        )
        return torch.load(result_path, weights_only=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run_here(fn, args, device, address, world, rank, spatial) -> Any:
    """``fn`` in this process as one rank; a group this call creates is
    destroyed after it."""
    created = initialize_multihost(address, world, rank, device=device)
    try:
        return fn(make_mesh(device, spatial), *args)
    finally:
        if created:
            dist.destroy_process_group()


def _spawned_rank(local, fn, args, device_type, address, world, first, spatial,
                  result_path, cpu_threads) -> None:
    """A spawned rank (``local`` of this process's): ``fn`` on
    ``cuda:local`` or the CPU (``cpu_threads`` threads: the host's cores
    are shared between its ranks); the first saves its result for the
    parent."""
    os.environ["LOCAL_RANK"] = str(local)
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cpu":
        torch.set_num_threads(cpu_threads)
    result = _run_here(fn, args, device, address, world, first + local, spatial)
    if local == 0:
        torch.save(result, result_path)


class MultihostBatcher:
    """Per-rank feeding of a global batch: callable like a fetch function,
    it takes the GLOBAL index list of a batch and returns this rank's block
    as a host batch.

    1. pad the index list (wrapping) to ``pad_to`` and to a multiple of the
       data rows; padded rows get ``valid_mask`` False and so contribute
       nothing to the masked loss and metrics;
    2. fetch only this rank's data row's rows, each distinct sample once
       (wrapped rows repeat samples), and cut them to its height stripe;
    3. add the rows' rank-1 ``valid_mask`` flags (the JAX batcher builds a
       full-rank mask on a spatial mesh only because a global array with
       the spatial axis cannot carry rank-1 flags; the port has no such
       array).
    """

    def __init__(
        self,
        fetch: Callable[[np.ndarray], dict[str, np.ndarray]],
        mesh: Mesh,
        pad_to: int | None = None,
    ) -> None:
        self.fetch = fetch
        self.mesh = mesh
        self.pad_to = pad_to

    def __call__(self, global_indices: np.ndarray) -> dict[str, np.ndarray]:
        global_indices = np.asarray(global_indices)
        n = len(global_indices)
        target_n = max(n, self.pad_to or 0)
        target_n += (-target_n) % self.mesh.data_size
        # Modular tiling, not a slice: the pad can exceed n.
        padded = global_indices[np.arange(target_n) % n]
        is_real = np.ones(len(padded), bool)
        is_real[n:] = False
        stripe = len(padded) // self.mesh.data_size
        lo = self.mesh.data_index * stripe
        unique, inverse = np.unique(padded[lo : lo + stripe], return_inverse=True)
        fetched = self.mesh.stripe_of(self.fetch(unique))
        local = {k: np.asarray(v)[inverse] for k, v in fetched.items()}
        local["valid_mask"] = is_real[lo : lo + stripe]
        return local


def stage_rows_multihost(
    fetch: Callable[[np.ndarray], dict[str, np.ndarray]],
    indices: np.ndarray,
    mesh: Mesh,
) -> dict[str, np.ndarray]:
    """This rank's block of a window of GLOBAL store rows: data row d fetches
    rows ``[d * local_n, (d + 1) * local_n)`` of ``indices``, the rows JAX
    data shard d holds, and each rank keeps its height stripe of them.
    ``indices`` must be the same on every rank (callers derive it from the
    shared seed) and divide over the data rows."""
    indices = np.asarray(indices)
    if len(indices) % mesh.data_size:
        raise ValueError(
            f"window of {len(indices)} rows does not divide over {mesh.data_size} data rows"
        )
    local_n = len(indices) // mesh.data_size
    d = mesh.data_index
    return mesh.stripe_of(fetch(indices[d * local_n : (d + 1) * local_n]))


# --------------------------------------------------------------------------
# Host-side farm harness: spawn N coordinated children, collect a prefixed
# result line from each. Children are always reaped, so a wedged rendezvous
# cannot leak processes that hold the coordinator port across retries.
# --------------------------------------------------------------------------

_farm_launches = 0


def next_farm_port(base: int) -> int:
    """A coordinator port distinct per (process, launch): retries after a
    wedged farm must not collide with a leaked listener on the old port."""
    global _farm_launches

    _farm_launches += 1
    return base + (os.getpid() * 7 + _farm_launches * 131) % 2000


def run_process_farm(
    child_source: str,
    argv_for: Callable[[int], list[str]],
    *,
    num_processes: int = 2,
    timeout: float = 600.0,
    result_prefix: str = "RESULT ",
    cwd: str | None = None,
    env: dict | None = None,
) -> list[tuple[str, str]]:
    """Run ``python -c child_source argv_for(i)...`` for each process id and
    return ``[(result_line_without_prefix, full_output), ...]`` in id order.

    Raises RuntimeError (with the child's output tail) on nonzero exit,
    timeout, or a missing result line; every child is killed and reaped on
    ANY exit path."""
    import subprocess
    import sys

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", child_source, *argv_for(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=cwd, env=env,
        )
        for i in range(num_processes)
    ]
    outputs: list[str] = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            outputs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"farm child rc={proc.returncode}: {out[-2000:]}"
                )
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for out in outputs:
        lines = [ln for ln in out.splitlines() if ln.startswith(result_prefix)]
        if not lines:
            raise RuntimeError(
                f"farm child produced no '{result_prefix.strip()}' line: "
                f"{out[-2000:]}"
            )
        results.append((lines[0][len(result_prefix):], out))
    return results
