"""Compile cache across processes: skip Inductor's recompiles in a new process.

Counterpart of ``stereo_depth_estimation_tpu/parallel/aot_cache.py``. There
the first process serialises XLA's compiled executable; here it saves
PyTorch's portable compile artifacts (``torch.compiler.save_cache_artifacts``:
Inductor's FX-graph cache entries with their generated kernels, and
AOTAutograd's) to ``aot_<digest>.bin`` once its compiled steps have each run
once (``finish``), and a
later process loads them (``torch.compiler.load_cache_artifacts``) before
its first compile, so Inductor's caches hit and no kernel is built again.

- The digest covers what decides the compiled program beyond the traced
  code: the torch and CUDA versions, the device name and count, the compile
  mode and backend, the model and input configuration the caller passes
  (base channels, compute dtype, rank count, shapes), and the rank and world
  size of a run of several processes, so each rank loads its own blob and a
  blob of another setting is never loaded.
- The source of each compiled step is read from Inductor's own counters
  (``fxgraph_cache_hit`` / ``fxgraph_cache_miss``), not guessed:
  ``"aot-cache"`` (a blob was loaded and every graph hit), ``"compiled"``
  (compiled and saved) or ``"compiled-unsaved"`` (nothing to save, or the
  write failed).
- A failure of ``torch.compile`` itself is not caught here: it raises.
- A save holds what the process compiled or loaded since its previous save
  (``torch.compiler.save_cache_artifacts``): in one process that runs
  several caches, a graph saved in one blob and found again in Inductor's
  in-process caches by a later one may be missing from the later blob. Each
  CLI run in its own process saves everything it compiled.

SECURITY: the artifacts hold pickles and generated code that the loading
process runs, so loading a blob another user could have written is
arbitrary code execution. The cache directory is created ``0o700``, and a
blob or directory not owned by this uid or writable by group or other is
not loaded: the process compiles without it and says so on stderr. A
corrupt blob is deleted and the process compiles.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import torch


def _say(msg: str) -> None:
    """Diagnostics go to stderr: the CLIs keep stdout for their results."""
    print(msg, file=sys.stderr, flush=True)


def resolve_aot_dir(arg: str, auto_base: str | Path) -> Path | None:
    """Resolve a CLI ``--aot-cache`` value: ``"off"`` -> None (disabled),
    ``"auto"`` -> ``<auto_base>/.aot_cache``, anything else -> that path."""
    if arg == "off":
        return None
    if arg == "auto":
        return Path(auto_base).expanduser().resolve() / ".aot_cache"
    return Path(arg).expanduser().resolve()


def _safe_to_load(path: Path) -> bool:
    """True when ``path`` and its directory are owned by the current uid
    and not group/other-writable (module docstring, SECURITY). Non-POSIX
    platforms (no getuid) pass."""
    getuid = getattr(os, "getuid", None)
    if getuid is None:
        return True
    try:
        stats = (path.parent.stat(), path.stat())
    except OSError:
        return False
    uid = getuid()
    return all(s.st_uid == uid and not (s.st_mode & 0o022) for s in stats)


def cache_digest(setting: dict[str, Any], device: torch.device) -> str:
    """The blob's key: ``setting`` (compile mode and backend, model and
    input configuration, rank and world size) with the torch and CUDA
    versions and the device's name and count."""
    if device.type == "cuda":
        devices = (torch.cuda.get_device_name(device), torch.cuda.device_count())
    else:
        devices = ("cpu", 1)
    key = "\x00".join([
        torch.__version__, str(torch.version.cuda), *map(str, devices),
        *(f"{k}={setting[k]!r}" for k in sorted(setting)),
    ])
    return hashlib.blake2s(key.encode()).hexdigest()


def compile_cache_for(
    aot_cache: str, auto_base: str | Path, setting: dict[str, Any], device: torch.device,
    verbose: bool = True,
) -> CompileCache | None:
    """A CLI's compile cache for ``--aot-cache`` (``resolve_aot_dir``), keyed
    by ``setting`` on ``device``, or None with ``off``; with ``verbose`` its
    notes go to stderr."""
    aot_dir = resolve_aot_dir(aot_cache, auto_base)
    if aot_dir is None:
        return None
    return CompileCache(aot_dir, cache_digest(setting, device), verbose=verbose)


def _inductor_counts() -> dict[str, int]:
    from torch._dynamo.utils import counters

    return {k: int(counters["inductor"][k]) for k in ("fxgraph_cache_hit", "fxgraph_cache_miss")}


class CompileCache:
    """One process's blob in ``cache_dir``: ``load()`` before the first
    compile, ``wrap(step)`` to time and count each step's first (compiling)
    call, ``finish()`` after those calls to name each step's source from
    Inductor's counters and save the artifacts."""

    def __init__(self, cache_dir: str | Path, digest: str, verbose: bool = False) -> None:
        self.cache_dir = Path(cache_dir)
        self.path = self.cache_dir / f"aot_{digest}.bin"
        self.verbose = verbose
        self.loaded = False
        self.reports: dict[str, dict[str, Any]] = {}

    def _note(self, msg: str) -> None:
        if self.verbose:
            _say(f"[aot_cache] {msg}")

    def _make_dir(self) -> None:
        """Create the directory private (0o700). One that exists is left as
        it is: if others can write to it, loads refuse it (SECURITY note)."""
        if self.cache_dir.is_dir():
            return
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        try:
            os.chmod(self.cache_dir, 0o700)
        except OSError:
            pass

    def load(self) -> bool:
        """Load this process's blob into Inductor's caches, if it is there
        and safe. A corrupt blob is deleted. Returns whether one loaded."""
        self._make_dir()
        if not self.path.exists():
            return False
        if not _safe_to_load(self.path):
            _say(f"[aot_cache] refusing to load {self.path.name}: the cache directory "
                 "or blob is not private to this uid; compiling without it")
            return False
        try:  # None: PyTorch could not read the blob (it logs why)
            failure = None if torch.compiler.load_cache_artifacts(
                self.path.read_bytes()) is not None else "unreadable"
        except Exception as exc:  # a corrupt or foreign blob: compile anew
            failure = repr(exc)
        if failure is not None:
            _say(f"[aot_cache] load of {self.path.name} failed ({failure}); deleting it "
                 "and compiling")
            self.path.unlink(missing_ok=True)
            return False
        try:  # mark as recently used, so pruning keeps it
            os.utime(self.path)
        except OSError:
            pass
        self.loaded = True
        self._note(f"loaded compile artifacts from {self.path.name}")
        return True

    def save(self) -> bool:
        """Write every compile artifact of this process to the blob,
        atomically, then prune the directory. Returns whether it wrote."""
        artifacts = torch.compiler.save_cache_artifacts()
        if artifacts is None:
            return False
        blob = artifacts[0]
        self._make_dir()
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, self.path)
        except OSError as exc:
            Path(tmp).unlink(missing_ok=True)
            self._note(f"could not write {self.path.name} ({exc!r})")
            return False
        self._note(f"saved compile artifacts ({len(blob) / 1e6:.1f} MB) to {self.path.name}")
        prune_lru(self.cache_dir, keep=self.path)
        return True

    def wrap(self, step: Callable[..., Any], label: str) -> Callable[..., Any]:
        """``step`` whose first call is timed (it compiles) and counted:
        Inductor's FX-graph cache hits and misses go to ``reports[label]``.
        Later calls go straight to ``step``. ``finish`` names the sources."""

        def call(*args: Any, **kwargs: Any) -> Any:
            if label in self.reports:
                return step(*args, **kwargs)
            before = _inductor_counts()
            t0 = time.perf_counter()
            result = step(*args, **kwargs)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = _inductor_counts()
            self.reports[label] = {"seconds": seconds, **{
                k: after[k] - before[k] for k in ("fxgraph_cache_hit", "fxgraph_cache_miss")}}
            return result

        return call

    def finish(self) -> None:
        """After the wrapped steps' first calls (the trainer calls it after
        each epoch): each new report's source, from its counts, and one save
        of every artifact of this process if any step compiled. One save at
        this point, not one per step, so that the blob holds every graph
        whatever PyTorch's serialiser keeps between calls."""
        new = {label: r for label, r in self.reports.items() if "source" not in r}
        for r in new.values():
            if self.loaded and r["fxgraph_cache_hit"] > 0 and r["fxgraph_cache_miss"] == 0:
                r["source"] = "aot-cache"  # the blob holds it: left as it is
        compiled = [r for r in new.values() if "source" not in r]
        if compiled:
            source = "compiled" if self.save() else "compiled-unsaved"
            for r in compiled:
                r["source"] = source
        for label, r in new.items():
            self._note(f"{label} ready in {r['seconds']:.1f}s ({r['source']}; Inductor "
                       f"FX-graph cache hits {r['fxgraph_cache_hit']}, misses "
                       f"{r['fxgraph_cache_miss']})")


def prune_lru(cache_dir: Path, keep: Path) -> None:
    """After a save, keep the ``SDE_AOT_CACHE_KEEP`` (default 16) most
    recently used blobs (loads touch their mtime) and delete the rest; 0
    turns pruning off."""
    try:
        limit = int(os.environ.get("SDE_AOT_CACHE_KEEP", "16"))
    except ValueError:
        limit = 16
    if limit <= 0:
        return
    try:
        blobs = sorted(cache_dir.glob("aot_*.bin"), key=lambda p: p.stat().st_mtime,
                       reverse=True)
    except OSError:
        return
    for stale in blobs[limit:]:
        if stale != keep:
            stale.unlink(missing_ok=True)
