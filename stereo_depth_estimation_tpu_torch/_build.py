"""Build the port's CUDA kernels from ``csrc/*.cu`` at first use.

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``. Libraries land in ``build/torch_kernels/``
at the repository root (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, kept in the build log.
    "-Xptxas", "-v",
)


@dataclass
class BuiltLibrary:
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str


_lock = threading.Lock()
_built: dict[str, BuiltLibrary] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, BuiltLibrary]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc per source, all
    started together; return the libraries by source stem."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        pending = []
        for src in sources:
            if src.stem in _built:
                continue
            out = _target(src)
            if out.exists():
                log_path = out.with_suffix(".log")
                log = log_path.read_text() if log_path.exists() else ""
                _built[src.stem] = BuiltLibrary(out, 0.0, log)
            else:
                pending.append((src, out))
        if pending:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            start = time.perf_counter()
            procs = []
            for src, out in pending:
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )
                procs.append((src, out, tmp, proc))
            failures = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
                    tmp.unlink(missing_ok=True)
                    continue
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)  # atomic: a concurrent build sees old or new
                _built[src.stem] = BuiltLibrary(out, time.perf_counter() - start, log)
            if failures:
                raise RuntimeError("nvcc failed for " + "\n".join(failures))
        return dict(_built)


def load_library(stem: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<stem>.cu``, built first if needed."""
    if stem not in _loaded:
        libs = build_all()
        if stem not in libs:
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
        with _lock:
            _loaded.setdefault(stem, ctypes.CDLL(str(libs[stem].path)))
    return _loaded[stem]
