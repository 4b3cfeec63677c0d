"""Rules the PyTorch port keeps: no JAX anywhere in it or in chip_smoke.py,
no quiet CPU fallback for CUDA, and a kernel launcher that takes CUDA
tensors only."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stereo_depth_estimation_tpu_torch import _build
from stereo_depth_estimation_tpu_torch._device import resolve_device
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.ops import augment_cuda

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "stereo_depth_estimation_tpu_torch"
FORBIDDEN = {"jax", "flax", "optax", "orbax", "stereo_depth_estimation_tpu"}
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path) -> None:
    assert not _imported_roots(path) & FORBIDDEN


def test_port_imports_with_jax_blocked() -> None:
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import importlib\n"
        f"for m in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    done = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert done.returncode == 0, done.stderr
    assert "imported" in done.stdout


def test_asking_for_cuda_without_it_raises() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoUNet(base_channels=4)  # device defaults to "cuda"
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_launcher_refuses_cpu_tensors() -> None:
    x = torch.zeros((2, 8, 8, 6), dtype=torch.uint8)
    packed = torch.zeros((2, 16), dtype=torch.float32)
    before = augment_cuda.pointwise_chain_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        augment_cuda.pointwise_chain_cuda(x, packed, 0, torch.float32)
    assert augment_cuda.pointwise_chain_cuda.launches == before
    # Only the dispatching wrapper sends a CPU tensor to the plain version.
    out = augment_cuda.pointwise_chain(x, packed, 0, torch.float32)
    assert torch.equal(out, augment_cuda.pointwise_chain_plain(x, packed, 0, torch.float32))
    assert augment_cuda.pointwise_chain_cuda.launches == before


def test_build_is_keyed_on_the_source(tmp_path) -> None:
    a, b = tmp_path / "k.cu", tmp_path / "k2.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    assert _build._target(a) != _build._target(b)
    assert _build._target(a) == _build._target(a)
    assert _build._target(a).parent == _build.BUILD_DIR
    assert (PORT / "csrc" / "augment.cu").exists()


def test_chip_smoke_without_cuda_exits_nonzero_with_no_result(tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    here = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert here.returncode != 0 and '"ok"' not in here.stdout
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    alone = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300,
    )
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
