"""Rules the PyTorch port keeps: no JAX anywhere in it or in its scripts,
no quiet CPU fallback for CUDA, and kernel launchers that take CUDA
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
from stereo_depth_estimation_tpu_torch.ops import augment_cuda, batchnorm

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "stereo_depth_estimation_tpu_torch"
FORBIDDEN = {"jax", "flax", "optax", "orbax", "stereo_depth_estimation_tpu"}
SCRIPTS = ["chip_smoke", "augment_timing", "rank_drift", "compile_fault", "head_rounding"]
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / f"{name}.py" for name in SCRIPTS]


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


def test_the_compile_cache_is_a_port_module() -> None:
    assert PORT / "parallel" / "aot_cache.py" in PORT_FILES


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def test_a_compile_failure_is_never_an_eager_run() -> None:
    """No module of the port or script sets Dynamo's config (its
    ``suppress_errors`` turns a failed compile into an eager run), and no
    ``try`` that catches holds a call of ``torch.compile``, ``compile_model``
    or the compiled forward, so a compile failure raises."""
    compiling = {"torch.compile", "compile_model", "_forward_module"}
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        assert "suppress_errors" not in path.read_text(), path.name
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    assert "_dynamo.config" not in _dotted(target), (path.name, node.lineno)
            if isinstance(node, ast.Call) and _dotted(node.func).endswith("config.patch"):
                assert "_dynamo" not in _dotted(node.func), (path.name, node.lineno)
            if isinstance(node, ast.Try) and node.handlers:
                for inner in (n for stmt in node.body for n in ast.walk(stmt)):
                    if isinstance(inner, ast.Call):
                        assert _dotted(inner.func) not in compiling, (path.name, inner.lineno)


def _import_all_with_blocked(blocked: list[str]) -> None:
    """Import every module of the port and its scripts in a fresh
    interpreter where importing any of ``blocked`` raises."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import importlib\n"
        f"for m in {modules + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    done = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert done.returncode == 0, done.stderr
    assert "imported" in done.stdout


def test_port_imports_with_jax_blocked() -> None:
    _import_all_with_blocked(sorted(FORBIDDEN))


def test_port_imports_with_cv2_blocked() -> None:
    """OpenCV is needed only by the camera, GUI and headless-PNG paths, and
    is imported inside the functions that use it."""
    _import_all_with_blocked(["cv2"])


# What the port may call of torch.distributed: set-up (the spatial mesh's
# row groups too), queries, and the two collectives gloo runs on CUDA
# tensors, so that one code path serves NCCL, gloo on CUDA and gloo on the
# CPU.
DIST_ALLOWED = {
    "all_reduce", "broadcast", "init_process_group", "destroy_process_group",
    "is_available", "is_initialized", "get_backend", "get_rank", "get_world_size",
    "group", "new_group",
}


def test_collectives_are_all_reduce_and_broadcast_only() -> None:
    used = {}
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        aliases = {"dist"} if any(
            isinstance(n, ast.Import) and any(a.name == "torch.distributed" and a.asname == "dist"
                                              for a in n.names)
            for n in ast.walk(tree)) else set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            if (isinstance(base, ast.Name) and base.id in aliases) or (
                    isinstance(base, ast.Attribute) and base.attr == "distributed"
                    and isinstance(base.value, ast.Name) and base.value.id == "torch"):
                used.setdefault(node.attr, set()).add(path.name)
    assert {"all_reduce", "broadcast", "init_process_group"} <= used.keys()
    assert used.keys() <= DIST_ALLOWED, {k: v for k, v in used.items() if k not in DIST_ALLOWED}
    # The halo exchange is held to the rule too: it is all-reduces only.
    assert PORT / "ops" / "halo.py" in PORT_FILES
    assert {k for k, files in used.items() if "halo.py" in files} == {"all_reduce"}
    assert "new_group" in used and used["new_group"] == {"mesh.py"}


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


def _bn_cases():
    x, dy = torch.randn(12, 8), torch.randn(12, 8)
    gamma, beta, sums = torch.rand(8) + 0.5, torch.randn(8), torch.randn(16)
    stats = torch.cat([torch.randn(8), torch.rand(8), torch.rand(8), torch.tensor([12.0])])

    def running():
        return torch.zeros(8), torch.ones(8), torch.zeros((), dtype=torch.long)

    return {
        "bn_stats": (x, True),
        "bn_relu_fwd": (x, stats, beta, True),
        "bn_relu_bwd_sums": (dy, x, stats, beta, True),
        "bn_relu_bwd_dx": (dy, x, stats, beta, torch.randn(32), True),
        "bn_moments": (batchnorm.bn_stats_plain(x, False), gamma, *running(), 1e-5, 0.1),
        "bn_bwd_coefficients": (2 * sums, sums, stats, 1e-5),
        "bn_relu_forward": (x, gamma, beta, *running(), 1e-5, 0.1, False, True),
        "bn_relu_backward": (dy, x, stats, beta, 1e-5, True),
    }


@pytest.mark.parametrize("name", list(_bn_cases()))
def test_batchnorm_launchers_refuse_cpu_tensors(name) -> None:
    launcher = getattr(batchnorm, f"{name}_cuda")
    args = _bn_cases()[name]
    before = launcher.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(*args)
    assert launcher.launches == before
    # Only the custom op sends CPU tensors to the plain version.
    out = getattr(batchnorm, name)(*args)
    want = getattr(batchnorm, f"{name}_plain")(*args)
    assert all(torch.equal(a, b) for a, b in zip(*((t,) if isinstance(t, torch.Tensor) else t
                                                   for t in (out, want))))
    assert launcher.launches == before


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
