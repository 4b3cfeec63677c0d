"""The port's serving CLIs held against the JAX package's on the CPU:
evaluate, predict, export and the cache CLI.

Both packages read one ``.pt``: JAX variables made from a seed, with
BatchNorm running statistics drawn with numpy (so eval-mode BatchNorm does
real work), carried across by ``state_dict_from_jax``. The JAX package's
``load_model_variables`` reads ``.pt`` files too.

Tolerances: evaluate metrics within 1e-4 relative (float32 forwards in two
frameworks, summed over every valid pixel; measured ~1e-6); predictions
within one float16 ulp plus 1e-4 (the npz stores float16, and a float32
difference of ~1e-6 can round to the neighbouring float16).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stereo_depth_estimation_tpu.data import cache_cli as jax_cache_cli
from stereo_depth_estimation_tpu.eval import evaluate as jax_evaluate
from stereo_depth_estimation_tpu.eval import predict as jax_predict
from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.training import export as jax_export
from stereo_depth_estimation_tpu.training.checkpoint import load_model_variables as jax_load
from stereo_depth_estimation_tpu_torch.data import cache_cli
from stereo_depth_estimation_tpu_torch.eval import evaluate, predict
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import state_dict_from_jax
from stereo_depth_estimation_tpu_torch.ops.codec import disparity_encode_np
from stereo_depth_estimation_tpu_torch.parallel import create_train_state, make_adamw
from stereo_depth_estimation_tpu_torch.training import checkpoint, export

BASE, HW = 4, (32, 48)
METRIC_RTOL = 1e-4


def jax_variables(base: int, hw: tuple[int, int], seed: int) -> dict:
    """The JAX StereoUNet's variable tree (its shapes from ``eval_shape``),
    every leaf drawn with numpy from ``seed``: kernels U(+-1/sqrt(fan_in)),
    biases U(+-0.1), BatchNorm scales U(0.5, 1.5), running means N(0, 0.2)
    and variances U(0.5, 2)."""
    shapes = jax.eval_shape(lambda: JaxUNet(base_channels=base).init(
        jax.random.key(0), jnp.zeros((1, *hw, 6)), train=False, return_uncertainty=True))
    rng = np.random.default_rng(seed)

    def draw(path, leaf) -> np.ndarray:
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            value = rng.uniform(-bound, bound, leaf.shape)
        elif name == "bias":
            value = rng.uniform(-0.1, 0.1, leaf.shape)
        elif name == "scale":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "mean":
            value = rng.normal(0.0, 0.2, leaf.shape)
        else:
            assert name == "var", name
            value = rng.uniform(0.5, 2.0, leaf.shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def write_checkpoint(path: Path, variables: dict, epoch: int) -> Path:
    """The variables as a reference ``.pt`` payload."""
    torch.save({"epoch": epoch, "model_state_dict": state_dict_from_jax(variables),
                "config": {}, "metrics": {}}, path)
    return path


def write_dataset(root: Path, per_scene: int = 4, shape=(40, 56)) -> None:
    """Two FoundationStereo-layout scenes with the same frame stems; each
    disparity map has a band of zeros (invalid pixels)."""
    rng = np.random.default_rng(11)
    for scene in ("scene_a", "scene_b"):
        base = root / scene / "dataset" / "data"
        for sub in ("left/rgb", "right/rgb", "left/disparity"):
            (base / sub).mkdir(parents=True, exist_ok=True)
        for i in range(per_scene):
            for side in ("left", "right"):
                Image.fromarray(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).save(
                    base / f"{side}/rgb" / f"{i:06d}.png")
            disparity = rng.uniform(0.5, 20.0, shape).astype(np.float32)
            disparity[: shape[0] // 5] = 0.0
            Image.fromarray(disparity_encode_np(disparity)).save(
                base / "left/disparity" / f"{i:06d}.png")


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("serving")
    write_dataset(root / "data")
    write_checkpoint(root / "model.pt", jax_variables(BASE, HW, seed=1), epoch=3)
    left, right = root / "left", root / "right"
    left.mkdir(), right.mkdir()
    rng = np.random.default_rng(2)
    for i in range(5):
        for d in (left, right):
            # Mixed extensions: pairing is by stem.
            ext = ".jpg" if (d is right and i == 0) else ".png"
            Image.fromarray(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)).save(
                d / f"frame_{i:03d}{ext}")
    return root


def _common(root: Path, *extra: str) -> list[str]:
    return ["--checkpoint", str(root / "model.pt"), "--height", str(HW[0]),
            "--width", str(HW[1]), "--base-channels", str(BASE), *extra]


@pytest.mark.parametrize("split,batch", [("val", 30), ("all", 3), ("train", 4)])
def test_evaluate_matches_the_jax_cli(root, split, batch) -> None:
    argv = _common(root, "--dataset-root", str(root / "data"), "--split", split,
                   "--batch-size", str(batch), "--val-fraction", "0.25", "--num-workers", "0",
                   "--device", "cpu")
    want = jax_evaluate.evaluate(jax_evaluate.build_parser().parse_args(
        argv + ["--aot-cache", "off", "--mesh-devices", "1"]))
    got = evaluate.main(argv)
    assert got.keys() == want.keys()
    for key in ("checkpoint", "checkpoint_epoch", "split", "samples", "valid_pixels"):
        assert got[key] == want[key], key
    assert got["checkpoint_epoch"] == 3 and got["valid_pixels"] > 0
    for key in ("mae", "rmse", "nll", "sigma", "loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)


def _assert_npz_close(got: Path, want: Path) -> None:
    a, b = np.load(got), np.load(want)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        x, y = a[key], b[key]
        assert x.dtype == y.dtype == np.float16 and x.shape == y.shape, key
        ulp = np.spacing(np.maximum(np.abs(x), np.abs(y)).astype(np.float16)).astype(np.float32)
        err = np.abs(x.astype(np.float32) - y.astype(np.float32))
        finite = np.isfinite(y)
        assert np.array_equal(np.isfinite(x), finite), key
        assert np.all(err[finite] <= ulp[finite] + 1e-4), (key, float(err[finite].max()))


def _predict_both(root: Path, out: Path, *argv: str) -> tuple[dict, dict]:
    argv = _common(root, *argv)
    want = jax_predict.predict(jax_predict.build_parser().parse_args(
        argv + ["--predictions-dir", str(out / "jax"), "--aot-cache", "off"]))
    got = predict.main(argv + ["--predictions-dir", str(out / "port"), "--device", "cpu"])
    return got, want


def test_predict_pair_dirs_match_jax_and_the_tail_batch(root, tmp_path) -> None:
    pairs = ["--left-dir", str(root / "left"), "--right-dir", str(root / "right")]
    got, want = _predict_both(root, tmp_path / "b2", *pairs, "--batch-size", "2", "--save-png")
    assert got["pairs"] == want["pairs"] == 5 and got["depth"] is want["depth"] is False
    names = sorted(p.name for p in (tmp_path / "b2" / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "b2" / "jax").iterdir())
    assert len([n for n in names if n.endswith("_disparity.png")]) == 5
    for name in (n for n in names if n.endswith(".npz")):
        _assert_npz_close(tmp_path / "b2" / "port" / name, tmp_path / "b2" / "jax" / name)
        payload = np.load(tmp_path / "b2" / "port" / name)
        assert payload["disparity"].shape == HW and np.all(payload["disparity"] >= 0)
    # A padded tail batch predicts what a batch holding every pair predicts.
    predict.main(_common(root, *pairs, "--batch-size", "5", "--device", "cpu",
                         "--predictions-dir", str(tmp_path / "b5")))
    for f in sorted((tmp_path / "b5").glob("*.npz")):
        a, b = np.load(f), np.load(tmp_path / "b2" / "port" / f.name)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{f.name} {key}")


def test_predict_dataset_split_and_depth_match_jax(root, tmp_path) -> None:
    calib = tmp_path / "calib.npz"
    p1 = np.array([[500.0, 0, 320, 0], [0, 500.0, 240, 0], [0, 0, 1, 0]])
    p2 = p1.copy()
    p2[0, 3] = -500.0 * 0.07
    np.savez(calib, P1=p1, P2=p2, T=np.array([-0.07, 0, 0]), image_size=np.array([640, 480]))
    got, want = _predict_both(root, tmp_path, "--dataset-root", str(root / "data"),
                              "--split", "all", "--batch-size", "3",
                              "--calibration", str(calib))
    assert got["pairs"] == want["pairs"] == 8 and got["depth"] is True
    names = sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.npz"))
    assert names[0] == "scene_a_000000.npz" and names[-1] == "scene_b_000003.npz"
    for name in names:
        _assert_npz_close(tmp_path / "port" / name, tmp_path / "jax" / name)
    payload = np.load(tmp_path / "port" / names[0])
    disp, depth = payload["disparity"].astype(np.float32), payload["depth_m"].astype(np.float32)
    valid = disp > 1e-2
    np.testing.assert_allclose(depth[valid], 500.0 * HW[1] / 640 * 0.07 / disp[valid], rtol=2e-2)


@pytest.mark.parametrize("case", ["duplicate", "left only", "neither", "no focal", "no size"])
def test_predict_refuses_what_the_jax_cli_refuses(root, tmp_path, case) -> None:
    argv = ["--left-dir", str(root / "left"), "--right-dir", str(root / "right")]
    if case == "duplicate":
        for d in ("l", "r"):
            (tmp_path / d).mkdir()
            for ext in (".png", ".jpg"):  # one stem, two extensions
                Image.fromarray(np.zeros((*HW, 3), np.uint8)).save(tmp_path / d / f"frame{ext}")
        argv = ["--left-dir", str(tmp_path / "l"), "--right-dir", str(tmp_path / "r")]
    elif case == "left only":
        argv = argv[:2]
    elif case == "neither":
        argv = []
    else:
        calib = tmp_path / "calib.npz"
        extra = ({"image_size": np.array([640, 480])} if case == "no focal"
                 else {"mtx_l": np.eye(3) * 500.0})
        np.savez(calib, T=np.array([-0.07, 0, 0]), **extra)
        argv += ["--calibration", str(calib)]
    argv = _common(root, *argv, "--predictions-dir", str(tmp_path / "out"))
    with pytest.raises(ValueError) as want:
        jax_predict.predict(jax_predict.build_parser().parse_args(argv + ["--aot-cache", "off"]))
    with pytest.raises(ValueError) as got:
        predict.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_export_writes_the_reference_payload_the_jax_package_reads(tmp_path) -> None:
    variables = jax_variables(BASE, HW, seed=4)
    model = StereoUNet(base_channels=BASE, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=False)
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    source = checkpoint.save_checkpoint(tmp_path / "ckpt", "last", state, epoch=7,
                                        config={"base_channels": BASE}, metrics={"val_mae": 1.5})
    bare = tmp_path / "bare.pt"
    torch.save(state_dict_from_jax(variables), bare)
    template = jax.tree.map(np.zeros_like, variables)
    for src, epoch, config in ((source, 7, {"base_channels": BASE}), (bare, -1, {})):
        out = export.main(["--checkpoint", str(src), "--base-channels", str(BASE),
                           "--out", str(tmp_path / "out" / f"{src.stem}.pt")])
        payload = torch.load(out, weights_only=False)
        assert payload.keys() == {"epoch", "model_state_dict", "config", "metrics"}
        assert payload["epoch"] == epoch and payload["config"] == config
        loaded, meta = jax_load(out, template)
        assert meta["epoch"] == epoch and not meta["missing_keys"]
        for want, got in zip(jax.tree.leaves(variables), jax.tree.leaves(loaded)):
            np.testing.assert_array_equal(np.asarray(got), want)
    # A checkpoint of another width is refused, key by key and shape by shape.
    with pytest.raises(ValueError, match="Shape mismatch"):
        export.main(["--checkpoint", str(source), "--base-channels", "8",
                     "--out", str(tmp_path / "wrong.pt")])


def test_cache_cli_writes_the_jax_caches_byte_for_byte(root, tmp_path) -> None:
    argv = ["--dataset-root", str(root / "data"), "--height", str(HW[0]),
            "--width", str(HW[1]), "--packed", "--max-samples", "7"]
    want = jax_cache_cli.run_build(
        jax_cache_cli.build_parser().parse_args(argv + ["--cache-root", str(tmp_path / "jax")]))
    got = cache_cli.main(argv + ["--cache-root", str(tmp_path / "port")])
    assert (got.num_written, got.num_skipped, got.num_samples_total) == (
        want.num_written, want.num_skipped, want.num_samples_total) == (7, 0, 7)
    entries = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npz"))
    assert entries == sorted(p.relative_to(tmp_path / "port")
                             for p in (tmp_path / "port").rglob("*.npz"))
    assert len(entries) == 7
    for rel in entries:
        a, b = np.load(tmp_path / "jax" / rel), np.load(tmp_path / "port" / rel)
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for name in ("images.bin", "disparity.bin", "meta.json"):
        assert ((tmp_path / "jax" / "packed" / name).read_bytes()
                == (tmp_path / "port" / "packed" / name).read_bytes()), name
    # A second run skips what is there.
    again = cache_cli.main(argv + ["--cache-root", str(tmp_path / "port")])
    assert (again.num_written, again.num_skipped) == (0, 7)


@pytest.mark.parametrize("name,port,jax_mod", [
    ("evaluate", evaluate.build_parser, jax_evaluate.build_parser),
    ("predict", predict.build_parser, jax_predict.build_parser),
    ("export", export.build_parser, jax_export.build_parser),
    ("cache_cli", cache_cli.build_parser, jax_cache_cli.build_parser),
])
def test_flags_and_defaults_are_the_jax_clis(name, port, jax_mod) -> None:
    ours = {a.dest: a.default for a in port()._actions}
    theirs = {a.dest: a.default for a in jax_mod()._actions}
    if name == "predict":  # the JAX CLI runs where JAX puts it; the port asks
        assert ours.pop("device") == "auto"
    if name in ("evaluate", "predict"):  # the JAX CLIs always jit; the port
        # compiles on --compile, with the trainer's flags and defaults
        assert [ours.pop(k) for k in ("compile", "compile_mode", "compile_backend")] == [
            False, "default", "xla"]
    assert ours == theirs


def _cli_run(root: Path, out: Path, cli: str, *argv: str) -> dict:
    if cli == "evaluate":
        return evaluate.main(_common(root, "--dataset-root", str(root / "data"), *argv))
    return predict.main(_common(root, "--left-dir", str(root / "left"), "--right-dir",
                                str(root / "right"), "--predictions-dir", str(out), *argv))


@pytest.mark.parametrize("cli,argv", [
    # Every flag has its mechanism now. Height sharding: on two ranks a 1 x 2
    # mesh scores what the JAX CLI's (data, spatial) mesh and one rank score;
    # one rank does not factor into two stripes and raises ValueError. The
    # compile cache's directory is taken, and without --compile nothing is
    # compiled, so nothing is written there.
    ("evaluate", ["--mesh-devices", "2", "--spatial-devices", "2"]),
    ("evaluate", ["--spatial-devices", "2"]),
    ("evaluate", ["--aot-cache", "some/dir"]),
    ("predict", ["--aot-cache", "some/dir"]),
], ids=lambda a: a if isinstance(a, str) else a[0].lstrip("-"))
def test_flags_without_a_mechanism_raise(root, tmp_path, cli, argv) -> None:
    if "--spatial-devices" in argv:
        common = _common(root, "--dataset-root", str(root / "data"), "--split", "all",
                         "--batch-size", "3", "--num-workers", "0", "--device", "cpu")
        if "--mesh-devices" not in argv:
            with pytest.raises(ValueError, match="1 rank\\(s\\) do not factor into spatial=2"):
                evaluate.main(common + argv)
            return
        want = jax_evaluate.evaluate(jax_evaluate.build_parser().parse_args(
            common + ["--aot-cache", "off", *argv]))
        two = evaluate.main(common + argv)
        one = evaluate.main(common + ["--mesh-devices", "1"])
        assert two.keys() == want.keys() == one.keys()
        for got in (two, one):
            for key in ("checkpoint", "checkpoint_epoch", "split", "samples", "valid_pixels"):
                assert got[key] == want[key], key
            for key in ("mae", "rmse", "nll", "sigma", "loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)
        return
    cache_dir = tmp_path / argv[1]
    got = _cli_run(root, tmp_path / "out", cli, "--device", "cpu", "--aot-cache", str(cache_dir))
    want = _cli_run(root, tmp_path / "eager", cli, "--device", "cpu", "--aot-cache", "off")
    assert got.keys() == want.keys() and "compile_cache" not in got
    assert not cache_dir.exists()
    if cli == "predict":
        assert len(list((tmp_path / "out").glob("*.npz"))) == got["pairs"] == 5


@pytest.mark.parametrize("cli", ["evaluate", "predict"])
def test_device_auto_is_the_card(root, tmp_path, cli) -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    for device in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _cli_run(root, tmp_path, cli, "--device", device)
