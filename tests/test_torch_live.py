"""The port's live stack held against the JAX package's on the CPU:
geometry, the device resize, the remap and rectification maps, the live
engine and its checkpoint watcher, and the live, SGBM, calibration and
camera-listing CLIs.

Tolerances: the device resize within 1e-6 and the remap within 1e-5 of the
JAX functions (float32, the same formulas; measured ~1e-7); the engine's
disparity and log-variance within 1e-4 (a float32 forward in two frameworks)
and its uint8 views within one level (truncation of values a float ulp from
an integer). The remap against ``cv2.remap`` as ``tests/test_remap.py``
holds the JAX one: 0.04 (cv2's 5-bit interpolation weights).
"""

import json
import os
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import jax_variables, write_checkpoint

from stereo_depth_estimation_tpu.live import calibrate as jax_calibrate
from stereo_depth_estimation_tpu.live import camera_setup as jax_camera_setup
from stereo_depth_estimation_tpu.live import depth_live_dl as jax_live
from stereo_depth_estimation_tpu.live import depth_live_sgbm as jax_sgbm
from stereo_depth_estimation_tpu.live import io_sources as jax_io_sources
from stereo_depth_estimation_tpu.live import list_cameras as jax_list_cameras
from stereo_depth_estimation_tpu.ops import geometry as jax_geometry
from stereo_depth_estimation_tpu.ops import remap as jax_remap
from stereo_depth_estimation_tpu.ops import resize as jax_resize
from stereo_depth_estimation_tpu_torch.live import (
    calibrate,
    camera_setup,
    depth_live_dl,
    depth_live_sgbm,
    io_sources,
    list_cameras,
)
from stereo_depth_estimation_tpu_torch.ops import geometry, remap, resize

BASE = 4
MODEL_WH = (48, 32)  # (W, H), as the engine takes it
CAPTURE_HW = (120, 160)


def _calibration(w=160, h=120) -> dict:
    pytest.importorskip("cv2")
    from test_remap import _synthetic_calibration

    return _synthetic_calibration(w=w, h=h)


def _write_frames(frame_dir: Path, n: int, size=CAPTURE_HW) -> list[tuple[np.ndarray, np.ndarray]]:
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    frame_dir.mkdir(parents=True, exist_ok=True)
    frames = []
    for i in range(n):
        pair = tuple(rng.integers(0, 256, (*size, 3), dtype=np.uint8) for _ in range(2))
        for side, img in zip(("left", "right"), pair):
            cv2.imwrite(str(frame_dir / f"{side}_{i:03d}.png"), img)
        frames.append(pair)
    return frames


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("live")
    write_checkpoint(root / "model.pt",
                     jax_variables(BASE, (MODEL_WH[1], MODEL_WH[0]), seed=7), epoch=5)
    return root / "model.pt"


# -- geometry -------------------------------------------------------------

def test_geometry_equals_jax() -> None:
    rng = np.random.default_rng(0)
    disp = rng.uniform(-1.0, 30.0, (24, 32)).astype(np.float32)
    disp[0, :4] = [np.nan, np.inf, 0.0, 1e-7]
    np.testing.assert_array_equal(geometry.disparity_to_depth_np(disp, 400.0, 0.07),
                                  jax_geometry.disparity_to_depth_np(disp, 400.0, 0.07))
    np.testing.assert_allclose(
        geometry.disparity_to_depth(torch.from_numpy(disp), 400.0, 0.07).numpy(),
        np.asarray(jax_geometry.disparity_to_depth(jnp.asarray(disp), 400.0, 0.07)),
        rtol=1e-6, equal_nan=True)
    logvar = rng.uniform(-6.0, 3.0, (24, 32)).astype(np.float32)
    np.testing.assert_array_equal(geometry.confidence_from_logvar_np(logvar),
                                  jax_geometry.confidence_from_logvar_np(logvar))
    np.testing.assert_allclose(
        geometry.confidence_from_logvar(torch.from_numpy(logvar)).numpy(),
        np.asarray(jax_geometry.confidence_from_logvar(jnp.asarray(logvar))), rtol=1e-6)
    depth = geometry.disparity_to_depth_np(disp, 400.0, 0.07)
    np.testing.assert_array_equal(geometry.depth_contour_mask(depth, 0.5, 0.0, 10.0),
                                  jax_geometry.depth_contour_mask(depth, 0.5, 0.0, 10.0))
    for window in (1, 5, 15, 100):
        assert (geometry.center_patch_median(depth, window)
                == jax_geometry.center_patch_median(depth, window))
    assert np.isnan(geometry.center_patch_median(np.full((8, 8), np.nan), 3))
    p1 = np.array([[500.0, 0, 320, 0], [0, 500, 240, 0], [0, 0, 1, 0]])
    p2 = p1.copy()
    p2[0, 3] = -35.0
    for args in ((p1, p2, None), (p1, p1, np.array([0.05, 0, 0])), (None, None, [0.1, 0.2, 0.3]),
                 (None, None, None), (p1 * 0, p2, None)):
        assert geometry.estimate_baseline_m(*args) == jax_geometry.estimate_baseline_m(*args)
    assert geometry.scale_focal_to_model(500.0, 640, 320) == jax_geometry.scale_focal_to_model(
        500.0, 640, 320) == 250.0


# -- resize and remap -----------------------------------------------------

@pytest.mark.parametrize("shape,out_hw", [
    ((120, 160, 3), (32, 48)), ((2, 48, 64, 6), (24, 32)), ((30, 40, 1), (64, 80)),
    ((32, 48, 3), (32, 48)), ((37, 53, 2), (16, 16)),
])
def test_device_resize_equals_jax(shape, out_hw) -> None:
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    got = resize.resize_bilinear(torch.from_numpy(x), out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*shape[:-3], *out_hw, shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_resize.resize_bilinear(
        jnp.asarray(x), out_hw)), rtol=0, atol=1e-6)
    disp = x[..., 0] * 20
    np.testing.assert_allclose(
        resize.resize_disparity(torch.from_numpy(disp), out_hw, src_width=shape[-2] * 2).numpy(),
        np.asarray(jax_resize.resize_disparity(jnp.asarray(disp), out_hw,
                                               src_width=shape[-2] * 2)),
        rtol=0, atol=1e-5)


def test_remap_equals_jax_and_cv2() -> None:
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    map_x = rng.uniform(-2, 52, (40, 50)).astype(np.float32)
    map_y = rng.uniform(-2, 42, (40, 50)).astype(np.float32)
    map_x[0, :3] = [-1.0, 49.0, 49.5]  # exactly on and across the edges
    got = remap.remap_bilinear(torch.from_numpy(img), torch.from_numpy(map_x),
                               torch.from_numpy(map_y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_remap.remap_bilinear(img, map_x, map_y)),
                               rtol=0, atol=1e-5)
    expected = cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
    np.testing.assert_allclose(got, expected, atol=0.04)
    gray = remap.remap_bilinear(torch.from_numpy(img[..., 0]), torch.from_numpy(map_x),
                                torch.from_numpy(map_y))
    np.testing.assert_array_equal(gray.numpy(), got[..., 0])
    u8 = (img * 255).astype(np.uint8)
    for image in (u8, img.astype(np.float64)):
        ours = remap.remap_bilinear_np(image, map_x, map_y)
        theirs = jax_remap.remap_bilinear_np(image, map_x, map_y)
        assert ours.dtype == theirs.dtype
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * (255 if image is u8 else 1))


def test_rectify_maps_and_rectifier_equal_jax() -> None:
    calib = _calibration()
    for cam, r, p in (("l", "R1", "P1"), ("r", "R2", "P2")):
        args = (calib[f"mtx_{cam}"], calib[f"dist_{cam}"], calib[r], calib[p], (160, 120))
        for ours, theirs in zip(remap.compute_rectify_map(*args),
                                jax_remap.compute_rectify_map(*args)):
            np.testing.assert_array_equal(ours, theirs)
    rect = remap.Rectifier.from_calibration(calib, device="cpu")
    ref = jax_remap.Rectifier.from_calibration(calib)
    assert rect.image_size == ref.image_size == (160, 120)
    assert rect.focal_length_px == ref.focal_length_px
    assert rect.baseline_m == ref.baseline_m and 0.06 < rect.baseline_m < 0.08
    img = np.random.default_rng(2).uniform(0, 1, (120, 160, 3)).astype(np.float32)
    np.testing.assert_allclose(rect.rectify_right(torch.from_numpy(img)).numpy(),
                               np.asarray(ref.rectify_right(jnp.asarray(img))), atol=1e-5)


# -- engine and watcher ---------------------------------------------------

@pytest.mark.parametrize("rectify", [True, False], ids=["rectified", "raw"])
def test_engine_process_equals_jax(ckpt, tmp_path, rectify) -> None:
    calib = _calibration() if rectify else None
    engine = depth_live_dl.LiveDepthEngine(
        MODEL_WH, remap.Rectifier.from_calibration(calib, "cpu") if rectify else None,
        device="cpu", base_channels=BASE)
    ref = jax_live.LiveDepthEngine(
        MODEL_WH, jax_remap.Rectifier.from_calibration(calib) if rectify else None,
        base_channels=BASE)
    assert engine.load_checkpoint(ckpt) == ref.load_checkpoint(ckpt) == (5, True)
    for frame_l, frame_r in _write_frames(tmp_path, 2):
        got, want = engine.process(frame_l, frame_r), ref.process(frame_l, frame_r)
        for name, a, b in zip(("disparity", "logvar"), got, want):
            assert a.dtype == np.float32 and a.shape == (MODEL_WH[1], MODEL_WH[0]), name
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == np.uint8 and a.shape == (MODEL_WH[1], MODEL_WH[0], 3)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert np.all(got[0] >= 0) and -6 <= got[1].min() and got[1].max() <= 3


def test_watcher_reloads_and_skips_a_checkpoint_that_does_not_fit(ckpt, tmp_path) -> None:
    local = tmp_path / "last.pt"
    local.write_bytes(ckpt.read_bytes())
    engine = depth_live_dl.LiveDepthEngine(MODEL_WH, None, device="cpu", base_channels=BASE)
    engine.load_checkpoint(local)
    watcher = depth_live_dl.CheckpointWatcher(engine, local, poll_sec=0.0)
    frame = np.random.default_rng(3).integers(0, 256, (*CAPTURE_HW, 3), dtype=np.uint8)
    before = engine.process(frame, frame)

    def replace(variables, epoch, bump_s):
        write_checkpoint(local, variables, epoch)
        now = time.time_ns() + bump_s * 10**9
        os.utime(local, ns=(now, now))
        watcher.maybe_reload()

    # Another width: every shape is checked first, so nothing is copied.
    replace(jax_variables(8, (MODEL_WH[1], MODEL_WH[0]), seed=8), 9, 1)
    assert engine.loaded_epoch == 5
    for a, b in zip(engine.process(frame, frame), before):
        np.testing.assert_array_equal(a, b)
    # A checkpoint that fits is loaded.
    replace(jax_variables(BASE, (MODEL_WH[1], MODEL_WH[0]), seed=9), 6, 2)
    assert engine.loaded_epoch == 6
    assert not np.allclose(engine.process(frame, frame)[0], before[0])


# -- CLIs -----------------------------------------------------------------

def _live_argv(ckpt: Path, frames: Path, out: Path, *extra: str) -> list[str]:
    return ["--input-dir", str(frames), "--headless", "--headless-output", str(out),
            "--checkpoint", str(ckpt), "--model-width", str(MODEL_WH[0]),
            "--model-height", str(MODEL_WH[1]), "--base-channels", str(BASE),
            "--max-frames", "2", *extra]


@pytest.mark.parametrize("rectify", [True, False], ids=["rectified-ema", "raw"])
def test_live_cli_readouts_equal_jax(ckpt, tmp_path, rectify) -> None:
    _write_frames(tmp_path / "frames", 3)
    calib = tmp_path / "stereo_calib.npz"
    if rectify:
        np.savez_compressed(calib, **_calibration())
        extra = ["--calibration", str(calib), "--ema-alpha", "0.5"]
    else:
        extra = ["--calibration", str(calib), "--no-rectify"]
    jax_live.main(_live_argv(ckpt, tmp_path / "frames", tmp_path / "jax", *extra,
                             "--aot-cache", "off"))
    depth_live_dl.main(_live_argv(ckpt, tmp_path / "frames", tmp_path / "port", *extra,
                                  "--device", "cpu"))
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 6  # 2 frames: depth, confidence, readout
    for i in range(2):
        got = json.loads((tmp_path / "port" / f"readout_{i:05d}.json").read_text())
        want = json.loads((tmp_path / "jax" / f"readout_{i:05d}.json").read_text())
        assert got.keys() == want.keys() and got.pop("fps") > 0
        want.pop("fps")
        assert got["checkpoint_epoch"] == want["checkpoint_epoch"] == 5
        assert (got["center_depth_m"] is None) == (not rectify)
        for key, value in want.items():
            assert (got[key] is None) == (value is None), key
            if value is not None:  # medians of float32 maps: equal to an ulp or two
                assert got[key] == pytest.approx(value, rel=1e-5), key


def test_live_cli_refuses_a_capture_size_off_the_calibration(ckpt, tmp_path) -> None:
    calib = tmp_path / "stereo_calib.npz"
    np.savez_compressed(calib, **_calibration())
    _write_frames(tmp_path / "frames", 1, size=(64, 64))
    with pytest.raises(RuntimeError, match="size mismatch"):
        depth_live_dl.main(_live_argv(ckpt, tmp_path / "frames", tmp_path / "out",
                                      "--calibration", str(calib), "--device", "cpu"))


def test_live_cli_flags_device_and_defaults(ckpt, tmp_path) -> None:
    argv = _live_argv(ckpt, tmp_path, tmp_path / "out", "--no-rectify")
    ours = vars(depth_live_dl.parse_args(argv))
    # The JAX viewer always jits; the port compiles on --compile, with the
    # trainer's flags and defaults.
    assert [ours.pop(k) for k in ("compile", "compile_mode", "compile_backend")] == [
        False, "default", "xla"]
    assert ours == vars(jax_live.parse_args(argv))
    # A compile-cache directory is taken; without --compile nothing is
    # compiled, so nothing is written there.
    _write_frames(tmp_path / "frames", 2)
    depth_live_dl.main(_live_argv(ckpt, tmp_path / "frames", tmp_path / "out", "--no-rectify",
                                  "--device", "cpu", "--aot-cache", str(tmp_path / "aot")))
    assert len(list((tmp_path / "out").glob("readout_*.json"))) == 2
    assert not (tmp_path / "aot").exists()
    if not torch.cuda.is_available():
        for device in ("auto", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                depth_live_dl.main(argv + ["--device", device])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            depth_live_dl.LiveDepthEngine(MODEL_WH, None, base_channels=BASE)


def test_sgbm_cli_writes_the_jax_clis_bytes(tmp_path) -> None:
    calib = tmp_path / "stereo_calib.npz"
    np.savez_compressed(calib, **_calibration())
    _write_frames(tmp_path / "frames", 2)
    for name, main in (("jax", jax_sgbm.main), ("port", depth_live_sgbm.main)):
        main(["--input-dir", str(tmp_path / "frames"), "--headless", "--output-dir",
              str(tmp_path / name), "--calibration", str(calib), "--num-disparities", "32",
              "--block-size", "5"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for argv, error in ((["--num-disparities", "17"], "multiple of 16"),
                        (["--block-size", "4"], "odd")):
        with pytest.raises(ValueError, match=error):
            depth_live_sgbm.main(["--calibration", str(calib), "--input-dir", str(tmp_path),
                                  *argv])


def _projected_bank(module):
    """Synthetic chessboard detections of a known rig (as tests/test_live.py
    makes them), in ``module``'s DetectionBank."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    objp = module.board_object_points(4, 5, 0.03)
    bank = module.DetectionBank()
    for _ in range(10):
        rvec = rng.uniform(-0.25, 0.25, 3)
        tvec = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                         rng.uniform(0.4, 0.7)])
        pl, _ = cv2.projectPoints(objp, rvec, tvec, K, np.zeros(5))
        pr, _ = cv2.projectPoints(objp, rvec, tvec - [0.07, 0, 0], K, np.zeros(5))
        bank.add(pl.astype(np.float32), pr.astype(np.float32), (320, 240))
    return objp, bank


@pytest.fixture
def one_opencv_thread():
    """OpenCV's threaded solves differ between two runs on the same input
    (~1e-10, more where the solve is ill-conditioned); on one thread they
    are repeatable, so the two packages' results can be held equal."""
    cv2 = pytest.importorskip("cv2")
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(threads)


def test_solve_rig_geometry_equals_jax(one_opencv_thread) -> None:
    got = calibrate.solve_rig_geometry(*_projected_bank(calibrate))
    want = jax_calibrate.solve_rig_geometry(*_projected_bank(jax_calibrate))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert abs(geometry.estimate_baseline_m(got["P1"], got["P2"], got["T"]) - 0.07) < 0.0035


def test_calibrate_cli_on_rendered_boards_equals_jax(tmp_path, one_opencv_thread) -> None:
    cv2 = pytest.importorskip("cv2")
    rows, cols, square = 4, 5, 24
    board = np.full(((rows + 3) * square, (cols + 3) * square), 255, np.uint8)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                board[(r + 1) * square:(r + 2) * square, (c + 1) * square:(c + 2) * square] = 0
    rng = np.random.default_rng(4)
    frames = tmp_path / "boards"
    frames.mkdir()
    for i in range(10):
        warp = np.array([[1 + rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), 70.0],
                         [rng.uniform(-0.1, 0.1), 1 + rng.uniform(-0.1, 0.1), 40.0],
                         [rng.uniform(-4e-4, 4e-4), rng.uniform(-4e-4, 4e-4), 1.0]])
        for side, shift in (("left", 0.0), ("right", -25.0)):
            moved = warp.copy()
            moved[0, 2] += shift
            image = cv2.warpPerspective(board, moved, (320, 240), borderValue=255)
            cv2.imwrite(str(frames / f"{side}_{i:02d}.png"), image)
    argv = ["--image-dir", str(frames), "--rows", str(rows), "--cols", str(cols),
            "--square-size", "0.03", "--min-pairs", "8"]
    jax_calibrate.main(argv + ["--output", str(tmp_path / "jax.npz")])
    calibrate.main(argv + ["--output", str(tmp_path / "port.npz")])
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) and "Q" in got.files
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(RuntimeError, match="usable detections"):
        calibrate.main(argv + ["--min-pairs", "11", "--output", str(tmp_path / "no.npz")])


def test_camera_plumbing_equals_jax(tmp_path, monkeypatch) -> None:
    cv2 = pytest.importorskip("cv2")
    settings = camera_setup.CaptureSettings(640, 480, 30, fourcc="YUYV", buffer_size=2)
    assert (camera_setup._capture_plan(settings)
            == jax_camera_setup._capture_plan(jax_camera_setup.CaptureSettings(
                640, 480, 30, fourcc="YUYV", buffer_size=2)))
    assert camera_setup.fourcc_str(float(camera_setup.fourcc_int("mjpg"))) == "MJPG"
    with pytest.raises(ValueError, match="4 characters"):
        camera_setup.fourcc_int("bad")

    frames = _write_frames(tmp_path / "frames", 2)
    (tmp_path / "frames" / "left_009.png").write_bytes(b"")  # no right partner
    assert (list(io_sources.iter_stereo_pair_paths(tmp_path / "frames"))
            == list(jax_io_sources.iter_stereo_pair_paths(tmp_path / "frames")))
    for (a, b), (c, d) in zip(io_sources.directory_source(tmp_path / "frames"), frames):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(FileNotFoundError, match="No left"):
        next(io_sources.iter_stereo_pair_paths(tmp_path / "frames" / ".."))

    class FakeCapture:  # index 1 and 3 deliver 64x48 frames
        def __init__(self, index):
            self.index = index

        def read(self):
            ok = self.index in (1, 3)
            return ok, np.zeros((48, 64, 3), np.uint8) if ok else None

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    assert list_cameras.probe_cameras(4) == jax_list_cameras.probe_cameras(4) == [
        (1, 64, 48), (3, 64, 48)]
    list_cameras.main(["--max-index", "2"])
