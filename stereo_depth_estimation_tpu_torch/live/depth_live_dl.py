"""``foundation-stereo-live-view`` on one GPU: the live deep-learning stereo
depth viewer.

Counterpart of ``stereo_depth_estimation_tpu/live/depth_live_dl.py``, with the
same flags:

    python -m stereo_depth_estimation_tpu_torch.live.depth_live_dl \\
        --left 0 --right 1 --checkpoint <last.pt>
    python -m stereo_depth_estimation_tpu_torch.live.depth_live_dl \\
        --input-dir <frames> --headless --checkpoint <last.pt> [--device cpu]

Checkpoint resolution by path / run id / newest mtime; hot reload on an
mtime change that skips a reload which fails; rectification from the
calibration bundle; metric depth f*B/disparity with the focal length scaled
from calibration to model width; confidence exp(-logvar/2); EMA smoothing;
centre-patch median readouts; 0.5 m iso-depth contours; turbo, inferno,
magma or viridis colour maps over a fixed 0-10 m range.

``LiveDepthEngine.process`` does a frame's device work: the uint8 frames go
to the device, are scaled to [0, 1], rectified at capture size, resized to
the model size, and run through the StereoUNet in float32 with its running
BatchNorm statistics (its four pools on kernel K2 on the card); the rectified
views come back as uint8. The host decodes frames and draws. ``--input-dir``
with ``--headless`` runs the same pipeline on stored frames and writes PNGs
and JSON readouts. ``cv2`` is imported only by the camera, GUI and PNG paths.

With ``--compile`` the device work after the upload (scale, rectify, resize,
the StereoUNet and the uint8 views) is one ``torch.compile`` program, as the
JAX viewer jits it; ``--compile-mode reduce-overhead`` replays it as a CUDA
graph. ``--aot-cache`` (``auto``: ``<output-dir>/.aot_cache``) carries its
compile artifacts to the next launch (``parallel/aot_cache.py``). Eager is
the default.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_cli_device, resolve_device
from ..models.unet import StereoUNet
from ..ops.geometry import (
    center_patch_median,
    confidence_from_logvar_np,
    depth_contour_mask,
    disparity_to_depth_np,
    estimate_baseline_m,
    scale_focal_to_model,
)
from ..ops.remap import Rectifier, remap_bilinear
from ..ops.resize import resample_matrices, resize_bilinear_with
from ..parallel.aot_cache import CompileCache, cache_digest, resolve_aot_dir
from ..parallel.train_step import CompileOptions, compile_model, compile_options_from
from ..spans import span
from ..training.checkpoint import (
    checkpoint_mtime_ns,
    load_model_variables,
    resolve_checkpoint_path,
)
from ..training.config import add_compile_arguments
from .camera_setup import CaptureSettings
from .io_sources import FrameSource, camera_source, directory_source

COLORMAP_NAMES = ("turbo", "inferno", "magma", "viridis")
DEPTH_VIS_RANGE_M = (0.0, 10.0)
DEPTH_CONTOUR_STEP_M = 0.5
DEPTH_CONTOUR_COLOR_BGR = (0, 255, 0)
CONFIDENCE_VIS_RANGE = (0.0, 5.0)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Run live stereo depth estimation using the trained model."
    )
    parser.add_argument("--left", type=int, default=None, help="Left camera index.")
    parser.add_argument("--right", type=int, default=None, help="Right camera index.")
    parser.add_argument(
        "--input-dir", type=Path, default=None,
        help="Process stored left_*/right_* frame pairs instead of cameras.",
    )
    parser.add_argument(
        "--headless", action="store_true",
        help="No GUI; write depth/confidence PNGs + JSON readouts to --headless-output.",
    )
    parser.add_argument(
        "--headless-output", type=Path, default=Path("live_out"),
        help="Headless output directory.",
    )
    parser.add_argument(
        "--max-frames", type=int, default=0,
        help="Stop after N frames (0 = unlimited; useful headless).",
    )
    parser.add_argument(
        "--checkpoint", type=Path, default=None,
        help="Checkpoint path: a reference .pt file "
             "(outputs/<run>/checkpoints/last.pt).",
    )
    parser.add_argument("--run-id", type=str, default=None,
                        help="Run id under --output-dir when --checkpoint is absent.")
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"),
                        help="Training output directory containing run subdirectories.")
    parser.add_argument("--checkpoint-name", type=str, default="last",
                        help="Checkpoint name inside outputs/<run_id>/checkpoints/.")
    parser.add_argument("--watch-checkpoint", action="store_true",
                        help="Reload checkpoint automatically when it changes.")
    parser.add_argument("--checkpoint-poll-sec", type=float, default=2.0,
                        help="How often to check checkpoint updates in watch mode.")
    parser.add_argument("--device", type=str, default="auto",
                        help='Inference device: "auto" (= cuda), "cuda" or "cpu".')
    parser.add_argument("--model-width", type=int, default=320, help="Model input width.")
    parser.add_argument("--model-height", type=int, default=240, help="Model input height.")
    parser.add_argument("--base-channels", type=int, default=32,
                        help="UNet width; must match the checkpoint's.")
    parser.add_argument("--calibration", type=Path,
                        default=Path("calibration/stereo_calib.npz"),
                        help="Calibration file from the calibrate CLI.")
    parser.add_argument("--no-rectify", action="store_true",
                        help="Disable undistortion/rectification even if calibration exists.")
    parser.add_argument("--width", type=int, default=640, help="Capture width.")
    parser.add_argument("--height", type=int, default=480, help="Capture height.")
    parser.add_argument("--fps", type=int, default=30, help="Capture FPS request.")
    parser.add_argument("--fourcc", type=str, default="MJPG",
                        help="Requested pixel format (for example: MJPG, YUYV).")
    parser.add_argument("--buffer-size", type=int, default=1, help="Capture queue size.")
    parser.add_argument("--warmup-frames", type=int, default=20,
                        help="Initial frames to discard.")
    parser.add_argument("--drop-frames", type=int, default=1,
                        help="Extra frames to drop each loop to reduce latency.")
    parser.add_argument("--center-window", type=int, default=15,
                        help="Center patch size for readout.")
    parser.add_argument("--colormap", type=str, default="turbo",
                        choices=sorted(COLORMAP_NAMES),
                        help="Colormap for disparity visualization.")
    parser.add_argument("--ema-alpha", type=float, default=0.0,
                        help="Optional temporal smoothing in [0,1]; 0 disables.")
    parser.add_argument("--aot-cache", type=str, default="auto",
                        help="Compile cache of --compile across processes: "
                             "'auto' = <output-dir>/.aot_cache, 'off', or a "
                             "directory. Unused without --compile.")
    add_compile_arguments(parser, "one program for a frame's rectify, resize and "
                                  "forward; reduce-overhead replays it as a CUDA graph")
    return parser.parse_args(argv)


def _bgr_to_rgb(frame_bgr: np.ndarray) -> np.ndarray:
    with span("live.upload.flip"):
        return np.ascontiguousarray(frame_bgr[..., ::-1])


class LiveDepthEngine:
    """A frame's device work: upload, scale, rectify, resize, StereoUNet.

    ``process`` is the four stages in order (``upload``, ``preprocess``,
    ``forward``, ``download``); they are methods of their own so that a
    caller can time each. With ``compile`` the three after the upload run as
    one compiled program (``compile_model`` of ``_frame``); the resize
    matrices and the rectification maps are built outside it and passed in.
    With ``compile_cache`` (a directory) the program's compile artifacts are
    loaded from, and saved to, a blob there keyed by the frame setting; its
    report is ``self.compile_cache.reports``.

    Under a ``torch.profiler`` capture each stage is a span (``spans.py``):
    ``live.frame`` around ``process``, ``live.upload`` (inside it one
    ``live.upload.flip`` a view, the host's channel flip),
    ``live.preprocess``, ``live.forward``, ``live.program`` and
    ``live.download``."""

    def __init__(
        self,
        model_size: tuple[int, int],  # (W, H)
        rectifier: Rectifier | None,
        device: str | torch.device = "cuda",
        base_channels: int = 32,
        compile: CompileOptions | None = None,
        compile_cache: Path | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.model = StereoUNet(
            in_channels=6, out_channels=1, base_channels=base_channels,
            device=self.device, generator=torch.Generator().manual_seed(0),
        ).eval()
        model_device = next(self.model.parameters()).device
        if rectifier is not None and rectifier.map_l_x.device != model_device:
            raise ValueError(
                f"The rectifier's maps are on {rectifier.map_l_x.device}, the engine "
                f"runs on {model_device}."
            )
        self.model_size = model_size
        self.rectifier = rectifier
        self.uncertainty_available = False
        self.loaded_epoch = -1
        self.base_channels = base_channels
        self.compile = compile
        self._program = None if compile is None else compile_model(self._frame, compile)
        self.compile_cache_dir = None if compile is None else compile_cache
        self.compile_cache: CompileCache | None = None

    def load_checkpoint(self, checkpoint_path: Path) -> tuple[int, bool]:
        """(Re)load weights; returns (epoch, has_uncertainty_head). Every
        shape is checked before anything is copied, so a load that raises
        leaves the weights in use as they were. The weights are copied into
        the model's own tensors, which a compiled program (and its CUDA
        graph) reads, so a reload recompiles nothing."""
        meta = load_model_variables(checkpoint_path, self.model)
        self.loaded_epoch = int(meta.get("epoch", -1))
        missing = meta.get("missing_keys", [])
        unexpected = meta.get("unexpected_keys", [])
        if missing or unexpected:
            print(f"Checkpoint compatibility load: missing={missing} unexpected={unexpected}")
        self.uncertainty_available = bool(meta.get("has_uncertainty_head", True))
        return self.loaded_epoch, self.uncertainty_available

    def upload(
        self, frame_l_bgr: np.ndarray, frame_r_bgr: np.ndarray
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """BGR uint8 frames -> RGB uint8 (H, W, 3) tensors on the device; the
        channel flip is made on the host (``torch.from_numpy`` takes no
        negative strides), one view at a time."""
        with span("live.upload"):
            return tuple(
                torch.from_numpy(_bgr_to_rgb(frame)).to(self.device)
                for frame in (frame_l_bgr, frame_r_bgr)
            )

    def _inputs(self, left_u8: torch.Tensor) -> tuple:
        """The rectification maps (or None) and the resize matrices (or None)
        for captures of ``left_u8``'s size."""
        r = self.rectifier
        maps = None if r is None else (r.map_l_x, r.map_l_y, r.map_r_x, r.map_r_y)
        w, h = self.model_size
        return maps, resample_matrices(tuple(left_u8.shape[:2]), (h, w), self.device)

    @staticmethod
    def _preprocess(left_u8, right_u8, maps, matrices) -> tuple[torch.Tensor, torch.Tensor]:
        left = left_u8.to(torch.float32) * (1.0 / 255.0)
        right = right_u8.to(torch.float32) * (1.0 / 255.0)
        if maps is not None:
            left = remap_bilinear(left, maps[0], maps[1])
            right = remap_bilinear(right, maps[2], maps[3])
        return resize_bilinear_with(left, matrices), resize_bilinear_with(right, matrices)

    def _forward(self, left: torch.Tensor, right: torch.Tensor):
        disp, logvar = self.model(torch.cat([left, right], dim=-1)[None],
                                  return_uncertainty=True)
        left_view = (left.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        right_view = (right.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return disp[0, ..., 0], logvar[0, ..., 0], left_view, right_view

    def _frame(self, left_u8, right_u8, maps, matrices):
        """The compiled program: preprocess then forward."""
        return self._forward(*self._preprocess(left_u8, right_u8, maps, matrices))

    def preprocess(
        self, left_u8: torch.Tensor, right_u8: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 RGB at capture size -> float32 RGB in [0, 1] at model size:
        scaled, rectified at capture size, then resized."""
        with span("live.preprocess"):
            return self._preprocess(left_u8, right_u8, *self._inputs(left_u8))

    @torch.inference_mode()
    def forward(
        self, left: torch.Tensor, right: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Model-size views -> (disparity HW, logvar HW, the views as uint8),
        on the device. The views are truncated to uint8 as the display path
        truncates them: they exist only for the display."""
        with span("live.forward"):
            return self._forward(left, right)

    @torch.inference_mode()
    def run_compiled(self, left_u8: torch.Tensor, right_u8: torch.Tensor):
        """``preprocess`` and ``forward`` as the one compiled program. Under
        CUDA graphs its outputs are overwritten by the next call: a caller
        keeps them only by copying them first (``download`` does)."""
        with span("live.program"):
            first = self.compile_cache_dir is not None and self.compile_cache is None
            if first:  # the blob's key holds the capture size, known from here
                self.compile_cache = CompileCache(self.compile_cache_dir, cache_digest({
                    "cli": "live", "compile_mode": self.compile.mode,
                    "compile_backend": self.compile.backend,
                    "base_channels": self.base_channels,
                    "model_size": tuple(self.model_size), "capture": tuple(left_u8.shape),
                    "rectify": self.rectifier is not None,
                }, self.device), verbose=True)
                self.compile_cache.load()
                self._program = self.compile_cache.wrap(self._program, "live frame")
            out = self._program(left_u8, right_u8, *self._inputs(left_u8))
            if first:
                self.compile_cache.finish()
            return out

    @staticmethod
    def download(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
        """The frame's outputs as numpy arrays; the copy waits for the
        frame's device work."""
        with span("live.download"):
            return tuple(t.cpu().numpy() for t in tensors)

    def process(
        self, frame_l_bgr: np.ndarray, frame_r_bgr: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """BGR frames -> (disparity HW, logvar HW, rectified views as uint8 RGB)."""
        with span("live.frame"):
            frames = self.upload(frame_l_bgr, frame_r_bgr)
            if self._program is not None:
                return self.download(*self.run_compiled(*frames))
            return self.download(*self.forward(*self.preprocess(*frames)))


class CheckpointWatcher:
    """Hot reload on an mtime change; a reload that raises is skipped."""

    def __init__(self, engine: LiveDepthEngine, path: Path, poll_sec: float) -> None:
        self.engine = engine
        self.path = path
        self.poll_sec = poll_sec
        self.mtime_ns = checkpoint_mtime_ns(path)
        self.next_poll = time.time() + poll_sec

    def maybe_reload(self) -> None:
        if time.time() < self.next_poll:
            return
        try:
            new_mtime = checkpoint_mtime_ns(self.path)
            if new_mtime != self.mtime_ns:
                epoch, unc = self.engine.load_checkpoint(self.path)
                self.mtime_ns = new_mtime
                print(f"Reloaded checkpoint at epoch {epoch}.")
                print(
                    "Confidence visualization enabled from reloaded checkpoint."
                    if unc
                    else "Reloaded checkpoint has no uncertainty head; "
                         "confidence map disabled."
                )
        except Exception as exc:  # the viewer keeps running on the weights it has
            print(f"Checkpoint reload skipped: {exc}")
        self.next_poll = time.time() + self.poll_sec


def load_calibration_geometry(
    calibration_path: Path,
) -> tuple[float | None, float | None, int | None]:
    """(focal_px, baseline_m, calib_width_px) from the npz, tolerating missing
    keys."""
    if not calibration_path.exists():
        return None, None, None
    with np.load(calibration_path) as data:
        P1 = data["P1"] if "P1" in data else None
        P2 = data["P2"] if "P2" in data else None
        T = data["T"] if "T" in data else None
        image_size = data["image_size"] if "image_size" in data else None
        if P1 is not None:
            focal_px = float(P1[0, 0])
        elif "mtx_l" in data:
            focal_px = float(data["mtx_l"][0, 0])
        else:
            focal_px = None
        baseline_m = estimate_baseline_m(P1=P1, P2=P2, T=T)
        calib_width = (
            int(np.asarray(image_size).reshape(-1)[0]) if image_size is not None
            else None
        )
    if focal_px is not None and (not np.isfinite(focal_px) or focal_px <= 0.0):
        focal_px = None
    return focal_px, baseline_m, calib_width


def maybe_load_rectifier(
    calibration_path: Path, use_rectification: bool, device: str | torch.device = "cuda"
) -> Rectifier | None:
    if not use_rectification:
        return None
    if not calibration_path.exists():
        raise FileNotFoundError(
            f"Calibration file not found: {calibration_path}. "
            "Use --no-rectify or provide a valid calibration file."
        )
    with np.load(calibration_path) as data:
        return Rectifier.from_calibration(data, device)


def colorize_scalar_map(
    values_2d: np.ndarray,
    colormap_name: str,
    fixed_range: tuple[float, float] | None = None,
) -> np.ndarray:
    """Percentile- or fixed-range normalise then apply a cv2 colormap."""
    import cv2

    cmap = {
        "turbo": cv2.COLORMAP_TURBO,
        "inferno": cv2.COLORMAP_INFERNO,
        "magma": cv2.COLORMAP_MAGMA,
        "viridis": cv2.COLORMAP_VIRIDIS,
    }[colormap_name]
    valid = np.isfinite(values_2d) & (values_2d > 0.0)
    if not np.any(valid):
        normalized = np.zeros(values_2d.shape, dtype=np.uint8)
    else:
        if fixed_range is None:
            values = values_2d[valid]
            lo = float(np.percentile(values, 2))
            hi = float(np.percentile(values, 98))
        else:
            lo, hi = fixed_range
        scale = max(hi - lo, 1e-6)
        normalized_float = np.clip((values_2d - lo) / scale, 0.0, 1.0)
        normalized = (normalized_float * 255.0).astype(np.uint8)
        normalized[~valid] = 0
    return cv2.applyColorMap(normalized, cmap)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    if not 0.0 <= args.ema_alpha <= 1.0:
        raise ValueError("--ema-alpha must be in [0, 1].")
    device = resolve_cli_device(args.device)

    model_size = (args.model_width, args.model_height)
    checkpoint_path = resolve_checkpoint_path(
        args.output_dir,
        checkpoint=args.checkpoint,
        run_id=args.run_id,
        checkpoint_name=args.checkpoint_name,
    )

    calibration_focal_px, calibration_baseline_m, calibration_width_px = (
        load_calibration_geometry(args.calibration)
    )
    rectifier = maybe_load_rectifier(
        args.calibration, use_rectification=not args.no_rectify, device=device
    )
    if rectifier is not None:
        calibration_focal_px = rectifier.focal_length_px
        calibration_baseline_m = rectifier.baseline_m
        calibration_width_px = rectifier.image_size[0]

    focal_length_px_model = None
    if (
        calibration_focal_px is not None
        and calibration_width_px is not None
        and calibration_width_px > 0
    ):
        focal_length_px_model = scale_focal_to_model(
            calibration_focal_px, calibration_width_px, args.model_width
        )
    baseline_m = calibration_baseline_m
    depth_enabled = baseline_m is not None and focal_length_px_model is not None

    options = compile_options_from(args)
    engine = LiveDepthEngine(
        model_size, rectifier, device, base_channels=args.base_channels, compile=options,
        compile_cache=resolve_aot_dir(args.aot_cache, args.output_dir),
    )
    loaded_epoch, uncertainty_available = engine.load_checkpoint(checkpoint_path)
    watcher = (
        CheckpointWatcher(engine, checkpoint_path, args.checkpoint_poll_sec)
        if args.watch_checkpoint
        else None
    )

    print(f"Model checkpoint: {checkpoint_path}")
    if loaded_epoch >= 0:
        print(f"Loaded epoch: {loaded_epoch}")
    print(
        "Confidence visualization enabled from checkpoint uncertainty head."
        if uncertainty_available
        else "Checkpoint does not include trained uncertainty head; "
             "confidence map disabled."
    )
    if depth_enabled:
        print(
            "Depth conversion enabled: "
            f"baseline={baseline_m:.6f} m, "
            f"focal_calib={calibration_focal_px:.2f} px, "
            f"focal_model={focal_length_px_model:.2f} px"
        )
        if rectifier is None:
            print(
                "Warning: running without rectification. Depth may be "
                "inaccurate unless inputs are pre-rectified."
            )
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Running live DL depth on {device} ({name}). Press q or Esc to quit.")

    source: FrameSource
    if args.input_dir is not None:
        source = directory_source(args.input_dir)
    else:
        if args.left is None or args.right is None:
            raise SystemExit("Provide --left/--right camera indices or --input-dir.")
        settings = CaptureSettings(
            width=args.width, height=args.height, fps=args.fps, fourcc=args.fourcc,
            buffer_size=args.buffer_size, warmup_frames=args.warmup_frames,
            drop_frames=args.drop_frames,
        )
        source = camera_source(args.left, args.right, settings)

    if args.headless:
        args.headless_output.mkdir(parents=True, exist_ok=True)
    else:
        import cv2  # GUI needed  # noqa: F401

    smoothed: np.ndarray | None = None
    previous_time = time.time()

    for frame_index, (frame_l, frame_r) in enumerate(source):
        if args.max_frames and frame_index >= args.max_frames:
            break
        if rectifier is not None:
            expected = rectifier.image_size
            left_size = (frame_l.shape[1], frame_l.shape[0])
            right_size = (frame_r.shape[1], frame_r.shape[0])
            if left_size != expected or right_size != expected:
                raise RuntimeError(
                    f"Capture size mismatch. Expected calibration size={expected}, "
                    f"left={left_size}, right={right_size}."
                )
        if watcher is not None:
            watcher.maybe_reload()
            uncertainty_available = engine.uncertainty_available
            loaded_epoch = engine.loaded_epoch

        prediction, logvar, left_model_rgb, right_model_rgb = engine.process(frame_l, frame_r)

        if args.ema_alpha > 0.0:
            smoothed = (
                prediction if smoothed is None
                else args.ema_alpha * prediction + (1.0 - args.ema_alpha) * smoothed
            )
            disparity = smoothed
        else:
            disparity = prediction

        center_disparity = center_patch_median(disparity, args.center_window)
        if depth_enabled:
            depth_m = disparity_to_depth_np(
                disparity, float(focal_length_px_model), float(baseline_m)
            )
            center_depth_m = center_patch_median(depth_m, args.center_window)
            vis_map, vis_title = depth_m, "DL Depth (m)"
        else:
            depth_m = None
            center_depth_m = float("nan")
            vis_map, vis_title = disparity, "DL Disparity"

        center_confidence = float("nan")
        confidence_map = None
        if uncertainty_available:
            confidence_map = confidence_from_logvar_np(logvar)
            center_confidence = center_patch_median(confidence_map, args.center_window)

        now = time.time()
        fps = 1.0 / max(now - previous_time, 1e-6)
        previous_time = now

        if args.headless:
            _write_headless_outputs(
                args.headless_output, frame_index, args.colormap, vis_map,
                depth_enabled, confidence_map, center_disparity, center_depth_m,
                center_confidence, fps, loaded_epoch,
            )
            continue

        _render_windows(
            args, frame_l, depth_m, vis_map, vis_title, confidence_map,
            center_disparity, center_depth_m, center_confidence, fps,
            loaded_epoch, uncertainty_available, rectifier, frame_r, disparity,
            left_model_rgb, right_model_rgb,
        )
        import cv2

        key = cv2.waitKey(1) & 0xFF
        if key in (ord("q"), 27):
            break

    if not args.headless:
        import cv2

        cv2.destroyAllWindows()


def _write_headless_outputs(
    out_dir: Path, frame_index: int, colormap: str, vis_map, depth_enabled,
    confidence_map, center_disparity, center_depth_m, center_confidence, fps,
    loaded_epoch,
) -> None:
    import cv2

    vis = colorize_scalar_map(
        vis_map, colormap, fixed_range=DEPTH_VIS_RANGE_M if depth_enabled else None
    )
    cv2.imwrite(str(out_dir / f"depth_{frame_index:05d}.png"), vis)
    if confidence_map is not None:
        conf_vis = colorize_scalar_map(
            confidence_map, "viridis", fixed_range=CONFIDENCE_VIS_RANGE
        )
        cv2.imwrite(str(out_dir / f"confidence_{frame_index:05d}.png"), conf_vis)
    (out_dir / f"readout_{frame_index:05d}.json").write_text(
        json.dumps(
            {
                "center_disparity": _json_float(center_disparity),
                "center_depth_m": _json_float(center_depth_m),
                "center_confidence": _json_float(center_confidence),
                "fps": fps,
                "checkpoint_epoch": loaded_epoch,
            }
        )
    )


def _json_float(value: float) -> float | None:
    return float(value) if np.isfinite(value) else None


def _model_rgb_to_display_bgr(model_rgb: np.ndarray, capture_hw) -> np.ndarray:
    """(H,W,3) RGB model-space view (uint8 or float) -> capture-size BGR uint8."""
    import cv2

    if model_rgb.dtype == np.uint8:
        u8 = model_rgb[..., ::-1]
    else:
        u8 = (np.clip(model_rgb, 0.0, 1.0) * 255.0).astype(np.uint8)[..., ::-1]
    return cv2.resize(u8, (capture_hw[1], capture_hw[0]), interpolation=cv2.INTER_LINEAR)


def _render_windows(
    args, frame_l, depth_m, vis_map, vis_title, confidence_map,
    center_disparity, center_depth_m, center_confidence, fps, loaded_epoch,
    uncertainty_available, rectifier, frame_r, disparity,
    left_model_rgb, right_model_rgb,
) -> None:
    import cv2

    # With rectification on, show the rectified views the model consumed:
    # the contours are computed in rectified space and would be misaligned
    # on the raw frames.
    if rectifier is not None:
        view_l = _model_rgb_to_display_bgr(left_model_rgb, frame_l.shape[:2])
        view_r = _model_rgb_to_display_bgr(right_model_rgb, frame_r.shape[:2])
    else:
        view_l = frame_l
        view_r = frame_r
    if depth_m is not None:
        contour_mask = depth_contour_mask(
            depth_m, DEPTH_CONTOUR_STEP_M, DEPTH_VIS_RANGE_M[0], DEPTH_VIS_RANGE_M[1]
        )
        contour_mask = cv2.resize(
            contour_mask, (frame_l.shape[1], frame_l.shape[0]),
            interpolation=cv2.INTER_NEAREST,
        )
        view_l = view_l.copy() if view_l is frame_l else view_l
        view_l[contour_mask > 0] = DEPTH_CONTOUR_COLOR_BGR

    depth_vis = colorize_scalar_map(
        vis_map, args.colormap,
        fixed_range=DEPTH_VIS_RANGE_M if depth_m is not None else None,
    )
    depth_vis = cv2.resize(
        depth_vis, (frame_l.shape[1], frame_l.shape[0]), interpolation=cv2.INTER_LINEAR,
    )
    h, w = disparity.shape
    marker = (
        int(w // 2 * frame_l.shape[1] / max(w, 1)),
        int(h // 2 * frame_l.shape[0] / max(h, 1)),
    )
    cv2.drawMarker(depth_vis, marker, (255, 255, 255), cv2.MARKER_CROSS, 18, 2)

    readout = (
        f"center disparity: {center_disparity:.3f}"
        if np.isfinite(center_disparity) else "center disparity: n/a"
    )
    if depth_m is not None:
        readout += (
            f" | center depth: {center_depth_m:.3f} m"
            if np.isfinite(center_depth_m) else " | center depth: n/a"
        )
    info = f"fps: {fps:.1f} | model: {args.model_width}x{args.model_height}"
    if uncertainty_available and np.isfinite(center_confidence):
        info += f" | conf: {center_confidence:.3f}"
    epoch_text = f"checkpoint epoch: {loaded_epoch if loaded_epoch >= 0 else 'unknown'}"
    for text, y, size in ((readout, 30, 0.75), (info, 60, 0.65), (epoch_text, 90, 0.65)):
        cv2.putText(depth_vis, text, (15, y), cv2.FONT_HERSHEY_SIMPLEX, size,
                    (255, 255, 255), 2)

    cv2.imshow("Left Camera (Rectified)" if rectifier is not None else "Left Camera", view_l)
    cv2.imshow(
        "Right Camera (Rectified)" if rectifier is not None else "Right Camera", view_r,
    )
    cv2.imshow(vis_title, depth_vis)

    if uncertainty_available and confidence_map is not None:
        conf_vis = colorize_scalar_map(
            confidence_map, "viridis", fixed_range=CONFIDENCE_VIS_RANGE
        )
        conf_vis = cv2.resize(
            conf_vis, (frame_l.shape[1], frame_l.shape[0]), interpolation=cv2.INTER_LINEAR,
        )
        conf_text = (
            f"center confidence: {center_confidence:.3f}"
            if np.isfinite(center_confidence) else "center confidence: n/a"
        )
        for text, y, size in ((conf_text, 30, 0.75), (info, 60, 0.65),
                              (epoch_text, 90, 0.65)):
            cv2.putText(conf_vis, text, (15, y), cv2.FONT_HERSHEY_SIMPLEX, size,
                        (255, 255, 255), 2)
        cv2.imshow("DL Confidence", conf_vis)
    else:
        try:
            cv2.destroyWindow("DL Confidence")
        except cv2.error:
            pass


if __name__ == "__main__":
    main()
