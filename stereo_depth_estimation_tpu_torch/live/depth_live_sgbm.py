"""``foundation-stereo-sgbm-live``: classical block-matching depth viewer.

Counterpart of ``stereo_depth_estimation_tpu/live/depth_live_sgbm.py`` (OpenCV
and numpy on the host, copied so that the port imports nothing of the JAX
package):

    python -m stereo_depth_estimation_tpu_torch.live.depth_live_sgbm \
        --input-dir <frames> --headless --calibration <npz>

The non-learned comparator for the DL viewer: rectify with the calibration
bundle, run OpenCV's semi-global matcher (P1/P2 = 8/32 * blockSize^2, 3-way
mode, /16 fixed-point output), reproject through Q to metric depth, and
report the median distance of the central patch. Runs on cameras, or on
stored frame pairs with ``--input-dir`` (``--headless`` writes PNG and JSON
files in place of windows).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from ..ops.geometry import center_patch_median
from .camera_setup import CaptureSettings
from .io_sources import FrameSource, camera_source, directory_source


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Classical (SGBM) stereo depth viewer — the non-learned "
                    "baseline for the DL viewer."
    )
    parser.add_argument("--left", type=int, default=None,
                        help="Video index of the left camera.")
    parser.add_argument("--right", type=int, default=None,
                        help="Video index of the right camera.")
    parser.add_argument("--input-dir", type=Path, default=None,
                        help="Run on stored left_*/right_* pairs instead of "
                             "cameras.")
    parser.add_argument("--headless", action="store_true",
                        help="Write results to --output-dir instead of "
                             "opening windows.")
    parser.add_argument("--output-dir", type=Path, default=Path("sgbm_out"),
                        help="Artifact directory for --headless.")
    parser.add_argument("--calibration", type=Path,
                        default=Path("calibration/stereo_calib.npz"),
                        help="Geometry bundle from the calibrate CLI.")
    cam = parser.add_argument_group("capture mode")
    cam.add_argument("--width", type=int, default=640)
    cam.add_argument("--height", type=int, default=480)
    cam.add_argument("--fps", type=int, default=30)
    cam.add_argument("--fourcc", type=str, default="MJPG",
                     help="4-char pixel format tag to request.")
    cam.add_argument("--buffer-size", type=int, default=1)
    cam.add_argument("--warmup-frames", type=int, default=20)
    cam.add_argument("--drop-frames", type=int, default=1)
    sgbm = parser.add_argument_group("matcher")
    sgbm.add_argument("--min-disparity", type=int, default=0)
    sgbm.add_argument("--num-disparities", type=int, default=128,
                      help="Disparity search range; OpenCV requires a "
                           "multiple of 16.")
    sgbm.add_argument("--block-size", type=int, default=7,
                      help="Matching window edge; odd, >= 3.")
    parser.add_argument("--center-window", type=int, default=15,
                        help="Edge of the central patch used for the "
                             "distance readout.")
    return parser


@dataclass
class SgbmPipeline:
    """Calibration-bound rectify -> match -> reproject pipeline."""

    rectify_maps: tuple[Any, Any]
    matcher: Any
    q_matrix: np.ndarray
    image_size: tuple[int, int]

    @classmethod
    def from_bundle(
        cls, bundle_path: Path, min_disp: int, num_disp: int, block_size: int
    ) -> "SgbmPipeline":
        import cv2

        if num_disp % 16 != 0:
            raise ValueError(
                f"--num-disparities must be a multiple of 16 (got {num_disp})."
            )
        if block_size < 3 or block_size % 2 == 0:
            raise ValueError(
                f"--block-size must be odd and >= 3 (got {block_size})."
            )
        if not bundle_path.exists():
            raise FileNotFoundError(
                f"No calibration bundle at {bundle_path}; run "
                "the calibrate CLI first."
            )
        geo = np.load(bundle_path)
        size = (int(geo["image_size"][0]), int(geo["image_size"][1]))
        maps = tuple(
            cv2.initUndistortRectifyMap(
                geo[f"mtx_{side}"], geo[f"dist_{side}"],
                geo[f"R{i}"], geo[f"P{i}"], size, cv2.CV_16SC2,
            )
            for i, side in ((1, "l"), (2, "r"))
        )
        # OpenCV's documented SGBM recipe: smoothness penalties scale with
        # the squared window, 3-way DP for speed.
        matcher = cv2.StereoSGBM.create(
            minDisparity=min_disp,
            numDisparities=num_disp,
            blockSize=block_size,
            P1=8 * block_size * block_size,
            P2=32 * block_size * block_size,
            disp12MaxDiff=1,
            uniquenessRatio=10,
            speckleWindowSize=100,
            speckleRange=2,
            preFilterCap=31,
            mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY,
        )
        return cls(maps, matcher, geo["Q"], size)

    def check_frame_size(self, frame_l, frame_r) -> None:
        got = (frame_l.shape[1], frame_l.shape[0]), (frame_r.shape[1], frame_r.shape[0])
        if got[0] != self.image_size or got[1] != self.image_size:
            raise RuntimeError(
                f"Frames are {got[0]}/{got[1]} but the calibration bundle is "
                f"for {self.image_size}; recalibrate or change capture mode."
            )

    def __call__(self, frame_l, frame_r, center_window: int):
        """Returns (rect_l, rect_r, disparity, depth_z, center_depth_m)."""
        import cv2

        rect_l = cv2.remap(frame_l, *self.rectify_maps[0], cv2.INTER_LINEAR)
        rect_r = cv2.remap(frame_r, *self.rectify_maps[1], cv2.INTER_LINEAR)
        disparity = self.matcher.compute(
            cv2.cvtColor(rect_l, cv2.COLOR_BGR2GRAY),
            cv2.cvtColor(rect_r, cv2.COLOR_BGR2GRAY),
        ).astype(np.float32) / 16.0  # SGBM emits 4-bit fixed point
        disparity[disparity <= 0.0] = np.nan

        xyz = cv2.reprojectImageTo3D(np.nan_to_num(disparity, nan=0.0), self.q_matrix)
        depth_z = xyz[..., 2]
        depth_z[~np.isfinite(disparity)] = np.nan
        return rect_l, rect_r, disparity, depth_z, center_patch_median(
            depth_z, center_window
        )


def disparity_panel(disparity: np.ndarray, center_depth_m: float) -> np.ndarray:
    """Colorized disparity with crosshair + center-distance annotation."""
    import cv2

    filled = np.nan_to_num(disparity, nan=0.0)
    u8 = cv2.normalize(filled, np.empty_like(filled), 0, 255,
                       cv2.NORM_MINMAX).astype(np.uint8)
    panel = cv2.applyColorMap(u8, cv2.COLORMAP_TURBO)
    h, w = disparity.shape
    cv2.drawMarker(panel, (w // 2, h // 2), (255, 255, 255),
                   cv2.MARKER_CROSS, 18, 2)
    label = (f"{center_depth_m:.2f} m at center"
             if np.isfinite(center_depth_m) else "no depth at center")
    cv2.putText(panel, label, (12, 28), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (255, 255, 255), 2)
    return panel


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    pipeline = SgbmPipeline.from_bundle(
        args.calibration, args.min_disparity, args.num_disparities,
        args.block_size,
    )

    source: FrameSource
    if args.input_dir is not None:
        source = directory_source(args.input_dir)
    elif args.left is not None and args.right is not None:
        source = camera_source(
            args.left, args.right,
            CaptureSettings(
                width=args.width, height=args.height, fps=args.fps,
                fourcc=args.fourcc, buffer_size=args.buffer_size,
                warmup_frames=args.warmup_frames, drop_frames=args.drop_frames,
            ),
        )
    else:
        raise SystemExit(
            "No frame source: pass --input-dir, or both --left and --right."
        )

    if args.headless:
        args.output_dir.mkdir(parents=True, exist_ok=True)
    else:
        import cv2

    for index, (frame_l, frame_r) in enumerate(source):
        pipeline.check_frame_size(frame_l, frame_r)
        rect_l, rect_r, disparity, _z, center_m = pipeline(
            frame_l, frame_r, args.center_window
        )
        panel = disparity_panel(disparity, center_m)

        if args.headless:
            import cv2

            cv2.imwrite(str(args.output_dir / f"disparity_{index:05d}.png"), panel)
            (args.output_dir / f"readout_{index:05d}.json").write_text(
                json.dumps({
                    "center_depth_m": float(center_m)
                    if np.isfinite(center_m) else None
                })
            )
            continue

        cv2.imshow("SGBM left (rectified)", rect_l)
        cv2.imshow("SGBM right (rectified)", rect_r)
        cv2.imshow("SGBM disparity", panel)
        if (cv2.waitKey(1) & 0xFF) in (ord("q"), 27):
            break

    if not args.headless:
        import cv2

        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
