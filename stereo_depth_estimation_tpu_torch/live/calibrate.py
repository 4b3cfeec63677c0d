"""``foundation-stereo-calibrate``: chessboard calibration for a stereo rig.

Counterpart of ``stereo_depth_estimation_tpu/live/calibrate.py`` (OpenCV and
numpy on the host, copied so that the port imports nothing of the JAX
package):

    python -m stereo_depth_estimation_tpu_torch.live.calibrate \
        --image-dir <pairs> --square-size 0.025

Writes the ``.npz`` geometry bundle every live tool reads: intrinsics,
distortion, stereo extrinsics, rectification transforms and the
reprojection matrix Q, with the reference calibration artifact's keys.
Rig mode (``--left``/``--right``) previews detections and banks one on
Space; file mode (``--image-dir``) scans stored ``left_*``/``right_*``
pairs. The solve is OpenCV's ladder: per-camera intrinsics, then
``stereoCalibrate`` with the intrinsics fixed, then ``stereoRectify`` with
zero disparity at infinity.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

import numpy as np

from .camera_setup import CaptureSettings, StereoRig
from .io_sources import iter_stereo_pair_paths

# findChessboardCorners emits corners row-major from one fixed board corner;
# the solver only needs a consistent object-point grid in the same order.
_SUBPIX_WINDOW = (11, 11)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "Solve stereo rig geometry from chessboard views and write the "
            "calibration .npz used by the depth viewers."
        )
    )
    src = parser.add_argument_group("acquisition")
    src.add_argument("--left", type=int, default=None,
                     help="Video index of the left camera (rig mode).")
    src.add_argument("--right", type=int, default=None,
                     help="Video index of the right camera (rig mode).")
    src.add_argument("--image-dir", type=Path, default=None,
                     help="Read stored left_*/right_* pairs from this "
                          "directory instead of opening cameras.")
    src.add_argument("--samples", type=int, default=25,
                     help="Stop after this many banked detections.")
    src.add_argument("--min-pairs", type=int, default=8,
                     help="Refuse to solve with fewer detections than this.")

    board = parser.add_argument_group("chessboard")
    board.add_argument("--rows", type=int, default=6,
                       help="Inner-corner count along the short board edge.")
    board.add_argument("--cols", type=int, default=9,
                       help="Inner-corner count along the long board edge.")
    board.add_argument("--square-size", type=float, required=True,
                       help="Edge length of one board square, in meters.")

    cam = parser.add_argument_group("capture mode (rig mode only)")
    cam.add_argument("--width", type=int, default=640)
    cam.add_argument("--height", type=int, default=480)
    cam.add_argument("--fps", type=int, default=15)
    cam.add_argument("--fourcc", type=str, default="MJPG",
                     help="4-char pixel format tag to request.")
    cam.add_argument("--buffer-size", type=int, default=1)
    cam.add_argument("--warmup-frames", type=int, default=20)
    cam.add_argument("--drop-frames", type=int, default=1)

    parser.add_argument("--output", type=Path,
                        default=Path("calibration/stereo_calib.npz"),
                        help="Where to write the geometry bundle.")
    return parser


def board_object_points(rows: int, cols: int, square_size: float) -> np.ndarray:
    """World-frame corner coordinates of the board, z=0 plane, meters."""
    xy = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2).astype(np.float32)
    pts = np.concatenate([xy, np.zeros((rows * cols, 1), np.float32)], axis=1)
    return pts * square_size


def _solver_criteria():
    import cv2

    return (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 60, 1e-6)


def detect_board(gray: np.ndarray, pattern_size: tuple[int, int]):
    """Chessboard detection + sub-pixel refinement. Returns None on miss."""
    import cv2

    ok, corners = cv2.findChessboardCorners(gray, pattern_size, None)
    if not ok:
        return None
    return cv2.cornerSubPix(
        gray, corners, _SUBPIX_WINDOW, (-1, -1), _solver_criteria()
    )


class DetectionBank:
    """Accumulates matched left/right corner detections."""

    def __init__(self) -> None:
        self.left: list[np.ndarray] = []
        self.right: list[np.ndarray] = []
        self.image_size: tuple[int, int] | None = None

    def add(self, corners_l, corners_r, image_size) -> None:
        self.left.append(corners_l)
        self.right.append(corners_r)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.left)


def bank_from_files(
    image_dir: Path, pattern_size: tuple[int, int], limit: int
) -> DetectionBank:
    import cv2

    bank = DetectionBank()
    for left_path, right_path in iter_stereo_pair_paths(image_dir):
        if len(bank) >= limit:
            break
        gray_l = cv2.imread(str(left_path), cv2.IMREAD_GRAYSCALE)
        gray_r = cv2.imread(str(right_path), cv2.IMREAD_GRAYSCALE)
        if gray_l is None or gray_r is None:
            continue
        corners_l = detect_board(gray_l, pattern_size)
        corners_r = detect_board(gray_r, pattern_size)
        if corners_l is None or corners_r is None:
            print(f"  no board in {left_path.name} / {right_path.name}")
            continue
        bank.add(corners_l, corners_r, gray_l.shape[::-1])
        print(f"  banked {left_path.name} ({len(bank)}/{limit})")
    return bank


def bank_from_rig(
    args: argparse.Namespace, pattern_size: tuple[int, int]
) -> DetectionBank:
    import cv2

    settings = CaptureSettings(
        width=args.width, height=args.height, fps=args.fps,
        fourcc=args.fourcc, buffer_size=args.buffer_size,
        warmup_frames=args.warmup_frames, drop_frames=args.drop_frames,
    )
    bank = DetectionBank()
    window = "calibrate: Space=bank detection, Q/Esc=stop"
    with StereoRig(args.left, args.right, settings) as rig:
        print(rig.describe())
        rig.warmup()
        print(
            f"Show the {args.cols}x{args.rows} board to both cameras; "
            f"collecting up to {args.samples} detections."
        )
        while len(bank) < args.samples:
            ok, frame_l, frame_r = rig.read_pair()
            if not ok:
                continue
            if frame_l.shape != frame_r.shape:
                raise RuntimeError(
                    f"Left/right frames disagree in shape ({frame_l.shape} vs "
                    f"{frame_r.shape}); force both cameras into one mode."
                )
            gray_l = cv2.cvtColor(frame_l, cv2.COLOR_BGR2GRAY)
            gray_r = cv2.cvtColor(frame_r, cv2.COLOR_BGR2GRAY)
            corners_l = detect_board(gray_l, pattern_size)
            corners_r = detect_board(gray_r, pattern_size)

            preview = np.hstack([frame_l, frame_r])
            for corners, x_off in ((corners_l, 0), (corners_r, frame_l.shape[1])):
                if corners is not None:
                    shifted = corners + np.array([x_off, 0], np.float32)
                    cv2.drawChessboardCorners(
                        preview[:, :], pattern_size, shifted, True
                    )
            cv2.putText(
                preview,
                f"{len(bank)}/{args.samples} banked"
                + ("  [board visible]" if corners_l is not None and corners_r is not None else ""),
                (12, 28), cv2.FONT_HERSHEY_SIMPLEX, 0.75, (60, 220, 60), 2,
            )
            cv2.imshow(window, preview)
            key = cv2.waitKey(1) & 0xFF
            if key in (ord("q"), 27):
                break
            if key == ord(" ") and corners_l is not None and corners_r is not None:
                bank.add(corners_l, corners_r, gray_l.shape[::-1])
                print(f"  banked detection {len(bank)}/{args.samples}")
    cv2.destroyAllWindows()
    return bank


def solve_rig_geometry(
    object_points: np.ndarray, bank: DetectionBank
) -> dict[str, Any]:
    """OpenCV calibration ladder -> geometry bundle dict (npz-ready)."""
    import cv2

    assert bank.image_size is not None
    world = [object_points.copy() for _ in range(len(bank))]
    none: Any = None
    criteria = _solver_criteria()

    rms_l, mtx_l, dist_l, _, _ = cv2.calibrateCamera(
        world, bank.left, bank.image_size, none, none
    )
    rms_r, mtx_r, dist_r, _, _ = cv2.calibrateCamera(
        world, bank.right, bank.image_size, none, none
    )
    print(f"Intrinsics solved (reproj RMS: L={rms_l:.4f} R={rms_r:.4f})")

    rms_stereo, _, _, _, _, R, T, E, F = cv2.stereoCalibrate(
        world, bank.left, bank.right,
        mtx_l, dist_l, mtx_r, dist_r, bank.image_size,
        criteria=criteria, flags=cv2.CALIB_FIX_INTRINSIC,
    )
    print(f"Extrinsics solved (stereo reproj RMS: {rms_stereo:.4f})")

    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        mtx_l, dist_l, mtx_r, dist_r, bank.image_size, R, T,
        flags=cv2.CALIB_ZERO_DISPARITY,
    )
    baseline_m = float(np.linalg.norm(T))
    print(f"Rig baseline: {baseline_m * 1000:.1f} mm, "
          f"focal: {P1[0, 0]:.1f} px (rectified)")

    # Same key set as the reference artifact so bundles interoperate.
    return {
        "image_size": np.array(bank.image_size),
        "mtx_l": mtx_l, "dist_l": dist_l, "mtx_r": mtx_r, "dist_r": dist_r,
        "R": R, "T": T, "E": E, "F": F,
        "R1": R1, "R2": R2, "P1": P1, "P2": P2, "Q": Q,
        "stereo_rms": np.array(rms_stereo),
        "mono_rms_l": np.array(rms_l),
        "mono_rms_r": np.array(rms_r),
    }


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    pattern_size = (args.cols, args.rows)
    object_points = board_object_points(args.rows, args.cols, args.square_size)

    if args.image_dir is not None:
        bank = bank_from_files(args.image_dir, pattern_size, args.samples)
    elif args.left is not None and args.right is not None:
        bank = bank_from_rig(args, pattern_size)
    else:
        raise SystemExit(
            "Nothing to calibrate from: pass --image-dir, or both "
            "--left and --right."
        )

    if len(bank) < args.min_pairs:
        raise RuntimeError(
            f"Only {len(bank)} usable detections (< --min-pairs="
            f"{args.min_pairs}); the solve would be unstable."
        )

    bundle = solve_rig_geometry(object_points, bank)
    bundle.update(
        rows=np.array(args.rows),
        cols=np.array(args.cols),
        square_size=np.array(args.square_size),
    )
    args.output.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.output, **bundle)
    print(f"Geometry bundle written: {args.output}")


if __name__ == "__main__":
    main()
