"""Stereo webcam plumbing: open, configure and synchronise a pair of UVC
captures.

Counterpart of ``stereo_depth_estimation_tpu/live/camera_setup.py`` (host-side
OpenCV only, copied so that the port imports nothing of the JAX package).
:class:`StereoRig` owns both ``cv2.VideoCapture`` handles and hands the
viewers synchronised ``(left, right)`` BGR frames: it pins pixel format,
frame size, frame rate, capture queue depth and focus on each capture,
discards startup frames, and skims queued frames before each read so the
pair stays fresh. ``cv2`` is imported inside the functions that use it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable


@dataclass(frozen=True)
class CaptureSettings:
    """Requested capture mode for one (or both) cameras of a rig.

    ``focus_value`` is a raw UVC focus target; most webcams treat 0 as
    focus-at-infinity, which suits a fixed stereo rig. Exposure and white
    balance are deliberately left in the camera's automatic modes — locking
    them is firmware-specific and the depth nets tolerate exposure drift.
    """

    width: int
    height: int
    fps: int
    fourcc: str = "MJPG"
    buffer_size: int = 1
    warmup_frames: int = 20
    drop_frames: int = 1
    focus_value: float = 0.0


def fourcc_int(code: str) -> int:
    """Pack a 4-character pixel-format tag into its integer FOURCC."""
    if len(code) != 4:
        raise ValueError(f"FOURCC tag must be 4 characters, got {code!r}")
    import cv2

    pack = getattr(cv2, "VideoWriter_fourcc", None) or cv2.VideoWriter.fourcc
    return int(pack(*code.upper()))


def fourcc_str(value: float) -> str:
    """Unpack an integer FOURCC (as floats returned by ``cap.get``)."""
    code = int(value)
    return bytes((code >> shift) & 0xFF for shift in (0, 8, 16, 24)).decode(
        "latin-1"
    )


def _capture_plan(settings: CaptureSettings) -> list[tuple[int, float]]:
    """Ordered (property, value) writes that realise ``settings`` on a UVC
    capture. Order matters: format before geometry, automation last."""
    import cv2

    return [
        (cv2.CAP_PROP_FOURCC, float(fourcc_int(settings.fourcc))),
        (cv2.CAP_PROP_FRAME_WIDTH, float(settings.width)),
        (cv2.CAP_PROP_FRAME_HEIGHT, float(settings.height)),
        (cv2.CAP_PROP_FPS, float(settings.fps)),
        (cv2.CAP_PROP_BUFFERSIZE, float(settings.buffer_size)),
        (cv2.CAP_PROP_AUTO_EXPOSURE, 3.0),  # the camera's automatic exposure
        (cv2.CAP_PROP_AUTO_WB, 1.0),  # the camera's automatic white balance
        (cv2.CAP_PROP_AUTOFOCUS, 0.0),  # fixed-geometry rig: no hunting
        (cv2.CAP_PROP_FOCUS, settings.focus_value),
    ]


def apply_capture_settings(cap: Any, settings: CaptureSettings) -> None:
    for prop, value in _capture_plan(settings):
        cap.set(prop, value)


def describe_capture(cap: Any) -> str:
    """One-line summary of the mode the camera actually granted."""
    import cv2

    return (
        f"{int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))}x"
        f"{int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))}"
        f" @ {cap.get(cv2.CAP_PROP_FPS):.1f} fps"
        f" [{fourcc_str(cap.get(cv2.CAP_PROP_FOURCC))}]"
    )


def _skim(captures: Iterable[Any], count: int) -> None:
    """Pull ``count`` frames off each capture's queue without decoding them."""
    for _ in range(max(0, count)):
        for cap in captures:
            cap.grab()


class StereoRig:
    """A pair of configured captures with freshness management.

    ``read_pair`` skims ``drop_frames`` stale frames off both queues first,
    so the returned pair reflects "now" rather than whatever the capture queue
    buffered — essential for stereo, where left/right skew breaks matching.
    """

    def __init__(self, left_index: int, right_index: int, settings: CaptureSettings):
        import cv2

        self.settings = settings
        self.left = cv2.VideoCapture(left_index)
        self.right = cv2.VideoCapture(right_index)
        for cap in (self.left, self.right):
            apply_capture_settings(cap, settings)
        if not (self.left.isOpened() and self.right.isOpened()):
            self.release()
            raise RuntimeError(
                f"Failed to open stereo rig (left=#{left_index}, "
                f"right=#{right_index}); probe indices with "
                "python -m stereo_depth_estimation_tpu_torch.live.list_cameras."
            )

    def describe(self) -> str:
        return (
            f"left: {describe_capture(self.left)} | "
            f"right: {describe_capture(self.right)}"
        )

    def warmup(self) -> None:
        """Discard startup frames so auto-exposure settles before use."""
        _skim((self.left, self.right), self.settings.warmup_frames)

    def read_pair(self):
        """(ok, left_frame, right_frame); ok is False on either read failing."""
        _skim((self.left, self.right), self.settings.drop_frames)
        ok_l, frame_l = self.left.read()
        ok_r, frame_r = self.right.read()
        return (ok_l and ok_r), frame_l, frame_r

    def release(self) -> None:
        for cap in (self.left, self.right):
            try:
                cap.release()
            except Exception:
                pass

    def __enter__(self) -> "StereoRig":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
