"""Frame sources for the live viewers: cameras or stored image pairs.

Counterpart of ``stereo_depth_estimation_tpu/live/io_sources.py``. The camera
path drives a :class:`~.camera_setup.StereoRig`; the directory path iterates
``left_*`` / ``right_*`` pairs, so every viewer runs headless without
cameras.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from .camera_setup import CaptureSettings, StereoRig

FrameSource = Iterator[tuple[np.ndarray, np.ndarray]]

_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def camera_source(
    left_index: int, right_index: int, settings: CaptureSettings
) -> FrameSource:
    with StereoRig(left_index, right_index, settings) as rig:
        print(rig.describe())
        rig.warmup()
        while True:
            ok, frame_l, frame_r = rig.read_pair()
            if not ok:
                continue
            yield frame_l, frame_r


def iter_stereo_pair_paths(input_dir: Path) -> Iterator[tuple[Path, Path]]:
    """Matched (left_path, right_path) pairs under a directory, by the
    ``left*``/``right*`` stem convention."""
    lefts = sorted(
        p
        for p in Path(input_dir).iterdir()
        if p.name.startswith("left") and p.suffix.lower() in _IMAGE_SUFFIXES
    )
    if not lefts:
        raise FileNotFoundError(f"No left_* frames found in {input_dir}")
    for left_path in lefts:
        right_path = left_path.with_name(left_path.name.replace("left", "right", 1))
        if right_path.exists():
            yield left_path, right_path


def directory_source(input_dir: Path) -> FrameSource:
    """Yield BGR pairs from left_*.{png,jpg} / right_*.{png,jpg} files."""
    import cv2

    for left_path, right_path in iter_stereo_pair_paths(input_dir):
        frame_l = cv2.imread(str(left_path), cv2.IMREAD_COLOR)
        frame_r = cv2.imread(str(right_path), cv2.IMREAD_COLOR)
        if frame_l is None or frame_r is None:
            continue
        yield frame_l, frame_r
