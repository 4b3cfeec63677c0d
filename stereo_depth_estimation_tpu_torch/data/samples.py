"""Sample discovery and seeded train/val splitting.

Counterpart of ``stereo_depth_estimation_tpu/data/samples.py``: the layout
walk over ``<root>/<scene>/dataset/data/{left/rgb, right/rgb, left/disparity}``
with the .jpg/.jpeg/.png stem fallback, and the seeded shuffle split with the
non-empty-train guard.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class StereoSample:
    left_rgb_path: Path
    right_rgb_path: Path
    disparity_path: Path


def _resolve_frame_path(frame_dir: Path, stem: str) -> Path | None:
    for ext in (".jpg", ".jpeg", ".png"):
        candidate = frame_dir / f"{stem}{ext}"
        if candidate.exists():
            return candidate
    return None


def discover_samples(dataset_root: str | Path) -> list[StereoSample]:
    """Walk scene dirs; match disparity PNG stems to left/right frames; skip
    incomplete scenes/frames."""
    root = Path(dataset_root).expanduser().resolve()
    if not root.exists():
        raise FileNotFoundError(f"Dataset root does not exist: {root}")

    samples: list[StereoSample] = []
    for scene_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        left_dir = scene_dir / "dataset" / "data" / "left" / "rgb"
        right_dir = scene_dir / "dataset" / "data" / "right" / "rgb"
        disp_dir = scene_dir / "dataset" / "data" / "left" / "disparity"
        if not (left_dir.exists() and right_dir.exists() and disp_dir.exists()):
            continue
        for disparity_path in sorted(disp_dir.glob("*.png")):
            stem = disparity_path.stem
            left = _resolve_frame_path(left_dir, stem)
            right = _resolve_frame_path(right_dir, stem)
            if left is None or right is None:
                continue
            samples.append(StereoSample(left, right, disparity_path))
    return samples


def split_samples(
    samples: Sequence[T],
    val_fraction: float,
    seed: int,
    *,
    require_non_empty_train: bool = True,
) -> tuple[list[T], list[T]]:
    """Seeded shuffle; val takes the tail ``max(int(n*frac), 1)`` items."""
    if not 0.0 <= val_fraction < 1.0:
        raise ValueError(
            f"val_fraction outside the valid range [0, 1): {val_fraction}"
        )

    # The shuffle order is the split contract: random.Random(seed) over the
    # discovery-sorted list is the reference's and the JAX package's, so a
    # cache or checkpoint made by either validates on the same samples here.
    shuffled = list(samples)
    random.Random(seed).shuffle(shuffled)

    if val_fraction == 0.0:
        return shuffled, []

    val_count = max(int(len(shuffled) * val_fraction), 1)
    if require_non_empty_train and val_count >= len(shuffled):
        raise ValueError(
            f"val_fraction={val_fraction} leaves no training samples "
            f"(n={len(shuffled)}); lower it or add data."
        )
    val_count = min(val_count, len(shuffled))
    return shuffled[:-val_count], shuffled[-val_count:]
