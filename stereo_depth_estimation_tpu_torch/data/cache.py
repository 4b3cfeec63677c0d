"""Read-through .npz sample cache: key scheme and codec.

Counterpart of ``stereo_depth_estimation_tpu/data/cache.py``, same paths and
keys: canonical key ``<scene>/<stem>.npz`` (scene = the path segment before
"dataset"), a blake2s ``misc/`` fallback for other layouts; the npz holds
uint8 HWC ``left``/``right`` and float16 HW ``disparity``. A load checks keys,
ranks and shapes and returns None on a mismatch.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from .samples import StereoSample


def sample_cache_relpath(sample: StereoSample) -> Path:
    left_parts = sample.left_rgb_path.parts
    if "dataset" in left_parts:
        dataset_index = left_parts.index("dataset")
        if dataset_index > 0:
            scene_name = left_parts[dataset_index - 1]
            return Path(scene_name) / f"{sample.disparity_path.stem}.npz"

    source_key = (
        f"{sample.left_rgb_path.as_posix()}|"
        f"{sample.right_rgb_path.as_posix()}|"
        f"{sample.disparity_path.as_posix()}"
    )
    digest = hashlib.blake2s(source_key.encode("utf-8"), digest_size=8).hexdigest()
    return Path("misc") / f"{sample.disparity_path.stem}_{digest}.npz"


def load_cached_sample(
    cache_file: Path, image_size: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Returns (left u8 HWC, right u8 HWC, disparity f32 HW) or None if the
    entry is malformed or shape-mismatched for the requested size."""
    with np.load(cache_file) as cached:
        if not {"left", "right", "disparity"}.issubset(cached.files):
            return None
        left = cached["left"]
        right = cached["right"]
        disparity = cached["disparity"]

    if left.ndim != 3 or right.ndim != 3 or disparity.ndim != 2:
        return None
    if left.shape[:2] != image_size or right.shape[:2] != image_size:
        return None
    if disparity.shape != image_size:
        return None
    return (
        np.ascontiguousarray(left, dtype=np.uint8),
        np.ascontiguousarray(right, dtype=np.uint8),
        disparity.astype(np.float32),
    )


def save_cached_sample(
    cache_file: Path,
    left_u8: np.ndarray,
    right_u8: np.ndarray,
    disparity: np.ndarray,
    *,
    compress: bool = False,
) -> None:
    cache_file.parent.mkdir(parents=True, exist_ok=True)
    save_fn = np.savez_compressed if compress else np.savez
    save_fn(
        cache_file,
        left=np.asarray(left_u8, dtype=np.uint8),
        right=np.asarray(right_u8, dtype=np.uint8),
        disparity=np.asarray(disparity, dtype=np.float16),
    )
