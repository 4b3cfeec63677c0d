"""Host-side sample loading: decode, resize, read-through cache.

Counterpart of ``stereo_depth_estimation_tpu/data/dataset.py``. The loader
yields uint8 images (the reference's cache quantises resized RGB to uint8,
and the host-to-device copy is 4x smaller); ``float_inputs=True`` keeps the
resized float32 images, the reference's uncached path. Augmentation runs on
the device, in the train step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
from PIL import Image

from ..ops.codec import disparity_decode_np
from ..ops.resize import resize_bilinear_np, resize_disparity_np
from .cache import load_cached_sample, sample_cache_relpath, save_cached_sample
from .samples import StereoSample


def _quantize_u8(img_f32: np.ndarray) -> np.ndarray:
    # The reference cache writer's quantisation.
    return np.clip(img_f32 * 255.0, 0, 255).astype(np.uint8)


class StereoSampleLoader:
    """Loads one sample to (left u8 HWC, right u8 HWC, disparity f32 HW) at a
    fixed ``image_size=(H, W)``, with an optional read-through npz cache."""

    def __init__(
        self,
        samples: Iterable[StereoSample] | Sequence[StereoSample],
        image_size: tuple[int, int] = (240, 320),
        cache_root: str | Path | None = None,
        require_cache: bool = False,
        float_inputs: bool = False,
    ) -> None:
        self.samples = list(samples)
        self.image_size = image_size
        self.cache_root = (
            Path(cache_root).expanduser().resolve() if cache_root is not None else None
        )
        self.require_cache = require_cache
        self.float_inputs = float_inputs
        if len(self.samples) == 0:
            raise ValueError("No samples were provided.")

    def __len__(self) -> int:
        return len(self.samples)

    def _load_rgb_f32(self, path: Path) -> np.ndarray:
        rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
        return resize_bilinear_np(rgb, self.image_size)

    def _load_disparity(self, path: Path) -> np.ndarray:
        rgb_u8 = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
        disparity = disparity_decode_np(rgb_u8)
        return resize_disparity_np(disparity, self.image_size)

    def load(
        self, index: int, as_float: bool = False
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        sample = self.samples[index]
        left = right = target = None
        loaded_from_cache = False
        cache_file: Path | None = None

        if self.cache_root is not None:
            cache_file = self.cache_root / sample_cache_relpath(sample)
            if cache_file.exists():
                loaded = load_cached_sample(cache_file, self.image_size)
                if loaded is not None:
                    left, right, target = loaded
                    loaded_from_cache = True
                elif self.require_cache:
                    raise ValueError(
                        "Cache entry is invalid or shape-mismatched for "
                        f"sample: {cache_file}"
                    )
            elif self.require_cache:
                raise FileNotFoundError(
                    f"Required cache entry not found: {cache_file}"
                )

        if left is None or right is None or target is None:
            left_f = self._load_rgb_f32(sample.left_rgb_path)
            right_f = self._load_rgb_f32(sample.right_rgb_path)
            target = self._load_disparity(sample.disparity_path)
            if as_float:
                if cache_file is not None and not self.require_cache:
                    save_cached_sample(
                        cache_file, _quantize_u8(left_f), _quantize_u8(right_f), target
                    )
                return left_f, right_f, target
            left = _quantize_u8(left_f)
            right = _quantize_u8(right_f)

        if cache_file is not None and not self.require_cache and not loaded_from_cache:
            save_cached_sample(cache_file, left, right, target)

        if as_float:
            return (
                left.astype(np.float32) / 255.0,
                right.astype(np.float32) / 255.0,
                target,
            )
        return left, right, target

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        """Reference-shaped item: input (H,W,6) u8 (or f32 in [0,1] with
        ``float_inputs``), target (H,W) f32, valid_mask (H,W) bool."""
        left, right, target = self.load(index, as_float=self.float_inputs)
        return {
            "input": np.concatenate([left, right], axis=-1),
            "target": target,
            "valid_mask": target > 0.0,
        }
