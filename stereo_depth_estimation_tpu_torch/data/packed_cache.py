"""Packed array cache: flat memory-mapped files with fixed-stride records.

Counterpart of ``stereo_depth_estimation_tpu/data/packed_cache.py``, in the
same format, so a cache written by either package reads in the other:

- ``images.bin``: (N, H, W, 6) uint8, left RGB then right RGB;
- ``disparity.bin``: (N, H, W) float16;
- ``meta.json``: magic, format version, height, width, sample count, plus the
  caller's extras (the trainer's ``split_fingerprint``), written last and
  renamed into place, so a readable meta means complete payloads.

A batch is one fancy index per file, read in ascending order.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

_MAGIC = "sde-tpu-packed-cache"
FORMAT_VERSION = 2


class PackedCacheWriter:
    def __init__(self, root: str | Path, image_size: tuple[int, int]) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.image_size = image_size
        self._images = open(self.root / "images.bin", "wb")
        self._disp = open(self.root / "disparity.bin", "wb")
        self._count = 0

    def add(
        self, left_u8: np.ndarray, right_u8: np.ndarray, disparity: np.ndarray
    ) -> None:
        h, w = self.image_size
        image = np.empty((h, w, 6), dtype=np.uint8)
        image[..., :3] = left_u8
        image[..., 3:] = right_u8
        self._images.write(image.tobytes())
        self._disp.write(
            np.ascontiguousarray(disparity, dtype=np.float16).tobytes()
        )
        self._count += 1

    def finalize(self, extra_meta: dict | None = None) -> dict:
        self._images.close()
        self._disp.close()
        meta = {
            "magic": _MAGIC,
            "format_version": FORMAT_VERSION,
            "height": self.image_size[0],
            "width": self.image_size[1],
            "num_samples": self._count,
        }
        if extra_meta:
            meta.update(extra_meta)
        tmp = self.root / "meta.json.tmp"
        tmp.write_text(json.dumps(meta, indent=2))
        tmp.replace(self.root / "meta.json")
        return meta


class PackedCache:
    """Read side: zero-copy memmaps with batched gathers."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        meta_path = self.root / "meta.json"
        if not meta_path.exists():
            raise FileNotFoundError(f"Packed cache meta not found: {meta_path}")
        self.meta = json.loads(meta_path.read_text())
        if self.meta.get("magic") != _MAGIC:
            raise ValueError(f"Not a packed cache: {self.root}")
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"Packed cache format v{self.meta.get('format_version')} at "
                f"{self.root} is not v{FORMAT_VERSION}; rebuild it."
            )
        self.image_size = (int(self.meta["height"]), int(self.meta["width"]))
        h, w = self.image_size
        n = int(self.meta["num_samples"])
        self._images = np.memmap(
            self.root / "images.bin", dtype=np.uint8, mode="r", shape=(n, h, w, 6)
        )
        self._disparity = np.memmap(
            self.root / "disparity.bin", dtype=np.float16, mode="r", shape=(n, h, w)
        )

    def __len__(self) -> int:
        return len(self._images)

    @property
    def nbytes(self) -> int:
        return self._images.nbytes + self._disparity.nbytes

    def gather(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        """Batch fetch -> {"input": (N,H,W,6) u8, "target": (N,H,W) f16}.

        The target stays float16 on the host; the train step upcasts it on
        the device. Rows are read in ascending memmap order whatever the
        requested order, then put back in that order in RAM: the same
        result, with a sequential access pattern on disk."""
        idx = np.asarray(indices)
        if idx.size <= 1 or np.all(idx[:-1] <= idx[1:]):
            return {
                "input": self._images[idx],
                "target": self._disparity[idx],
            }
        order = np.argsort(idx, kind="stable")
        inverse = np.empty_like(order)
        inverse[order] = np.arange(order.size)
        return {
            "input": self._images[idx[order]][inverse],
            "target": self._disparity[idx[order]][inverse],
        }

    def load_all(self) -> dict[str, np.ndarray]:
        """Materialise the whole cache in host RAM (small datasets)."""
        return {
            "input": np.asarray(self._images),
            "target": np.asarray(self._disparity),
        }


def samples_fingerprint(samples) -> str:
    """Order-sensitive digest of a sample list's source paths, stored in a
    packed cache's meta.json and checked on reuse, so a cache built for one
    train/val split never serves another."""
    digest = hashlib.blake2s()
    for sample in samples:
        for path in (
            sample.left_rgb_path,
            sample.right_rgb_path,
            sample.disparity_path,
        ):
            digest.update(str(path).encode())
            digest.update(b"\x00")
    return digest.hexdigest()


def build_packed_cache(
    loader, root: str | Path, *, progress: bool = False,
    extra_meta: dict | None = None,
) -> dict:
    """Pack every sample of a StereoSampleLoader into a new cache at root."""
    writer = PackedCacheWriter(root, loader.image_size)
    iterator = range(len(loader))
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Packing cache", unit="sample")
        except ImportError:
            pass
    for index in iterator:
        left, right, disparity = loader.load(index)
        writer.add(left, right, disparity)
    return writer.finalize(extra_meta)
