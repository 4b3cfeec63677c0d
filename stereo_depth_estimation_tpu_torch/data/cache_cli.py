"""``foundation-stereo-cache``: materialise decoded samples ahead of training.

Counterpart of ``stereo_depth_estimation_tpu/data/cache_cli.py``, with the same
flags:

    python -m stereo_depth_estimation_tpu_torch.data.cache_cli \
        --dataset-root <root> --cache-root <dir> [--packed]

Walks the raw FoundationStereo tree once, decodes and resizes every sample to
the training resolution, and stores per-sample ``.npz`` entries under the
cache root (the read-through format the loader also fills lazily, with the
reference cache tool's ``cache_meta.json``), plus, with ``--packed``, the
contiguous memmap bundle at ``<cache-root>/packed``. Both are the JAX
package's formats byte for byte, so either package reads the other's cache.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path

from .cache import sample_cache_relpath, save_cached_sample
from .dataset import StereoSampleLoader
from .packed_cache import build_packed_cache
from .samples import discover_samples


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Decode and resize the raw dataset once, so training "
                    "reads preprocessed arrays instead of PNGs."
    )
    parser.add_argument("--dataset-root", type=str, required=True,
                        help="Raw FoundationStereo tree to read from.")
    parser.add_argument("--cache-root", type=str, required=True,
                        help="Directory that receives the cache (use fast "
                             "local storage).")
    parser.add_argument("--height", type=int, default=240,
                        help="Target height of cached samples.")
    parser.add_argument("--width", type=int, default=320,
                        help="Target width of cached samples.")
    parser.add_argument("--max-samples", type=int, default=0,
                        help="Stop after this many samples (0 = all).")
    parser.add_argument("--overwrite", action="store_true",
                        help="Re-encode entries that already exist.")
    parser.add_argument("--compress", action="store_true",
                        help="Deflate the npz entries (smaller, slower).")
    parser.add_argument("--packed", action="store_true",
                        help="Additionally emit the contiguous memmap bundle "
                             "at <cache-root>/packed.")
    return parser


@dataclass
class CacheBuildReport:
    format_version: int
    dataset_root: str
    cache_root: str
    height: int
    width: int
    num_samples_total: int
    num_written: int
    num_skipped: int
    compressed: bool
    packed: bool
    elapsed_seconds: float
    created_at_unix: float


def run_build(args: argparse.Namespace) -> CacheBuildReport:
    dataset_root = Path(args.dataset_root).expanduser().resolve()
    cache_root = Path(args.cache_root).expanduser().resolve()
    cache_root.mkdir(parents=True, exist_ok=True)

    samples = discover_samples(dataset_root)
    if args.max_samples > 0:
        samples = samples[: args.max_samples]
    if not samples:
        raise ValueError(f"Nothing to cache — no samples found in {dataset_root}")
    print(f"{len(samples)} samples -> {cache_root} "
          f"at {args.width}x{args.height}")

    loader = StereoSampleLoader(samples, image_size=(args.height, args.width))
    t_start = time.time()
    written = skipped = 0
    progress = samples
    try:
        from tqdm import tqdm

        progress = tqdm(samples, unit="sample")
    except ImportError:
        pass
    for index, sample in enumerate(progress):
        destination = cache_root / sample_cache_relpath(sample)
        if destination.exists() and not args.overwrite:
            skipped += 1
            continue
        left, right, disparity = loader.load(index)
        save_cached_sample(destination, left, right, disparity,
                           compress=args.compress)
        written += 1

    if args.packed:
        # Read back through the npz layer we just filled, so the bundle is
        # byte-identical to what lazy training reads would have produced.
        build_packed_cache(
            StereoSampleLoader(samples, image_size=(args.height, args.width),
                               cache_root=cache_root),
            cache_root / "packed",
            progress=True,
        )

    report = CacheBuildReport(
        format_version=1,
        dataset_root=str(dataset_root),
        cache_root=str(cache_root),
        height=args.height,
        width=args.width,
        num_samples_total=len(samples),
        num_written=written,
        num_skipped=skipped,
        compressed=bool(args.compress),
        packed=bool(args.packed),
        elapsed_seconds=time.time() - t_start,
        created_at_unix=time.time(),
    )
    manifest = cache_root / "cache_meta.json"
    manifest.write_text(json.dumps(asdict(report), indent=2), encoding="utf-8")
    print(f"Done in {report.elapsed_seconds:.1f}s — "
          f"{written} encoded, {skipped} already present; "
          f"manifest at {manifest}")
    return report


def main(argv: list[str] | None = None) -> CacheBuildReport:
    return run_build(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
