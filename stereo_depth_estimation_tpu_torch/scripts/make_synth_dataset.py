"""Generate a synthetic FoundationStereo-format stereo dataset with real
stereo structure, for convergence runs and benchmarks.

Counterpart of ``scripts/make_synth_dataset.py``, whose output it writes
byte for byte at the same arguments:

    python -m stereo_depth_estimation_tpu_torch.scripts.make_synth_dataset \\
        --out <dir> --samples 2048

Scenes are rendered with a painter's algorithm over fronto-parallel layers:
a textured background plane plus N textured sprites (ellipses/rectangles),
each at a constant disparity. A layer at disparity ``d`` is painted at
``x`` in the left view and at ``x - d`` in the right view, far-to-near, so
occlusions are geometrically consistent and the ground-truth left-view
disparity map is exact: a network can learn to match horizontal shifts
between textured surfaces.

Output layout is the reference loader's: ``<out>/<scene>/dataset/data/
{left/rgb, right/rgb, left/disparity}/<frame>.png``, with disparity in the
FoundationStereo RGB24 encoding (``ops/codec.py``). Each frame is a pure
function of (seed, scene, frame), drawn from numpy's
``SeedSequence([seed, scene, frame])``, so frames are rendered by a pool of
threads in any order, and a partially written tree resumes to the same bytes
by skipping complete frames. This is numpy and PIL work on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from PIL import Image

from ..ops.codec import disparity_encode_np

SUBDIRS = ("left/rgb", "right/rgb", "left/disparity")


def _smooth_noise_texture(
    rng: np.random.Generator, hw: tuple[int, int], scale: int
) -> np.ndarray:
    """(H, W, 3) float32 in [0,1]: low-res RGB noise upsampled bilinearly,
    plus a random linear shading gradient — cheap, dense, non-repeating
    texture with structure at several frequencies."""
    h, w = hw
    lo = rng.random((max(2, h // scale), max(2, w // scale), 3), dtype=np.float32)
    tex = np.asarray(
        Image.fromarray((lo * 255).astype(np.uint8)).resize(
            (w, h), Image.Resampling.BILINEAR
        ),
        np.float32,
    ) / 255.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gx, gy = rng.uniform(-0.3, 0.3, 2)
    shade = 0.85 + gx * (xx / w - 0.5) + gy * (yy / h - 0.5)
    tint = rng.uniform(0.5, 1.0, 3).astype(np.float32)
    return np.clip(tex * tint * shade[..., None], 0.0, 1.0)


def _sprite_mask(
    rng: np.random.Generator, hw: tuple[int, int]
) -> np.ndarray | None:
    """(H, W) bool mask of one random ellipse or rotated rectangle."""
    h, w = hw
    cy = rng.uniform(0.1 * h, 0.9 * h)
    cx = rng.uniform(0.1 * w, 0.9 * w)
    ry = rng.uniform(0.06 * h, 0.28 * h)
    rx = rng.uniform(0.06 * w, 0.28 * w)
    theta = rng.uniform(0.0, np.pi)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    if rng.random() < 0.5:
        mask = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
    else:
        mask = (np.abs(u) <= rx) & (np.abs(v) <= ry)
    return mask if mask.any() else None


def render_stereo_frame(
    rng: np.random.Generator,
    hw: tuple[int, int],
    max_disparity: float,
    n_sprites: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (left u8 HWC, right u8 HWC, disparity f32 HW in LEFT view)."""
    h, w = hw

    # Background plane at a small disparity (integer shift keeps it exact).
    d_bg = float(rng.integers(1, max(2, int(0.12 * max_disparity) + 1)))
    bg = _smooth_noise_texture(rng, (h, w + int(np.ceil(d_bg)) + 1), scale=8)
    left = bg[:, : w].copy()
    shift_bg = int(round(d_bg))
    right = bg[:, shift_bg : w + shift_bg].copy()
    disparity = np.full((h, w), d_bg, np.float32)

    # Sprites far-to-near: nearer (larger disparity) painted later so
    # occlusion order is consistent in BOTH views.
    ds = np.sort(rng.uniform(0.15 * max_disparity, max_disparity, n_sprites))
    for d in ds:
        mask = _sprite_mask(rng, hw)
        if mask is None:
            continue
        tex = _smooth_noise_texture(rng, hw, scale=int(rng.integers(3, 10)))
        left[mask] = tex[mask]
        disparity[mask] = d
        # Right view: same sprite shifted left by d (sub-pixel positions
        # rounded to keep the painted geometry exactly self-consistent).
        shift = int(round(d))
        cols = np.nonzero(mask)
        xr = cols[1] - shift
        ok = xr >= 0
        right[cols[0][ok], xr[ok]] = tex[cols[0][ok], cols[1][ok]]

    to_u8 = lambda img: np.clip(img * 255.0, 0, 255).astype(np.uint8)  # noqa: E731
    return to_u8(left), to_u8(right), disparity


def _write_frame(
    base: Path,
    frame_i: int,
    scene_i: int,
    seed: int,
    hw: tuple[int, int],
    max_disparity: float,
    sprites: tuple[int, int],
) -> None:
    name = f"{frame_i:06d}.png"
    if all((base / sub / name).exists() for sub in SUBDIRS):
        return  # complete: a resumed run keeps it
    rng = np.random.default_rng(np.random.SeedSequence([seed, scene_i, frame_i]))
    n_sprites = int(rng.integers(sprites[0], sprites[1] + 1))
    left, right, disp = render_stereo_frame(rng, hw, max_disparity, n_sprites)
    Image.fromarray(left).save(base / "left/rgb" / name)
    Image.fromarray(right).save(base / "right/rgb" / name)
    Image.fromarray(disparity_encode_np(disp)).save(base / "left/disparity" / name)


def generate(
    out: Path,
    n_samples: int,
    n_scenes: int,
    hw: tuple[int, int],
    max_disparity: float,
    seed: int,
    sprites: tuple[int, int] = (4, 10),
) -> dict:
    """Write ``n_samples`` frames over ``n_scenes`` scenes under ``out``
    (``ceil(n_samples / n_scenes)`` a scene, the last scenes short) and
    ``synth_meta.json``; return the meta. A thread a core renders and
    encodes (numpy and PIL release the GIL for most of a frame)."""
    start = time.perf_counter()
    per_scene = (n_samples + n_scenes - 1) // n_scenes
    frames = []
    for scene_i in range(n_scenes):
        base = out / f"scene_{scene_i:03d}" / "dataset" / "data"
        for sub in SUBDIRS:
            (base / sub).mkdir(parents=True, exist_ok=True)
        frames += [(base, frame_i, scene_i)
                   for frame_i in range(per_scene)][: n_samples - len(frames)]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(
            lambda f: _write_frame(*f, seed, hw, max_disparity, sprites), frames))
    meta = {
        "samples": len(frames),
        "scenes": n_scenes,
        "height": hw[0],
        "width": hw[1],
        "max_disparity": max_disparity,
        "seed": seed,
        "elapsed_seconds": round(time.perf_counter() - start, 1),
    }
    (out / "synth_meta.json").write_text(json.dumps(meta, indent=2))
    return meta


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--samples", type=int, default=2048)
    parser.add_argument("--scenes", type=int, default=8)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--max-disparity", type=float, default=48.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    meta = generate(
        args.out, args.samples, args.scenes, (args.height, args.width),
        args.max_disparity, args.seed,
    )
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
