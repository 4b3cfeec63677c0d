"""The port's data path held against the JAX package on the CPU: discovery
and split, codec and resize, the sample loader and its npz cache, the packed
cache (byte-identical, readable by either package), epoch order, batch
padding and the device-resident window plan.

The host side is numpy in both packages, with the same arithmetic, so every
comparison is exact (tolerance 0): a difference would mean a different
split, cache file or batch, not float noise.
"""

from dataclasses import asdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from stereo_depth_estimation_tpu.data import cache as j_cache
from stereo_depth_estimation_tpu.data import dataset as j_dataset
from stereo_depth_estimation_tpu.data import packed_cache as j_packed
from stereo_depth_estimation_tpu.data import pipeline as j_pipeline
from stereo_depth_estimation_tpu.data import samples as j_samples
from stereo_depth_estimation_tpu.ops import codec as j_codec
from stereo_depth_estimation_tpu.ops import resize as j_resize
from stereo_depth_estimation_tpu.parallel import mesh as j_mesh
from stereo_depth_estimation_tpu.parallel import window as j_window
from stereo_depth_estimation_tpu_torch.data import cache, dataset, packed_cache, pipeline, samples
from stereo_depth_estimation_tpu_torch.ops import codec, resize
from stereo_depth_estimation_tpu_torch.parallel import mesh, window


def make_dataset(root: Path, scenes=(("scene_a", 7), ("scene_b", 5)), shape=(40, 56)) -> None:
    """A FoundationStereo-layout tree; scene_b's frames are JPEG, one of its
    disparity maps has no right frame (skipped by discovery), and a scene
    without the disparity folder is skipped whole."""
    rng = np.random.default_rng(0)
    for scene, n in scenes:
        base = root / scene / "dataset" / "data"
        for sub in ("left/rgb", "right/rgb", "left/disparity"):
            (base / sub).mkdir(parents=True, exist_ok=True)
        ext = ".jpg" if scene == "scene_b" else ".png"
        for i in range(n):
            stem = f"{i:06d}"
            for side in ("left", "right"):
                if side == "right" and scene == "scene_b" and i == 2:
                    continue
                img = rng.uniform(0, 255, (*shape, 3)).astype(np.uint8)
                Image.fromarray(img).save(base / f"{side}/rgb" / f"{stem}{ext}")
            disparity = rng.uniform(0.5, 20.0, shape).astype(np.float32)
            Image.fromarray(codec.disparity_encode_np(disparity)).save(
                base / "left/disparity" / f"{stem}.png"
            )
    (root / "no_disparity" / "dataset" / "data" / "left" / "rgb").mkdir(parents=True)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("data")
    make_dataset(root)
    return root


def _paths(items) -> list[tuple[Path, Path, Path]]:
    return [(s.left_rgb_path, s.right_rgb_path, s.disparity_path) for s in items]


@pytest.mark.parametrize("val_fraction,seed", [(0.25, 42), (0.1, 0), (0.0, 7), (0.5, 3)])
def test_discovery_split_and_fingerprint_equal_jax(dataset_root, val_fraction, seed) -> None:
    found = samples.discover_samples(dataset_root)
    assert len(found) == 11 and _paths(found) == _paths(j_samples.discover_samples(dataset_root))
    train, val = samples.split_samples(found, val_fraction, seed)
    j_train, j_val = j_samples.split_samples(
        j_samples.discover_samples(dataset_root), val_fraction, seed
    )
    assert _paths(train) == _paths(j_train) and _paths(val) == _paths(j_val)
    for part in (train, val, found):
        assert packed_cache.samples_fingerprint(part) == j_packed.samples_fingerprint(part)
    with pytest.raises(ValueError, match="valid range"):
        samples.split_samples(found, 1.0, seed)


def test_codec_and_resize_equal_jax() -> None:
    rng = np.random.default_rng(1)
    disparity = rng.uniform(0.0, 300.0, (13, 17)).astype(np.float32)
    encoded = codec.disparity_encode_np(disparity)
    np.testing.assert_array_equal(encoded, j_codec.disparity_encode_np(disparity))
    np.testing.assert_array_equal(
        codec.disparity_decode_np(encoded), j_codec.disparity_decode_np(encoded)
    )
    np.testing.assert_allclose(codec.disparity_decode_np(encoded), disparity, atol=5e-4)
    image = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    for out_hw in ((24, 32), (37, 53), (64, 80)):
        np.testing.assert_array_equal(
            resize.resize_bilinear_np(image, out_hw), j_resize.resize_bilinear_np(image, out_hw)
        )
        np.testing.assert_array_equal(
            resize.resize_disparity_np(disparity, out_hw),
            j_resize.resize_disparity_np(disparity, out_hw),
        )


@pytest.mark.parametrize("float_inputs", [False, True], ids=["uint8", "float32"])
def test_loader_items_and_npz_cache_equal_jax(dataset_root, tmp_path, float_inputs) -> None:
    """Decode + resize to a non-native size (the fixture is 40x56), with
    the read-through npz cache: items, cache paths and cache files equal."""
    found = samples.discover_samples(dataset_root)
    ours = dataset.StereoSampleLoader(
        found, (24, 32), cache_root=tmp_path / "p", float_inputs=float_inputs
    )
    theirs = j_dataset.StereoSampleLoader(
        found, (24, 32), cache_root=tmp_path / "j", float_inputs=float_inputs
    )
    for i in (0, 8):
        for _ in range(2):  # the second read comes from the cache
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        rel = cache.sample_cache_relpath(found[i])
        assert rel == j_cache.sample_cache_relpath(found[i])
        with np.load(tmp_path / "p" / rel) as p, np.load(tmp_path / "j" / rel) as j:
            assert sorted(p.files) == sorted(j.files) == ["disparity", "left", "right"]
            for key in p.files:
                np.testing.assert_array_equal(p[key], j[key])
    odd = samples.StereoSample(Path("/x/a.png"), Path("/x/b.png"), Path("/x/c.png"))
    assert cache.sample_cache_relpath(odd) == j_cache.sample_cache_relpath(odd)


def test_packed_cache_byte_identical_and_read_by_either(dataset_root, tmp_path) -> None:
    found = samples.discover_samples(dataset_root)
    meta = {"split_fingerprint": packed_cache.samples_fingerprint(found)}
    packed_cache.build_packed_cache(
        dataset.StereoSampleLoader(found, (24, 32)), tmp_path / "p", extra_meta=meta
    )
    j_packed.build_packed_cache(
        j_dataset.StereoSampleLoader(found, (24, 32)), tmp_path / "j", extra_meta=meta
    )
    for name in ("images.bin", "disparity.bin", "meta.json"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    idx = np.array([5, 0, 10, 3, 3])
    for root in (tmp_path / "p", tmp_path / "j"):
        ours, theirs = packed_cache.PackedCache(root), j_packed.PackedCache(root)
        assert len(ours) == len(theirs) == 11 and ours.image_size == (24, 32)
        assert ours.nbytes == 11 * 24 * 32 * (6 + 2)
        for key, value in ours.gather(idx).items():
            np.testing.assert_array_equal(value, theirs.gather(idx)[key])
        np.testing.assert_array_equal(ours.gather(idx)["input"], ours.load_all()["input"][idx])


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,batch_size,drop_last", [(10, 4, False), (10, 4, True), (12, 3, False)])
def test_epoch_indices_equal_jax(n, batch_size, drop_last, shuffle) -> None:
    for seed, epoch in ((42, 1), (42, 2), (0, 1)):
        ours = pipeline.epoch_indices(
            n, batch_size, shuffle=shuffle, seed=seed, epoch=epoch, drop_last=drop_last
        )
        theirs = j_pipeline.epoch_indices(
            n, batch_size, shuffle=shuffle, seed=seed, epoch=epoch, drop_last=drop_last
        )
        assert [a.tolist() for a in ours] == [b.tolist() for b in theirs]


def test_pad_batch_to_equals_jax() -> None:
    rng = np.random.default_rng(2)
    batch = {"input": rng.integers(0, 255, (3, 4, 5, 6), dtype=np.uint8),
             "target": rng.uniform(0, 9, (3, 4, 5)).astype(np.float16)}
    for size, extra in ((5, {}), (3, {}), (4, {"valid_mask": rng.uniform(size=(3, 4, 5)) > 0.3})):
        ours = mesh.pad_batch_to({**batch, **extra}, size)
        theirs = j_mesh.pad_batch_to({**batch, **extra}, size)
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    with pytest.raises(ValueError, match="exceeds"):
        mesh.pad_batch_to(batch, 2)


@pytest.mark.parametrize("n,batch_size,per_sample,budget", [
    (100, 8, 10, 10_000), (100, 8, 10, 999), (101, 4, 3, 200), (9, 4, 1, 8),
])
def test_window_plan_and_epoch_windows_equal_jax(n, batch_size, per_sample, budget) -> None:
    plan = window.plan_windows(n, batch_size, per_sample, budget)
    assert asdict(plan) == asdict(j_window.plan_windows(n, batch_size, per_sample, budget))
    if plan.pinned:
        return
    fetch = lambda idx: {"input": np.zeros((len(idx), 1, 1, 6), np.uint8),  # noqa: E731
                         "target": np.zeros((len(idx), 1, 1), np.float16)}
    ours = window.HBMWindowLoader(fetch, n, batch_size, torch.device("cpu"), per_sample,
                                  budget, seed=5)
    mesh1 = j_mesh.make_mesh(jax.devices("cpu")[:1])
    theirs = j_window.HBMWindowLoader(fetch, n, batch_size, mesh1, per_sample, budget, seed=5)
    for epoch in (1, 2):
        a, b = ours._epoch_window_indices(epoch), theirs._epoch_window_indices(epoch)
        assert [w.tolist() for w in a] == [w.tolist() for w in b]
    with pytest.raises(ValueError, match="cannot hold"):
        window.plan_windows(n, batch_size, per_sample, per_sample)


@pytest.mark.parametrize("n,budget", [(10, 10**9), (10, 6), (11, 10), (12, 8)],
                         ids=["pinned", "rotating", "rotating-wrap", "rotating-exact"])
def test_window_loader_serves_every_sample_once_per_epoch(n, budget) -> None:
    """Rows carry their sample id; a rotating epoch's batches cover every
    sample (the wrap-filled last window repeats a few), a pinned epoch's
    cover n // batch_size batches of distinct samples."""
    batch_size = 2
    ids = np.arange(n)
    fetch = lambda idx: {  # noqa: E731
        "input": np.broadcast_to(np.asarray(idx, np.uint8)[:, None, None, None], (len(idx), 1, 1, 6)).copy(),
        "target": np.asarray(idx, np.float16)[:, None, None].copy(),
    }
    loader = window.HBMWindowLoader(fetch, n, batch_size, torch.device("cpu"), 1, budget,
                                    seed=0)
    assert loader.plan.pinned == (budget > n)
    model_state = type("S", (), {})()
    model_state.generator = torch.Generator().manual_seed(0)
    for epoch in (1, 2):
        seen = []
        runners = list(loader.epoch_steps(epoch, lambda state, batch: (state, batch)))
        assert len(runners) == loader.plan.steps_per_epoch
        for runner in runners:
            state, batch = runner(model_state)
            assert state is model_state
            assert torch.equal(batch["input"][:, 0, 0, 0].float(), batch["target"][:, 0, 0].float())
            seen += batch["input"][:, 0, 0, 0].tolist()
        if loader.plan.pinned:
            assert len(set(seen)) == len(seen) == (n // batch_size) * batch_size
        else:
            assert set(seen) == set(ids.tolist())


def test_prefetch_keeps_order_and_raises_worker_errors() -> None:
    batches = [{"input": np.full((2, 3), i, np.uint8)} for i in range(5)]
    put = pipeline.cuda_put(torch.device("cpu"), lambda b: {**b, "valid_mask": np.ones(2, bool)})
    got = list(pipeline.prefetch_to_device(iter(batches), put=put))
    assert [int(b["input"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["input"], torch.Tensor) and b["valid_mask"].dtype == torch.bool for b in got)

    def failing():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(pipeline.prefetch_to_device(failing(), put=put))
    early = pipeline.prefetch_to_device(iter(batches * 100), put=put, depth=1)
    assert int(next(early)["input"][0, 0]) == 0
    early.close()  # the worker stops instead of blocking on a full queue


def test_tensor_codec_is_bitwise_the_numpy_codec_and_near_jax() -> None:
    """The port's tensor codec against its numpy codec, bitwise: the decode
    on every uint8 RGB triple, the encode on uniform disparities and on the
    decoded codes. Against the JAX device codec: the encode bitwise on the
    decoded codes (the JAX encode rounds in float32, numpy in float64, and
    both land on the code there); the decode within one float32 ulp (JAX
    multiplies by the float32 reciprocal of the scale, numpy divides). The
    encode's JAX comparison takes the first 400,000 triples (R below 7:
    disparities below 457 px), where the float32 product lands on the code;
    far above that it can miss it by one."""
    import jax.numpy as jnp

    codes = np.arange(1 << 24, dtype=np.int64)
    rgb = np.stack([codes >> 16, (codes >> 8) & 255, codes & 255], -1).astype(np.uint8)
    got = codec.disparity_decode(torch.from_numpy(rgb)).numpy()
    want = codec.disparity_decode_np(rgb)
    assert got.dtype == np.float32 and got.shape == (1 << 24,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    sample = rgb[:: 97]
    jax_dec = np.asarray(j_codec.disparity_decode(jnp.asarray(sample)))
    spacing = np.spacing(np.abs(want[:: 97]))
    assert np.all(np.abs(got[:: 97] - jax_dec) <= spacing)

    rng = np.random.default_rng(2)
    disparity = rng.uniform(0.0, 400.0, (64, 96)).astype(np.float32)
    encoded = codec.disparity_encode(torch.from_numpy(disparity))
    assert encoded.dtype == torch.uint8 and encoded.shape == (64, 96, 3)
    np.testing.assert_array_equal(encoded.numpy(), codec.disparity_encode_np(disparity))
    decoded = want[: 400_000 : 7]
    again = codec.disparity_encode(torch.from_numpy(decoded)).numpy()
    np.testing.assert_array_equal(again, codec.disparity_encode_np(decoded))
    np.testing.assert_array_equal(again, np.asarray(j_codec.disparity_encode(
        jnp.asarray(decoded))))
