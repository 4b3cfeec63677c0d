"""PyTorch augmentation (plain chain and the fused kernel's plain version)
held against the JAX package on the CPU.

The same numpy images and factors go through both. Tolerances: atol 1e-5 in
float32, as the JAX package's own augmentation tests use; in bfloat16, one
bf16 ulp of the larger of the two values. The Pallas kernel runs in
interpret mode, as tests/test_augment_pallas.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.ops import augment as A
from stereo_depth_estimation_tpu.ops import augment_pallas as AP
from stereo_depth_estimation_tpu_torch.ops import augment as T
from stereo_depth_estimation_tpu_torch.ops import augment_cuda as TC

ATOL = 1e-5


def _tie_rich_u8(n: int, h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Random uint8 images with many exact ties: gray pixels and pixels whose
    two largest channels are equal, in every channel position."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, h, w, channels), dtype=np.uint8)
    for view in range(channels // 3):
        v = x[..., 3 * view : 3 * view + 3]
        kind = rng.integers(0, 5, (n, h, w))
        v[kind == 0] = v[kind == 0][:, :1]  # gray: r == g == b
        for pos, (a, b) in enumerate(((0, 1), (1, 2), (0, 2)), start=1):
            sel = kind == pos
            top = np.maximum(v[sel][:, a], v[sel][:, b])
            rows = v[sel]
            rows[:, a] = top
            rows[:, b] = top
            rows[:, 3 - a - b] = np.minimum(rows[:, 3 - a - b], top)
            v[sel] = rows
    return x


def _np_factors(n: int, seed: int, blur_on=None) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    f = {
        "brightness": rng.uniform(0.5, 1.5, n),
        "contrast": rng.uniform(0.5, 1.5, n),
        "saturation": rng.uniform(0.5, 1.5, n),
        "hue": rng.uniform(-0.5, 0.5, n),  # wide: negative shifts and wrap-around
        "gamma": rng.uniform(0.7, 1.3, n),
        "blur_on": rng.uniform(size=n) < 0.5 if blur_on is None else np.asarray(blur_on),
        "blur_sigma": rng.uniform(0.1, 1.5, n),
        "noise_std": rng.uniform(0.0, 0.05, n),
    }
    return {k: v.astype(np.float32) if v.dtype != bool else v for k, v in f.items()}


def _jax(f):
    return {k: jnp.asarray(v) for k, v in f.items()}


def _torch(f):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in f.items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_within_one_bf16_ulp(actual: np.ndarray, desired: np.ndarray) -> None:
    ulp = np.maximum(_bf16_ulp(actual), _bf16_ulp(desired))
    err = np.abs(actual - desired)
    assert np.all(err <= ulp), f"max err {err.max()} ({(err > ulp).sum()} > 1 ulp)"


@pytest.mark.parametrize("blur_prob", [0.0, 1.0])
def test_plain_chain_matches_jax_chain_pre_noise(blur_prob) -> None:
    images = _tie_rich_u8(4, 12, 16, 3, seed=0).astype(np.float32) / 255.0
    factors = _np_factors(4, seed=1, blur_on=[True, False, True, True])
    cfg_j = A.AugmentConfig(blur_prob=blur_prob)
    cfg_t = T.AugmentConfig(blur_prob=blur_prob)
    ref = np.asarray(A._chain_pre_noise(jnp.asarray(images), _jax(factors), cfg_j))
    out = T._chain_pre_noise(torch.from_numpy(images), _torch(factors), cfg_t).numpy()
    assert out.shape == ref.shape == (4, 12, 16, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_hue_uses_floor_modulo_and_tolerant_max_rule() -> None:
    """Pure red shifted by -1/3 turns blue (a floor modulo; fmod would turn
    it green), and a channel 1e-7 below the max counts as the max."""
    red = torch.tensor([[[[1.0, 0.0, 0.0]]]])
    np.testing.assert_allclose(
        T.adjust_hue(red, torch.tensor([-1.0 / 3.0])).numpy().ravel(),
        [0.0, 0.0, 1.0], atol=1e-5,
    )
    near_tie = np.array([[[[0.8, 0.8 - 1e-7, 0.2]]]], np.float32)
    ref = np.asarray(A.adjust_hue(jnp.asarray(near_tie), jnp.asarray([0.1], jnp.float32)))
    out = T.adjust_hue(torch.from_numpy(near_tie), torch.tensor([0.1])).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_blur_matches_jax_and_keeps_constant_images() -> None:
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 7, 9, 3)).astype(np.float32)
    sigma = np.array([0.3, 1.2], np.float32)
    ref = np.asarray(A.gaussian_blur(jnp.asarray(img), jnp.asarray(sigma), 5))
    out = T.gaussian_blur(torch.from_numpy(img), torch.from_numpy(sigma), 5).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    const = T.gaussian_blur(torch.full((2, 9, 9, 3), 0.37), torch.tensor([0.3, 1.0]), 5)
    np.testing.assert_allclose(const.numpy(), 0.37, atol=1e-6)


def test_pack_factors_matches_jax() -> None:
    n = 3
    x = _tie_rich_u8(n, 16, 24, 6, seed=3)
    factors = _np_factors(2 * n, seed=4)
    ref = np.asarray(AP._pack_factors(jnp.asarray(x), _jax(factors), n))
    out = TC._pack_factors(torch.from_numpy(x), _torch(factors), n).numpy()
    assert out.shape == ref.shape == (n, 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("blur_k", [0, 5])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_pointwise_chain_plain_matches_pallas_interpret(blur_k, out_dtype) -> None:
    n = 2
    x = _tie_rich_u8(n, 32, 48, 6, seed=5)
    factors = _np_factors(2 * n, seed=6, blur_on=[True, False, False, True])
    packed = np.asarray(AP._pack_factors(jnp.asarray(x), _jax(factors), n))
    ref = np.asarray(
        AP._pointwise_chain(
            jnp.asarray(x), jnp.asarray(packed), blur_k=blur_k, interpret=True,
            out_dtype=getattr(jnp, out_dtype),
        ).astype(jnp.float32)
    )
    out = TC.pointwise_chain_plain(
        torch.from_numpy(x), torch.from_numpy(packed), blur_k, getattr(torch, out_dtype)
    )
    assert out.dtype == getattr(torch, out_dtype) and out.shape == (n, 32, 48, 6)
    out = out.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=ATOL)
    else:
        _assert_within_one_bf16_ulp(out, ref)
    # The dispatching wrapper takes the plain version for a CPU tensor.
    routed = TC.pointwise_chain(
        torch.from_numpy(x), torch.from_numpy(packed), blur_k, getattr(torch, out_dtype)
    )
    np.testing.assert_array_equal(routed.float().numpy(), out)


def test_fused_path_on_cpu_equals_plain_stereo_batch() -> None:
    """The fused path (pack + plain pointwise chain on the CPU + noise) and
    the plain stereo path draw the same factors and noise from one seed."""
    x = torch.from_numpy(_tie_rich_u8(3, 16, 16, 6, seed=7))
    cfg = T.AugmentConfig(blur_prob=0.5)
    fused = TC.augment_stereo_batch_fused(torch.Generator().manual_seed(3), x, cfg)
    plain = T.augment_stereo_batch(
        torch.Generator().manual_seed(3), x.float() * (1.0 / 255.0), cfg
    )
    assert fused.dtype == torch.float32 and fused.shape == (3, 16, 16, 6)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=ATOL)
    assert float(fused.min()) >= 0.0 and float(fused.max()) <= 1.0


def test_kernel_impl_on_cpu_raises() -> None:
    x = torch.zeros((1, 4, 4, 6), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TC.augment_stereo_batch_fused(
            torch.Generator(), x, T.AugmentConfig(impl="kernel")
        )


def test_config_validation_matches_jax() -> None:
    for kwargs in (
        {"blur_prob": 1.5}, {"blur_prob": -0.1}, {"blur_kernel_size": 4},
        {"blur_kernel_size": 1}, {"saturation_jitter": -1.0}, {"gamma_jitter": -0.1},
    ):
        with pytest.raises(ValueError):
            A.AugmentConfig(**kwargs)
        with pytest.raises(ValueError):
            T.AugmentConfig(**kwargs)
    with pytest.raises(ValueError, match="impl"):
        T.AugmentConfig(impl="xla")
    for impl in ("auto", "plain", "kernel"):
        assert T.AugmentConfig(impl=impl).impl == impl
    assert T.AugmentConfig() == T.AugmentConfig(
        brightness_jitter=0.25, contrast_jitter=0.25, saturation_jitter=0.25,
        hue_jitter=0.09, gamma_jitter=0.2, noise_std_max=0.05, blur_prob=0.03,
        blur_sigma_max=1.0, blur_kernel_size=5,
    )


def test_sampled_factor_ranges_and_blur_rate() -> None:
    n = 20000
    f = T.sample_factors(torch.Generator().manual_seed(0), n, T.AugmentConfig())
    assert all(v.shape == (n,) for v in f.values())
    for name, lo, hi in (
        ("brightness", 0.75, 1.25), ("contrast", 0.75, 1.25),
        ("saturation", 0.75, 1.25), ("hue", -0.09, 0.09), ("gamma", 0.8, 1.2),
        ("blur_sigma", 0.1, 1.0), ("noise_std", 0.0, 0.05),
    ):
        v = f[name].numpy()
        assert lo <= v.min() and v.max() <= hi, name
        # Uniform on [lo, hi]: mean in the middle, and it fills the range.
        assert abs(v.mean() - (lo + hi) / 2) < 0.01 * (hi - lo), name
        assert v.min() < lo + 0.01 * (hi - lo) and v.max() > hi - 0.01 * (hi - lo), name
    rate = f["blur_on"].float().mean().item()
    assert abs(rate - 0.03) < 0.006  # 5 standard errors at n=20000
    again = T.sample_factors(torch.Generator().manual_seed(0), n, T.AugmentConfig())
    for name in f:
        assert torch.equal(f[name], again[name]), name

    off = T.sample_factors(
        torch.Generator().manual_seed(1), 8,
        T.AugmentConfig(brightness_jitter=0, contrast_jitter=0, saturation_jitter=0,
                        hue_jitter=0, gamma_jitter=0, noise_std_max=0, blur_prob=0),
    )
    for name in ("brightness", "contrast", "saturation", "gamma"):
        assert torch.equal(off[name], torch.ones(8)), name
    assert torch.equal(off["hue"], torch.zeros(8))
    assert torch.equal(off["noise_std"], torch.zeros(8))
    assert not off["blur_on"].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_per_view_std(dtype) -> None:
    n, h, w = 4, 64, 64
    stereo = torch.full((n, h, w, 6), 0.5, dtype=dtype)
    left = torch.tensor([0.0, 0.01, 0.03, 0.05])
    right = torch.tensor([0.05, 0.03, 0.01, 0.0])
    out = T.noise_and_clip_stereo(torch.Generator().manual_seed(0), stereo, left, right, True)
    assert out.dtype == dtype
    noise = out.float() - 0.5
    for i in range(n):
        for view, std in ((slice(0, 3), left[i]), (slice(3, 6), right[i])):
            measured = noise[i, ..., view].std().item()
            if std == 0:
                assert measured == 0.0
            else:
                # 12288 draws: the sample std is within 3% of the true one;
                # bf16 rounding of 0.5 + noise adds about 2^-9 / sqrt(3).
                assert abs(measured - float(std)) < 0.03 * float(std) + 1.2e-3, (i, view)
    clipped = T.noise_and_clip_stereo(
        torch.Generator(), stereo.float() * 3.0 - 1.0, left, right, False
    )
    assert torch.equal(clipped, (stereo.float() * 3.0 - 1.0).clamp(0.0, 1.0))


def test_augment_with_factors_adds_noise_of_the_requested_scale_and_clamps() -> None:
    img = torch.full((2, 64, 64, 3), 0.5)
    f = _torch(_np_factors(2, seed=8))
    f["noise_std"] = torch.tensor([0.05, 0.0])
    f["blur_on"] = torch.tensor([False, False])
    cfg = T.AugmentConfig(noise_std_max=0.05)
    out = T.augment_with_factors(torch.Generator().manual_seed(3), img, f, cfg)
    quiet = T._chain_pre_noise(img, f, cfg)
    assert 0.04 < float((out[0] - quiet[0]).std()) < 0.06
    assert torch.equal(out[1], quiet[1].clamp(0.0, 1.0))
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_stereo_views_augmented_independently() -> None:
    view = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(5))
    stereo = torch.cat([view, view], dim=-1)
    out = T.augment_stereo_batch(torch.Generator().manual_seed(1), stereo, T.AugmentConfig())
    assert not torch.allclose(out[..., :3], out[..., 3:], atol=1e-3)
