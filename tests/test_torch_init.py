"""A fresh port StereoUNet held against a fresh flax StereoUNet on the CPU.

Both are drawn at full width (base 32) from seed 42; the JAX variables cross
with ``state_dict_from_jax``. PyTorch's random stream is not JAX's, so the
contract is the distribution: every kernel a normal truncated at two standard
deviations with std 1/sqrt(fan_in) (flax ``lecun_normal``), every bias 0,
BatchNorm weight 1 and bias 0 with fresh statistics. Limits: a weight's
std * sqrt(fan_in) within 3% of 1.0 and of the JAX leaf's where it has at
least 8,192 elements (the smallest of those, ``up1``, puts its sample std
within about 0.7% of the true one); |w| * sqrt(fan_in) at most
2 / 0.8796 = 2.27370; a two-sample Kolmogorov-Smirnov distance under 0.005
between the pooled scaled weights (about 7.7M values a side; the 95% point
of the distance between two samples of one distribution is 0.0007).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu_torch.live.depth_live_dl import LiveDepthEngine
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import state_dict_from_jax, torch_key_map
from stereo_depth_estimation_tpu_torch.ops.halo import SpatialGroup
from stereo_depth_estimation_tpu_torch.parallel.mesh import make_mesh
from stereo_depth_estimation_tpu_torch.parallel.train_step import create_train_state, make_adamw
from stereo_depth_estimation_tpu_torch.training.config import TrainConfig
from stereo_depth_estimation_tpu_torch.training.trainer import build_model
from stereo_depth_estimation_tpu_torch.training.checkpoint import (
    load_model_variables,
    load_train_state,
    save_checkpoint,
)

BASE = 32
SEED = 42
LARGE = 8192  # elements of up1 at base 32, the smallest leaf held to 3%
TRUNCATION = 2.2737  # 2 / 0.87962566103423978, rounded up in the fifth digit
STD_TOL = 0.03
KS_LIMIT = 0.005


def _seeded(**kwargs):
    return lambda: StereoUNet(base_channels=BASE, device="cpu",
                              generator=torch.Generator().manual_seed(SEED), **kwargs)


def _no_generator() -> StereoUNet:
    torch.manual_seed(SEED)
    return StereoUNet(base_channels=BASE, device="cpu")


# name -> a fresh model as the program builds it. ``stripes`` builds every
# 3x3 conv as a HaloConv2d (a SpatialGroup of two ranks; no collective runs
# at init); ``trainer`` is the trainer's model at its defaults (seed 42,
# base 32, bf16) on a one-rank CPU mesh; ``live_engine`` is the live
# viewer's model (seed 0).
VARIANTS = {
    "default": _seeded(),
    "bn_stats_bf16": _seeded(bn_stats_dtype=torch.bfloat16),
    "compute_bf16": _seeded(compute_dtype=torch.bfloat16),
    "stripes": _seeded(spatial_group=SpatialGroup(None, 0, 2)),
    "no_generator": _no_generator,
    "trainer": lambda: build_model(TrainConfig(), make_mesh(torch.device("cpu"))),
    "live_engine": lambda: LiveDepthEngine((320, 240), None, device="cpu").model,
}


@pytest.fixture(scope="module")
def jax_state() -> dict[str, np.ndarray]:
    model = JaxUNet(base_channels=BASE)
    variables = jax.jit(
        lambda key: model.init(
            key, jnp.zeros((1, 16, 16, 6), jnp.float32), train=False, return_uncertainty=True
        )
    )(jax.random.PRNGKey(SEED))
    return {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


@functools.cache
def _port_state(variant: str) -> dict[str, np.ndarray]:
    model = VARIANTS[variant]()
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _fan_in(key: str, w: np.ndarray) -> int:
    """Input channels * kh * kw; a transposed conv's weight is (in, out, kh, kw)."""
    transposed = key.split(".")[0].startswith("up")
    return w.shape[0 if transposed else 1] * w.shape[2] * w.shape[3]


def _weights(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {k: v * np.sqrt(_fan_in(k, v)) for k, v in state.items() if v.ndim == 4}


def _pooled(weights: dict[str, np.ndarray]) -> np.ndarray:
    return np.sort(np.concatenate([weights[k].ravel() for k in sorted(weights)]))


def _ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov distance of two sorted samples."""
    points = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, points, side="right") / a.size
    cdf_b = np.searchsorted(b, points, side="right") / b.size
    return float(np.abs(cdf_a - cdf_b).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_keys_and_shapes_are_the_jax_models(variant, jax_state) -> None:
    port = _port_state(variant)
    assert set(jax_state) == set(torch_key_map())
    assert set(port) == set(jax_state) == set(_port_state("default"))
    for key, value in jax_state.items():
        assert port[key].shape == value.shape, key


@pytest.mark.parametrize("variant", VARIANTS)
def test_weight_std_is_lecun_normal(variant, jax_state) -> None:
    ours, theirs = _weights(_port_state(variant)), _weights(jax_state)
    large = [k for k, v in ours.items() if v.size >= LARGE]
    assert len(large) == 21  # 17 of the 18 3x3 convs (not enc1's first) and up1-up4
    for key in large:
        std, jax_std = float(ours[key].std()), float(theirs[key].std())
        assert abs(jax_std - 1.0) <= STD_TOL, (key, jax_std)
        assert abs(std - 1.0) <= STD_TOL, (key, std)
        assert abs(std - jax_std) <= STD_TOL * jax_std, (key, std, jax_std)


@pytest.mark.parametrize("variant", VARIANTS)
def test_weights_are_truncated_at_two_std(variant, jax_state) -> None:
    ours, theirs = _weights(_port_state(variant)), _weights(jax_state)
    for key in ours:
        assert float(np.abs(theirs[key]).max()) <= TRUNCATION, key
        peak = float(np.abs(ours[key]).max())
        assert peak <= TRUNCATION, (key, peak)
        if ours[key].size >= LARGE:
            # PyTorch's U(+-1/sqrt(fan_in)) reads 1.0 here (1.41 for a
            # transposed conv, whose fan_in it takes from the output side).
            assert peak > 1.5, (key, peak)


@pytest.mark.parametrize("variant", VARIANTS)
def test_biases_are_zero_and_batchnorm_fresh(variant, jax_state) -> None:
    port = _port_state(variant)
    for state in (port, jax_state):
        for key, value in state.items():
            if key.endswith((".bias", "running_mean")):
                assert not value.any(), key  # conv, transposed-conv, head and BatchNorm
            elif key.endswith("running_var") or (value.ndim == 1 and key.endswith(".weight")):
                np.testing.assert_array_equal(value, np.ones_like(value), err_msg=key)
    assert {k for k in port if k.endswith(".bias") and k.split(".")[0].startswith("up")} == {
        "up4.bias", "up3.bias", "up2.bias", "up1.bias"}


@pytest.fixture(scope="module")
def jax_pooled(jax_state) -> np.ndarray:
    return _pooled(_weights(jax_state))


@pytest.mark.parametrize("variant", VARIANTS)
def test_pooled_weights_share_the_jax_distribution(variant, jax_pooled) -> None:
    ours = _pooled(_weights(_port_state(variant)))
    assert ours.size == jax_pooled.size > 7_700_000
    distance = _ks_distance(ours, jax_pooled)
    assert distance < KS_LIMIT, distance


def test_seeded_fresh_model_is_reproducible_and_seed_dependent() -> None:
    a = _port_state("default")
    b = StereoUNet(base_channels=BASE, device="cpu",
                   generator=torch.Generator().manual_seed(SEED)).state_dict()
    c = StereoUNet(base_channels=BASE, device="cpu",
                   generator=torch.Generator().manual_seed(SEED + 1)).state_dict()
    for key, value in a.items():
        np.testing.assert_array_equal(value, b[key].numpy(), err_msg=key)
    assert not np.array_equal(a["enc2.block.0.weight"], c["enc2.block.0.weight"].numpy())
    # Another mode draws the same stream over the same modules.
    for key, value in _port_state("bn_stats_bf16").items():
        np.testing.assert_array_equal(value, a[key], err_msg=key)


# --- a checkpoint overwrites the fresh draw (base 4) --------------------------

def _small(seed: int) -> StereoUNet:
    return StereoUNet(base_channels=4, device="cpu", generator=torch.Generator().manual_seed(seed))


def _random_state(model: StereoUNet) -> dict[str, torch.Tensor]:
    """Every parameter and statistic of ``model``'s layout, none a fresh draw's."""
    rng = np.random.default_rng(5)
    return {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in model.state_dict().items() if k in torch_key_map()}


def test_init_checkpoint_without_logvar_head_keeps_the_fresh_zero_bias_head(tmp_path) -> None:
    """``--init-checkpoint``'s loader: every entry the checkpoint holds is
    loaded, and the logvar head it lacks stays the fresh one, bias 0, as the
    JAX package's loader keeps its fresh head (its ``models/compat.py``)."""
    fresh = _small(42)
    head = fresh.logvar_head.weight.detach().clone()
    source = {k: v for k, v in _random_state(fresh).items() if not k.startswith("logvar_head")}
    torch.save({"model_state_dict": source, "epoch": 3}, tmp_path / "init.pt")
    loaded = load_model_variables(tmp_path / "init.pt", fresh)
    assert sorted(loaded["missing_keys"]) == ["logvar_head.bias", "logvar_head.weight"]
    assert not loaded["has_uncertainty_head"]
    state = fresh.state_dict()
    for key, value in source.items():
        assert torch.equal(state[key], value), key
    assert torch.equal(state["logvar_head.weight"], head)
    assert not state["logvar_head.bias"].any()



def test_resume_overwrites_every_parameter(tmp_path) -> None:
    trained = _small(1)
    trained.load_state_dict(_random_state(trained), strict=False)
    saved = save_checkpoint(
        tmp_path, "last", create_train_state(trained, make_adamw(trained.parameters(), 1e-3, 1e-4)),
        epoch=1, config={}, metrics={})
    fresh = _small(2)
    state, _ = load_train_state(saved, create_train_state(
        fresh, make_adamw(fresh.parameters(), 1e-3, 1e-4)))
    want = trained.state_dict()
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, want[key]), key
