"""PyTorch StereoUNet held against the flax StereoUNet on the CPU.

Weights come from the JAX package's own init and cross with
``state_dict_from_jax``; the same numpy input goes through both. float32
tolerance: atol 1e-4 (a dozen conv + BatchNorm layers in float32, sums taken
in another order by each framework's CPU convolution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.models.compat import export_torch_state_dict
from stereo_depth_estimation_tpu_torch.models import StereoUNet, count_params
from stereo_depth_estimation_tpu_torch.models.compat import (
    load_torch_state_dict,
    state_dict_from_jax,
    torch_key_map,
)

BASE = 8
SHAPE = (2, 32, 48, 6)


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX package's own init (jitted: one compile for the whole file)."""
    model = JaxUNet(base_channels=BASE)
    init = jax.jit(
        lambda key: model.init(
            key, jnp.zeros(SHAPE, jnp.float32), train=False, return_uncertainty=True
        )
    )
    return init(jax.random.key(0))


def _jax_apply(variables, x, train: bool, dtype=jnp.float32):
    model = JaxUNet(base_channels=BASE, compute_dtype=dtype)
    kwargs = {"mutable": ["batch_stats"]} if train else {}
    return jax.jit(
        lambda v, xx: model.apply(v, xx, train=train, return_uncertainty=True, **kwargs)
    )(variables, jnp.asarray(x))


def _port(variables, dtype=torch.float32) -> StereoUNet:
    model = StereoUNet(base_channels=BASE, compute_dtype=dtype, device="cpu")
    missing, unexpected = load_torch_state_dict(model, state_dict_from_jax(variables))
    assert not missing and not unexpected
    return model


def _input(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, SHAPE).astype(np.float32)


def _running_stats(model: StereoUNet) -> dict[str, np.ndarray]:
    return {
        k: v.numpy() for k, v in model.state_dict().items()
        if k.endswith(("running_mean", "running_var"))
    }


def test_full_size_param_count() -> None:
    # The figure tests/test_model.py::test_full_size_param_count pins.
    assert count_params(StereoUNet(base_channels=32, device="cpu")) == 7_763_938


def test_state_dict_from_jax_equals_jax_exporter(jax_variables) -> None:
    variables = jax_variables
    ours = state_dict_from_jax(variables)
    theirs = export_torch_state_dict(variables)
    assert set(ours) == set(theirs) == set(torch_key_map())
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_train_forward_and_running_stats_match_flax_f32(jax_variables) -> None:
    variables = jax_variables
    x = _input()
    (jd, jl), mutated = _jax_apply(variables, x, train=True)
    model = _port(variables)
    model.train()
    with torch.no_grad():
        td, tl = model(torch.from_numpy(x), return_uncertainty=True)
    assert td.shape == (2, 32, 48, 1) and tl.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)

    expected = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    )
    for key, value in _running_stats(model).items():
        np.testing.assert_allclose(value, expected[key].numpy(), atol=1e-4, err_msg=key)


def test_eval_forward_matches_flax_f32(jax_variables) -> None:
    # Non-trivial running stats: one train-mode pass on the JAX side first.
    _, mutated = _jax_apply(jax_variables, _input(3), train=True)
    variables = {
        "params": jax_variables["params"], "batch_stats": mutated["batch_stats"]
    }
    x = _input(4)
    jd, jl = _jax_apply(variables, x, train=False)
    model = _port(variables)
    model.eval()
    with torch.no_grad():
        td, tl = model(torch.from_numpy(x), return_uncertainty=True)
        t_only = model(torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(t_only.numpy(), td.numpy())
    assert float(td.min()) >= 0.0
    assert -6.0 <= float(tl.min()) and float(tl.max()) <= 3.0


def test_train_forward_matches_flax_bf16(jax_variables) -> None:
    """bf16 compute, f32 parameters and BatchNorm statistics on both sides.
    The JAX BatchNorm normalises in bf16 while PyTorch normalises in f32 and
    rounds the result to bf16, so activations differ by a few bf16 ulps
    (2^-8 relative each) layer by layer; the gap is of the order of the JAX
    package's own bf16-vs-f32 gap on this input (about 0.05). Tolerance:
    atol 0.1 on outputs of order 1, and running stats within 0.05 + 2% of
    their size."""
    variables = jax_variables
    x = _input(5)
    (jd, jl), mutated = _jax_apply(variables, x, train=True, dtype=jnp.bfloat16)
    model = _port(variables, torch.bfloat16)
    model.train()
    with torch.no_grad():
        td, tl = model(torch.from_numpy(x), return_uncertainty=True)
    assert td.dtype == tl.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd, np.float32), atol=0.1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), atol=0.1)
    expected = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    )
    for key, value in _running_stats(model).items():
        assert value.dtype == np.float32
        np.testing.assert_allclose(
            value, expected[key].numpy(), rtol=0.02, atol=0.05, err_msg=key
        )


def test_legacy_output_head_is_renamed(jax_variables) -> None:
    variables = jax_variables
    sd = state_dict_from_jax(variables)
    sd["output_head.weight"] = sd.pop("disparity_head.weight") + 1.0
    sd["output_head.bias"] = sd.pop("disparity_head.bias") + 1.0
    model = _port(variables)
    missing, unexpected = load_torch_state_dict(model, sd)
    assert not missing and not unexpected
    np.testing.assert_array_equal(
        model.disparity_head.weight.detach().numpy(), sd["output_head.weight"].numpy()
    )
    np.testing.assert_array_equal(
        model.disparity_head.bias.detach().numpy(), sd["output_head.bias"].numpy()
    )


def test_missing_logvar_head_keeps_fresh_init(jax_variables) -> None:
    sd = state_dict_from_jax(jax_variables)
    del sd["logvar_head.weight"], sd["logvar_head.bias"]
    sd["extra.weight"] = torch.zeros(1)
    model = StereoUNet(
        base_channels=BASE, device="cpu", generator=torch.Generator().manual_seed(0)
    )
    fresh = model.logvar_head.weight.detach().clone()
    missing, unexpected = load_torch_state_dict(model, sd)
    assert sorted(missing) == ["logvar_head.bias", "logvar_head.weight"]
    assert unexpected == ["extra.weight"]
    np.testing.assert_array_equal(model.logvar_head.weight.detach().numpy(), fresh.numpy())
    np.testing.assert_array_equal(
        model.enc1.block[0].weight.detach().numpy(), sd["enc1.block.0.weight"].numpy()
    )


def test_shape_mismatch_raises() -> None:
    model = StereoUNet(base_channels=BASE, device="cpu")
    with pytest.raises(ValueError, match="Shape mismatch"):
        load_torch_state_dict(model, {"up4.bias": torch.zeros(3)})


@pytest.mark.parametrize("hw", [(24, 32), (32, 40)])
def test_sides_not_divisible_by_16_raise(hw) -> None:
    model = StereoUNet(base_channels=4, device="cpu")
    with pytest.raises(ValueError, match="divisible by 16"):
        model(torch.zeros((1, *hw, 6)))


def test_seeded_init_is_reproducible_and_channels_last() -> None:
    a = StereoUNet(base_channels=4, device="cpu", generator=torch.Generator().manual_seed(7))
    b = StereoUNet(base_channels=4, device="cpu", generator=torch.Generator().manual_seed(7))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    w = a.enc2.block[0].weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    bound = 1.0 / np.sqrt(w.shape[1] * 9)
    assert float(w.abs().max()) <= bound
