"""PyTorch port of ops/loss.py held against the JAX package on the CPU.

The same numpy arrays (made from a seed) go through both; tolerance rtol 1e-6,
atol 1e-5 (float32 sums over a few thousand pixels, taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.ops import loss as jloss
from stereo_depth_estimation_tpu_torch.ops import loss as tloss

RTOL, ATOL = 1e-6, 1e-5


def _inputs(seed: int, shape=(2, 12, 16)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    logvar = rng.uniform(-2.0, 3.0, shape).astype(np.float32)
    target = rng.uniform(-1.0, 10.0, shape).astype(np.float32)
    target.flat[rng.choice(target.size, 20, replace=False)] = np.nan
    target.flat[rng.choice(target.size, 10, replace=False)] = np.inf
    target.flat[rng.choice(target.size, 10, replace=False)] = -np.inf
    valid = (target > 0) | (rng.uniform(size=shape) < 0.1)  # some NaN/inf stay "valid"
    return pred, logvar, target, valid


def _both(pred, logvar, target, valid):
    jl, js = jloss.heteroscedastic_laplace_nll(
        jnp.asarray(pred), jnp.asarray(logvar), jnp.asarray(target), jnp.asarray(valid)
    )
    tl, ts = tloss.heteroscedastic_laplace_nll(
        torch.from_numpy(pred), torch.from_numpy(logvar),
        torch.from_numpy(target), torch.from_numpy(valid),
    )
    return (jl, js), (tl, ts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_stats_match_jax_with_nonfinite_targets(seed) -> None:
    (jl, js), (tl, ts) = _both(*_inputs(seed))
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    for name in jloss.LossStats._fields:
        np.testing.assert_allclose(
            float(getattr(ts, name)), float(getattr(js, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )


def test_all_invalid_batch_gives_zero_loss_and_zero_grads() -> None:
    pred, logvar, target, _ = _inputs(3)
    valid = np.zeros_like(target, dtype=bool)
    (jl, js), (tl, ts) = _both(pred, logvar, target, valid)
    assert float(tl) == float(jl) == 0.0
    for name in jloss.LossStats._fields:
        assert float(getattr(ts, name)) == float(getattr(js, name)) == 0.0

    p = torch.from_numpy(pred).requires_grad_()
    lv = torch.from_numpy(logvar).requires_grad_()
    loss, _ = tloss.heteroscedastic_laplace_nll(
        p, lv, torch.from_numpy(target), torch.from_numpy(valid)
    )
    loss.backward()
    assert p.grad is not None and lv.grad is not None
    assert float(p.grad.abs().max()) == 0.0 and float(lv.grad.abs().max()) == 0.0


def test_metrics_and_accumulation_match_jax() -> None:
    jtotal, ttotal = None, None
    for seed in (4, 5):
        (_, js), (_, ts) = _both(*_inputs(seed))
        jtotal = jloss.accumulate_stats(jtotal, js)
        ttotal = tloss.accumulate_stats(ttotal, ts)
    jm = jloss.metrics_from_stats(jtotal)
    tm = tloss.metrics_from_stats(ttotal)
    assert set(jm) == set(tm) == {"loss", "nll", "mae", "rmse", "sigma"}
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_metrics_from_empty_stats_raise() -> None:
    zero = torch.zeros(())
    with pytest.raises(RuntimeError, match="No valid target pixels"):
        tloss.metrics_from_stats(tloss.LossStats(zero, zero, zero, zero, zero))
