"""PyTorch train / eval / predict steps held against the JAX package on the CPU.

Both sides start from the JAX package's init (carried across with
``state_dict_from_jax``) and take the same numpy batch. One step in float32
is compared at atol 1e-4: loss statistics, then weights, BatchNorm running
stats and Adam moments after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_depth_estimation_tpu.models import StereoUNet as JaxUNet
from stereo_depth_estimation_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from stereo_depth_estimation_tpu.parallel import train_step as J
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import (
    load_torch_state_dict,
    state_dict_from_jax,
)
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
from stereo_depth_estimation_tpu_torch.ops.loss import LossStats
from stereo_depth_estimation_tpu_torch.parallel import train_step as P

BASE = 4
HW = (32, 48)
LR, WD = 1e-3, 1e-4
ATOL = 1e-4


def _batch(seed: int, n: int = 4, uint8: bool = False) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 1, (n, *HW, 3)).astype(np.float32)
    right = np.clip(left * 0.8 + rng.uniform(0, 0.2, (n, 1, 1, 1)), 0, 1)
    inputs = np.concatenate([left, right], axis=-1).astype(np.float32)
    if uint8:
        inputs = np.round(inputs * 255).astype(np.uint8)
    target = (left.mean(-1) * 4.0 + 1.0).astype(np.float32)
    target[:, :3, :] = 0.0  # invalid rows
    target[0, 5, 5] = np.nan
    return {"input": inputs, "target": target}


@pytest.fixture(scope="module")
def jax_setup():
    model = JaxUNet(base_channels=BASE)
    tx = J.make_adamw(LR, WD)
    init = jax.jit(lambda key: J.create_train_state(model, key, HW, tx))
    return model, tx, init(jax.random.key(0))


def _variables(state) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats}


def _port_state(jax_state, seed: int = 0) -> P.TrainState:
    model = StereoUNet(base_channels=BASE, device="cpu")
    missing, unexpected = load_torch_state_dict(model, state_dict_from_jax(_variables(jax_state)))
    assert not missing and not unexpected
    return P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), seed)


def _torch_batch(batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_stats_close(ts: LossStats, js) -> None:
    for name in LossStats._fields:
        np.testing.assert_allclose(
            float(getattr(ts, name)), float(getattr(js, name)), rtol=1e-5, atol=ATOL,
            err_msg=name,
        )


def _assert_weights_close(state: P.TrainState, jax_state) -> None:
    """Weights and BN running stats at atol 1e-4, after ONE AdamW step.

    Adam's first update is lr * g / (|g| + 1e-8): where |g| is below ~1e-6
    it is set by float noise in g, which each framework's gradient carries
    differently (about 1e-8), and may land anywhere in [-lr, lr]. Those
    elements (under 2% of the weights, most in the 2x3 bottleneck) are held
    to 2 lr + 1e-4 instead."""
    expected = state_dict_from_jax(_variables(jax_state))
    grads = {
        k: v.numpy() / 0.1  # first step: mu = (1 - 0.9) g
        for k, v in state_dict_from_jax({"params": jax_state.opt_state[0].mu}).items()
    }
    ours = state.model.state_dict()
    noisy = total = 0
    for key, value in expected.items():
        tol = np.full(value.shape, ATOL, np.float32)
        if key in grads:
            quiet = np.abs(grads[key]) < 1e-6
            tol[quiet] = 2 * LR + ATOL
            noisy += int(quiet.sum())
            total += quiet.size
        err = np.abs(ours[key].numpy() - value.numpy())
        assert np.all(err <= tol), f"{key}: max err {err.max()}"
    assert noisy < 0.02 * total


def _moments(state: P.TrainState) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    return {
        name: (
            state.optimizer.state[p]["exp_avg"].numpy(),
            state.optimizer.state[p]["exp_avg_sq"].numpy(),
        )
        for name, p in state.model.named_parameters()
    }


def test_one_step_matches_jax_step_body_f32(jax_setup) -> None:
    model, tx, jstate = jax_setup
    batch = _batch(1)
    body = jax.jit(J._make_step_body(model, tx, None))
    with jax.default_matmul_precision("highest"):
        jnew, jstats = body(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    state = _port_state(jstate)
    state, stats = P.make_train_step(None)(state, _torch_batch(batch))
    assert state.step == 1
    _assert_stats_close(stats, jstats)
    _assert_weights_close(state, jnew)

    adam = jnew.opt_state[0]  # optax.adamw: (scale_by_adam, decay, lr)
    assert int(adam.count) == 1
    mu = state_dict_from_jax({"params": adam.mu})
    nu = state_dict_from_jax({"params": adam.nu})
    for name, (m, v) in _moments(state).items():
        np.testing.assert_allclose(m, mu[name].numpy(), atol=ATOL, err_msg=name)
        # nu = 0.001 g^2 is small: also held to 1e-3 of its size.
        np.testing.assert_allclose(v, nu[name].numpy(), rtol=1e-3, atol=1e-8, err_msg=name)
    for p_state in state.optimizer.state.values():
        assert float(p_state["step"]) == 1.0


def test_zero_valid_batch_is_noop(jax_setup) -> None:
    """Weights, BN running stats, Adam moments and Adam's step count stay as
    they were; the train step counter still advances. The next valid step
    then equals a first step from the same weights (the lr schedule did not
    move either)."""
    _, _, jstate = jax_setup
    state = _port_state(jstate)
    step = P.make_train_step(None)
    before = [t.clone() for t in P._gated_tensors(state)]
    empty = _batch(2)
    empty["target"] = np.zeros_like(empty["target"])
    state, stats = step(state, _torch_batch(empty))
    assert float(stats.valid_count) == 0.0 and float(stats.nll_sum) == 0.0
    assert state.step == 1
    after = P._gated_tensors(state)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)

    # Rank-1 row flags that mark every row invalid are a no-op too.
    flagged = _torch_batch(_batch(3))
    flagged["valid_mask"] = torch.zeros(4, dtype=torch.bool)
    state, stats = step(state, flagged)
    assert float(stats.valid_count) == 0.0
    for a, b in zip(P._gated_tensors(state), before):
        assert torch.equal(a, b)

    valid = _torch_batch(_batch(4))
    state, _ = step(state, valid)
    fresh, _ = step(_port_state(jstate), valid)
    for (k, a), (_, b) in zip(
        state.model.state_dict().items(), fresh.model.state_dict().items()
    ):
        assert torch.equal(a, b), k


def test_rank1_valid_mask_rows_match_jax(jax_setup) -> None:
    model, _, jstate = jax_setup
    batch = _batch(5)
    flags = np.array([True, False, True, True])
    jstats = jax.jit(J.make_eval_step(model))(
        jstate, {**{k: jnp.asarray(v) for k, v in batch.items()}, "valid_mask": jnp.asarray(flags)}
    )
    tb = _torch_batch(batch)
    tb["valid_mask"] = torch.from_numpy(flags)
    stats = P.make_eval_step()(_port_state(jstate), tb)
    expected = ((batch["target"] > 0) & flags[:, None, None] & np.isfinite(batch["target"])).sum()
    assert float(stats.valid_count) == float(expected)
    _assert_stats_close(stats, jstats)


@pytest.mark.parametrize(
    "schedule",
    [
        {"schedule": "constant"},
        {"schedule": "cosine", "total_steps": 10},
        {"schedule": "cosine", "total_steps": 10, "warmup_steps": 3},
    ],
    ids=["constant", "cosine", "warmup_cosine"],
)
def test_lr_schedules_match_make_adamw(schedule) -> None:
    """make_adamw's learning rate at each step, read off its updates: with
    no decay, an update is -lr times Adam's direction, which a constant-lr
    twin fed the same gradients shares, so lr = LR * update / twin_update.
    The port's learning rate at each step must equal it, past the end of the
    decay too."""
    steps = 13
    params = {"w": jnp.ones((3,), jnp.float32)}
    grads = {"w": jnp.array([1.0, -0.5, 0.25], jnp.float32)}
    txs = [J.make_adamw(LR, 0.0, **schedule), J.make_adamw(LR, 0.0)]
    states = [tx.init(params) for tx in txs]
    expected = []
    for _ in range(steps):
        ups = []
        for i, tx in enumerate(txs):
            up, states[i] = tx.update(grads, states[i], params)
            ups.append(float(up["w"][0]))
        expected.append(LR * ups[0] / ups[1])

    w = torch.nn.Parameter(torch.ones(3))
    opt = P.make_adamw([w], LR, 0.0, **schedule)
    got = []
    for _ in range(steps):
        w.grad = torch.ones(3)
        P._set_learning_rate(opt)
        got.append(float(opt.param_groups[0]["lr"]))
        opt.step()
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-12)
    if schedule["schedule"] == "cosine":
        assert got[-1] == expected[-1] == 0.0  # decayed to 0 and held there
    assert float(w[0]) == pytest.approx(1.0 - sum(got), abs=1e-6)


def test_schedule_misconfiguration_raises() -> None:
    w = [torch.nn.Parameter(torch.ones(1))]
    with pytest.raises(ValueError, match="total_steps"):
        P.make_adamw(w, 1e-3, 0.0, schedule="cosine")
    with pytest.raises(ValueError, match="warmup_steps"):
        P.make_adamw(w, 1e-3, 0.0, schedule="cosine", total_steps=5, warmup_steps=5)
    with pytest.raises(ValueError, match="Unknown lr schedule"):
        P.make_adamw(w, 1e-3, 0.0, schedule="linear")


def test_device_data_gather_visits_each_index_once_per_epoch() -> None:
    n, batch_size = 12, 4
    ids = torch.arange(n, dtype=torch.uint8)
    images = ids[:, None, None, None].expand(n, 2, 2, 6).contiguous()
    targets = ids.float()[:, None, None].expand(n, 2, 2).contiguous()

    def fake_step(state, batch):
        state.step += 1
        return state, batch

    def run(seed: int, epochs: int) -> list[list[int]]:
        model = StereoUNet(base_channels=4, device="cpu")
        state = P.create_train_state(model, P.make_adamw(model.parameters(), LR, WD), seed)
        runner = P.make_device_data_train_step(images, targets, batch_size, step_fn=fake_step)
        assert runner.steps_per_epoch == 3
        seen = []
        for _ in range(epochs):
            epoch = []
            for _ in range(runner.steps_per_epoch):
                state, batch = runner(state)
                assert torch.equal(batch["input"][:, 0, 0, 0].float(), batch["target"][:, 0, 0])
                epoch += batch["input"][:, 0, 0, 0].tolist()
            seen.append(epoch)
        return seen

    a = run(seed=0, epochs=3)
    for epoch in a:
        assert sorted(epoch) == list(range(n))
    assert a[0] != a[1] or a[1] != a[2]  # a fresh permutation each epoch
    assert run(seed=0, epochs=3) == a
    assert run(seed=1, epochs=3) != a
    with pytest.raises(ValueError, match="smaller than batch_size"):
        P.make_device_data_train_step(images, targets, 13)


def test_eval_step_and_predict_fn_match_jax(jax_setup) -> None:
    model, _, jstate = jax_setup
    batch = _batch(6, uint8=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstats = jax.jit(J.make_eval_step(model))(jstate, jbatch)
    jdisp, jlogvar = J.make_predict_fn(model)(jstate.params, jstate.batch_stats, jbatch["input"])

    state = _port_state(jstate)
    state.model.train()
    stats = P.make_eval_step()(state, _torch_batch(batch))
    _assert_stats_close(stats, jstats)
    disp, logvar = P.make_predict_fn(state.model)(torch.from_numpy(batch["input"]))
    assert state.model.training  # the caller's mode is restored
    assert disp.shape == logvar.shape == (4, *HW)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), atol=ATOL)


def test_augmented_step_matches_jax_pallas_step(jax_setup) -> None:
    """The slice as a whole: uint8 batch -> fused augmentation -> forward ->
    loss -> backward -> AdamW, on the JAX side through make_train_step with
    the Pallas kernel (interpret mode on the CPU), on the port's side through
    the fused path (the kernel's plain version on the CPU). Every draw is
    deterministic (jitters 0, no noise, no blur), so both apply brightness,
    contrast, saturation and gamma 1 and hue 0 through the whole chain, the
    rgb->hsv->rgb round trip included."""
    model, tx, jstate = jax_setup
    still = dict(
        brightness_jitter=0.0, contrast_jitter=0.0, saturation_jitter=0.0,
        hue_jitter=0.0, gamma_jitter=0.0, noise_std_max=0.0, blur_prob=0.0,
    )
    batch = _batch(7, uint8=True)
    state = _port_state(jstate)  # before the JAX step donates jstate's buffers

    jstep = J.make_train_step(model, tx, JaxAugmentConfig(impl="pallas", **still))
    with jax.default_matmul_precision("highest"):
        jnew, jstats = jstep(
            jax.tree.map(jnp.copy, jstate), {k: jnp.asarray(v) for k, v in batch.items()}
        )

    state, stats = P.make_train_step(AugmentConfig(**still))(state, _torch_batch(batch))
    _assert_stats_close(stats, jstats)
    _assert_weights_close(state, jnew)


def test_device_data_train_loop_matches_jax_loop(jax_setup) -> None:
    """K = 3 steps in one call against the JAX ``make_device_data_train_loop``:
    float32, no augmentation, the batch the whole payload (one step an
    epoch, so the two frameworks' permutations only reorder a batch). Each
    step's LossStats within this file's tolerances."""
    model, tx, jstate = jax_setup
    data = _batch(11, uint8=True)
    jloop = J.make_device_data_train_loop(
        model, tx, jnp.asarray(data["input"]), jnp.asarray(data["target"]), 4, None,
        steps_per_call=3)
    with jax.default_matmul_precision("highest"):
        _, jstats = jloop(jax.tree.map(jnp.copy, jstate))

    loop = P.make_device_data_train_loop(
        torch.from_numpy(data["input"]), torch.from_numpy(data["target"]), 4, None,
        steps_per_call=3)
    state, stats = loop(_port_state(jstate))
    assert state.step == 3
    assert all(tuple(s.shape) == (3,) for s in stats)
    for k in range(3):
        _assert_stats_close(LossStats(*(s[k] for s in stats)),
                            LossStats(*(np.asarray(s)[k] for s in jstats)))


def test_device_data_train_loop_is_k_device_data_steps(jax_setup) -> None:
    """The loop's stacked LossStats and the weights after it are bitwise
    those of K calls of ``make_device_data_train_step`` from the same state
    and generator (a payload of two batches: the K = 3 steps cross an
    epoch, so the permutations are drawn in the same order)."""
    _, _, jstate = jax_setup
    data = _torch_batch(_batch(12, n=8, uint8=True))
    images, targets = data["input"], data["target"]
    loop_state, loop_stats = P.make_device_data_train_loop(images, targets, 4, None, 3)(
        _port_state(jstate))
    step = P.make_device_data_train_step(images, targets, 4)
    state, stats = _port_state(jstate), []
    for _ in range(3):
        state, s = step(state)
        stats.append(s)
    for name, got in zip(LossStats._fields, loop_stats):
        assert torch.equal(got, torch.stack([getattr(s, name) for s in stats])), name
    for (k, a), b in zip(loop_state.model.state_dict().items(),
                         state.model.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="steps_per_call must be at least 1"):
        P.make_device_data_train_loop(images, targets, 4, None, 0)
