"""Train / eval steps, AdamW with the JAX package's schedules, predict fn.

Counterpart of ``stereo_depth_estimation_tpu/parallel/train_step.py`` on one
device. One train step: uint8 batch -> augmentation (the CUDA kernel for CUDA
tensors) -> StereoUNet forward with uncertainty -> masked Laplace NLL ->
backward -> AdamW, with the zero-valid-batch no-op gate. Nothing in the step
waits for the host: the loss statistics come back as device tensors, the
learning rate is computed on the device from AdamW's own step count, and the
no-op gate selects on the device.

PyTorch updates in place where JAX returns new arrays: a step mutates the
``TrainState`` it is given (model weights, BatchNorm running stats, optimizer
state, step, generator) and returns it with the batch's ``LossStats``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..models.unet import StereoUNet
from ..ops.augment import AugmentConfig, augment_stereo_batch
from ..ops.augment_cuda import augment_stereo_batch_fused
from ..ops.loss import LossStats, heteroscedastic_laplace_nll

Batch = dict[str, torch.Tensor]


@dataclass
class TrainState:
    model: StereoUNet
    optimizer: torch.optim.AdamW
    generator: torch.Generator  # all of the step's randomness, on the model's device
    step: int = 0  # steps taken, zero-valid batches included


def make_lr_schedule(
    lr: float, schedule: str = "constant", total_steps: int = 0, warmup_steps: int = 0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Learning rate as a function of the optimizer's update count (a float32
    tensor), with the values of the JAX package's optax schedules:
    ``"constant"``; ``"cosine"`` decays to 0 over ``total_steps``
    (optax.cosine_decay_schedule); with ``warmup_steps`` it first ramps
    linearly from 0 (optax.warmup_cosine_decay_schedule)."""
    if schedule == "constant":
        return lambda count: torch.full_like(count, lr)
    if schedule != "cosine":
        raise ValueError(f"Unknown lr schedule {schedule!r} (constant|cosine)")
    if total_steps <= 0:
        raise ValueError(f"cosine schedule needs total_steps > 0 (got {total_steps})")
    decay_steps = float(total_steps - max(warmup_steps, 0))
    if decay_steps <= 0:
        raise ValueError(
            f"cosine schedule needs total_steps > warmup_steps "
            f"(got {total_steps} <= {warmup_steps})"
        )

    def cosine(count: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(count, max=decay_steps)
        return lr * (0.5 * (1.0 + torch.cos(math.pi * count / decay_steps)))

    if warmup_steps <= 0:
        return cosine

    def warmup_cosine(count: torch.Tensor) -> torch.Tensor:
        ramp = torch.clamp(count, 0.0, float(warmup_steps))
        linear = (0.0 - lr) * (1.0 - ramp / warmup_steps) + lr
        return torch.where(count < warmup_steps, linear, cosine(count - warmup_steps))

    return warmup_cosine


def make_adamw(
    params,
    lr: float,
    weight_decay: float,
    schedule: str = "constant",
    total_steps: int = 0,
    warmup_steps: int = 0,
) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8, decay on every
    parameter) whose learning rate follows ``make_lr_schedule``.

    The learning rate is a 0-dim tensor on the parameters' device, refreshed
    by the train step from AdamW's step count, which stays unchanged across a
    zero-valid batch as optax's count does. On CUDA the optimizer is
    ``capturable`` so that count lives on the card and nothing syncs. The
    optimizer state is created here, not at the first step, so the step can
    snapshot it. ``optimizer.lr_schedule`` holds the schedule."""
    lr_schedule = make_lr_schedule(lr, schedule, total_steps, warmup_steps)
    params = list(params)
    device = params[0].device
    capturable = device.type == "cuda"
    lr_tensor = torch.tensor(lr, dtype=torch.float32, device=device)
    opt = torch.optim.AdamW(
        params, lr=lr_tensor, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay, capturable=capturable,
        # The plain for-loop update takes a tensor lr without capturable.
        foreach=None if capturable else False,
    )
    for p in params:
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32,
                                device=device if capturable else "cpu"),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    opt.lr_schedule = lr_schedule  # type: ignore[attr-defined]
    return opt


def create_train_state(
    model: StereoUNet, optimizer: torch.optim.AdamW, seed: int = 0
) -> TrainState:
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def _prepare_input(inputs: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32/255; float inputs pass through as float32."""
    if inputs.dtype == torch.uint8:
        return inputs.to(torch.float32) * (1.0 / 255.0)
    return inputs.to(torch.float32)


def _targets_and_mask(batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
    target = batch["target"].to(torch.float32)
    # valid = target > 0; non-finite targets are masked inside the loss.
    mask = batch.get("valid_mask")
    if mask is None:
        mask = target > 0.0
    elif mask.ndim == 1:
        # Rank-1 per-row flags (rows flagged False are padding), combined
        # with the per-pixel validity rule.
        mask = (target > 0.0) & mask[:, None, None]
    return target, mask


def _gated_tensors(state: TrainState) -> list[torch.Tensor]:
    """Everything a step changes that a zero-valid batch must leave as it was:
    parameters, BatchNorm buffers, AdamW moments and step counts."""
    tensors = [p.detach() for p in state.model.parameters()]
    tensors += list(state.model.buffers())
    for p_state in state.optimizer.state.values():
        tensors += [p_state["exp_avg"], p_state["exp_avg_sq"], p_state["step"]]
    return tensors


def _set_learning_rate(optimizer: torch.optim.AdamW) -> None:
    first = next(iter(optimizer.state.values()))
    lr = optimizer.lr_schedule(first["step"])  # type: ignore[attr-defined]
    for group in optimizer.param_groups:
        group["lr"].copy_(lr)


def _augmented_inputs(
    state: TrainState, raw: torch.Tensor, augment_config: AugmentConfig | None
) -> torch.Tensor:
    if augment_config is None:
        return _prepare_input(raw)
    if raw.dtype == torch.uint8 and augment_config.impl != "plain":
        # The fused chain reads the uint8 batch and writes the model's
        # compute dtype (bf16 halves its writes); on CUDA it is the kernel.
        return augment_stereo_batch_fused(
            state.generator, raw, augment_config, out_dtype=state.model.compute_dtype
        )
    return augment_stereo_batch(state.generator, _prepare_input(raw), augment_config)


def make_train_step(
    augment_config: AugmentConfig | None = None,
) -> Callable[[TrainState, Batch], tuple[TrainState, LossStats]]:
    """Train step on a batch {input (N,H,W,6) u8/f32, target (N,H,W),
    optional valid_mask}: augment -> forward -> loss -> backward -> AdamW."""

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, LossStats]:
        model, optimizer = state.model, state.optimizer
        inputs = _augmented_inputs(state, batch["input"], augment_config)
        target, mask = _targets_and_mask(batch)

        # Zero-valid-batch no-op, decided on the device without a host sync:
        # snapshot what the step changes (BatchNorm running stats change
        # inside forward, so before it), run the step, then select old or new
        # per tensor on valid_count > 0. It costs one copy and one select of
        # the weights and the two Adam moments (~93 MB each way at base 32),
        # where reading valid_count on the host would stall the step.
        gated = _gated_tensors(state)
        snapshot = [t.clone() for t in gated]

        model.train()
        disp, logvar = model(inputs, return_uncertainty=True)
        loss, stats = heteroscedastic_laplace_nll(
            disp[..., 0], logvar[..., 0], target, mask
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _set_learning_rate(optimizer)
        optimizer.step()

        has_valid = stats.valid_count > 0
        with torch.no_grad():
            for live, old in zip(gated, snapshot):
                live.copy_(torch.where(has_valid, live, old))
        state.step += 1
        return state, LossStats(*(s.detach() for s in stats))

    return step


class DeviceDataTrainStep:
    """ONE train step per call over a DEVICE-RESIDENT dataset.

    Each epoch draws a ``torch.randperm`` of the samples from the state's
    generator; step ``pos`` of the epoch gathers rows
    ``perm[pos*B:(pos+1)*B]`` with ``index_select`` on the device. Nothing
    crosses to the host per step."""

    def __init__(
        self,
        images_u8: torch.Tensor,
        targets: torch.Tensor,
        batch_size: int,
        step_fn: Callable[[TrainState, Batch], tuple[TrainState, LossStats]],
    ) -> None:
        n = images_u8.shape[0]
        self.steps_per_epoch = n // batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"dataset of {n} samples is smaller than batch_size={batch_size}"
            )
        self.images_u8 = images_u8
        self.targets = targets
        self.batch_size = batch_size
        self.step_fn = step_fn
        self._epoch = -1
        self._perm: torch.Tensor | None = None

    def gather(self, state: TrainState) -> Batch:
        epoch, pos = divmod(state.step, self.steps_per_epoch)
        if epoch != self._epoch or self._perm is None:
            self._perm = torch.randperm(
                self.images_u8.shape[0],
                generator=state.generator,
                device=self.images_u8.device,
            )
            self._epoch = epoch
        idx = self._perm[pos * self.batch_size : (pos + 1) * self.batch_size]
        return {
            "input": self.images_u8.index_select(0, idx),
            "target": self.targets.index_select(0, idx),
        }

    def __call__(self, state: TrainState) -> tuple[TrainState, LossStats]:
        return self.step_fn(state, self.gather(state))


def make_device_data_train_step(
    images_u8: torch.Tensor,
    targets: torch.Tensor,
    batch_size: int,
    augment_config: AugmentConfig | None = None,
    step_fn: Callable[[TrainState, Batch], tuple[TrainState, LossStats]] | None = None,
) -> DeviceDataTrainStep:
    """A train step that gathers its batch from a device-resident payload:
    ``run(state) -> (state, stats)``."""
    return DeviceDataTrainStep(
        images_u8, targets, batch_size, step_fn or make_train_step(augment_config)
    )


def make_eval_step() -> Callable[[TrainState, Batch], LossStats]:
    """Eval: running BN stats, no augmentation, metric sums only."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> LossStats:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            disp, logvar = model(_prepare_input(batch["input"]), return_uncertainty=True)
        finally:
            model.train(was_training)
        target, mask = _targets_and_mask(batch)
        _, stats = heteroscedastic_laplace_nll(
            disp[..., 0], logvar[..., 0], target, mask
        )
        return stats

    return eval_step


def make_predict_fn(
    model: StereoUNet,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Inference: input NHWC (uint8 or float) -> (disparity, logvar), each
    (N, H, W) float32, with running BN stats."""

    @torch.inference_mode()
    def predict(inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            disp, logvar = model(_prepare_input(inputs), return_uncertainty=True)
        finally:
            model.train(was_training)
        return disp[..., 0], logvar[..., 0]

    return predict
