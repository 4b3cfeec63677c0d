"""Train / eval steps, AdamW with the JAX package's schedules, predict fn.

Counterpart of ``stereo_depth_estimation_tpu/parallel/train_step.py``. One
train step: uint8 batch -> augmentation (the CUDA kernel for CUDA
tensors) -> model forward -> the model's loss -> backward -> AdamW, with
the zero-valid-batch no-op gate. The steps name no network: they call the
model with its ``step_kwargs`` and take the loss and ``LossStats`` of its
outputs from its ``step_loss`` (the StereoUNet: the forward with
uncertainty and the masked Laplace NLL; PSMNet: three outputs and the
weighted smooth L1). Nothing in the step waits for the host: the loss
statistics come back as device tensors, the learning rate is computed on
the device from AdamW's own step count, and the no-op gate decides on the
device. ``make_device_data_train_loop`` runs K such
steps over a device-resident payload per call and stacks their stats on the
device (JAX ``make_device_data_train_loop``).

PyTorch updates in place where JAX returns new arrays: a step mutates the
``TrainState`` it is given (model weights, BatchNorm running stats, optimizer
state, step, generator) and returns it with the batch's ``LossStats``.

Under a ``torch.profiler`` capture the step's stages are spans
(``spans.py``): ``train.step`` around the step, and inside it
``train.augment`` (with ``train.augment.noise``), ``train.gate.snapshot``,
``train.forward``, ``train.loss``, ``train.backward``, ``train.optimizer``
and ``train.gate.select``; a device-resident step's gather is
``train.gather``, before its ``train.step``.

The zero-valid gate (``ops/gate.py``) is the state's ``ZeroValidGate``: a
table of the gated tensors' byte ranges and one flat snapshot buffer, built
at the first step and again only when those tensors' memory changes. On
CUDA it is two launches a step of ``csrc/gate.cu``: the snapshot copies
every range into the buffer before the forward, and the restore, after
AdamW, reads the valid count on the device and copies the ranges back only
when it is not > 0 (NaN included); on the CPU, the plain versions.

On a mesh of several ranks (``parallel/mesh.py``) each rank runs this step on
its stripe of the global batch, with the JAX package's global semantics: the
model's BatchNorm statistics are global (``MeshBatchNorm2d``); the loss is the
global masked mean, so each rank scales its NLL sum by world / global valid
count and ``DistributedDataParallel``'s mean of the gradients is the global
gradient; the returned ``LossStats`` are global sums; and the no-op gate
tests the global valid count, so the ranks' weights never part. Each data
row draws its augmentation from its own generator, seeded from (seed, data
row). On one rank none of this runs: no wrapper, no collective.

On a spatial mesh (``Mesh.spatial`` > 1) a rank's batch is its data row's
rows cut to its height stripe, and the model exchanges halo rows around
every 3x3 convolution (``HaloConv2d``). The same scaling still gives the
global masked mean: with F = sum over ranks of (local NLL sum * world /
global count) = world * loss, each rank's backward (whose BatchNorm and halo
collectives carry the cross-rank terms) gives the part of dF/dw that flows
through its copy of the weights, the parts sum to dF/dw, and
``DistributedDataParallel``'s mean over the world divides by world. The
LossStats sum over all ranks count each pixel once, as each pixel lies in
one stripe. The augmentation runs on the stripe (``ops/augment_cuda.py``)
with the data row's generator, so all stripes of a row draw the same
factors and noise; a 1 x S mesh draws what one rank draws. Predict cuts its
images into stripes and gathers the stripes' outputs back over the spatial
group.

Compiled (``create_train_state(..., compile=CompileOptions(...))``, the
trainer's ``--compile``): the train and eval steps run the model through
``torch.compile`` (``compile_model``), one graph for the training forward
and, through AOTAutograd, its backward, and one for eval. The CUDA kernels
are ``torch.library`` custom ops, so they stay in the graph as calls. The
augmentation (its randomness comes from the state's generator), the loss,
the no-op gate and AdamW stay eager. On several ranks
``DistributedDataParallel`` wraps the compiled model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..models.unet import StereoUNet
from ..ops.augment import AugmentConfig, augment_stereo_batch
from ..ops.augment_cuda import augment_stereo_batch_fused
from ..ops.gate import ZeroValidGate
from ..ops.halo import Stripe
from ..ops.loss import LossStats
from ..spans import span
from .mesh import Mesh

Batch = dict[str, torch.Tensor]


@dataclass
class TrainState:
    model: nn.Module  # StereoUNet or PSMNet: it gives the steps its loss
    optimizer: torch.optim.AdamW
    generator: torch.Generator  # all of the step's randomness, on the model's device
    step: int = 0  # steps taken, zero-valid batches included
    # On several ranks: DistributedDataParallel(model), which the step runs.
    replica: nn.Module | None = None
    # Compiled: torch.compile(model), which the steps run (inside the replica
    # on several ranks). Checkpoints read ``model``, whose keys are plain.
    compiled: nn.Module | None = None
    # The zero-valid gate's table, snapshot buffer and restore counter.
    gate: ZeroValidGate = field(default_factory=ZeroValidGate)


@dataclass(frozen=True)
class CompileOptions:
    """The trainer's ``--compile-mode`` and ``--compile-backend``. Backend
    ``"xla"``, the JAX package's default, names Inductor here: the compiler
    that stands where XLA stands there. Any other name goes to
    ``torch.compile`` as it is, which raises on one it does not know."""

    mode: str = "default"  # default|reduce-overhead|max-autotune
    backend: str = "xla"


def compile_options_from(args) -> CompileOptions | None:
    """A CLI's ``--compile``, ``--compile-mode`` and ``--compile-backend``
    (the trainer's config or a serving CLI's arguments): the options, or
    None for eager."""
    if not args.compile:
        return None
    return CompileOptions(mode=args.compile_mode, backend=args.compile_backend)


def compile_model(module: Callable, options: CompileOptions) -> Callable:
    """``torch.compile(module, fullgraph=True)`` with ``options``: one graph,
    or a failure. A failure to compile raises at the first call; nothing
    falls back to eager. ``module`` is a module or a function of tensors."""
    backend = "inductor" if options.backend == "xla" else options.backend
    return torch.compile(module, mode=options.mode, backend=backend, fullgraph=True)


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


def rank_seed(seed: int, mesh: Mesh | None) -> int:
    """The generator seed of this rank: ``seed`` itself with one data row,
    else one drawn from (seed, data row), so data rows draw different
    augmentations and the height stripes of a row the same (with one stripe
    a row, the data row is the rank)."""
    if mesh is None or mesh.data_size == 1:
        return seed
    return int(np.random.SeedSequence((seed, mesh.data_index)).generate_state(1)[0])


def create_train_state(
    model: nn.Module, optimizer: torch.optim.AdamW, seed: int = 0,
    mesh: Mesh | None = None, compile: CompileOptions | None = None,
) -> TrainState:
    """The train state; on a mesh of several ranks the model is wrapped in
    ``DistributedDataParallel`` (a collective: every rank calls this; the
    wrapper broadcasts rank 0's weights and buffers). With ``compile`` the
    steps run ``compile_model(model)``; the replica wraps that."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(rank_seed(seed, mesh))
    compiled = None if compile is None else compile_model(model, compile)
    replica = None
    if mesh is not None and mesh.distributed:
        from torch.nn.parallel import DistributedDataParallel

        # Buffers are not broadcast each step: the BatchNorm running
        # statistics come from global sums and are equal on every rank.
        replica = DistributedDataParallel(
            model if compiled is None else compiled,
            device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=mesh.group,
        )
    return TrainState(model=model, optimizer=optimizer, generator=generator,
                      replica=replica, compiled=compiled)


def _forward_module(state: TrainState, train: bool) -> nn.Module:
    """What a step runs the model through: the replica (training on several
    ranks), else the compiled model, else the model."""
    if train and state.replica is not None:
        return state.replica
    return state.model if state.compiled is None else state.compiled


def global_stats(stats: LossStats, mesh: Mesh | None) -> LossStats:
    """The batch's ``LossStats`` summed over the mesh's ranks (detached)."""
    if mesh is None or not mesh.distributed:
        return stats
    total = mesh.all_reduce(torch.stack([s.detach() for s in stats]))
    return LossStats(*total.unbind())


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
    parameters, BatchNorm buffers, AdamW moments and step counts. The gate
    gathers these every step, so the walk reads the modules' own dicts
    (``modules()`` would also build every module's name)."""
    tensors, modules = [], [state.model]
    for module in modules:  # the list grows as the walk goes down the tree
        if module is not None:
            tensors += module._parameters.values()
            tensors += module._buffers.values()
            modules += module._modules.values()
    tensors = [t for t in tensors if t is not None]
    for p_state in state.optimizer.state.values():
        tensors += p_state["exp_avg"], p_state["exp_avg_sq"], p_state["step"]
    return tensors


def _set_learning_rate(optimizer: torch.optim.AdamW) -> None:
    first = next(iter(optimizer.state.values()))
    lr = optimizer.lr_schedule(first["step"])  # type: ignore[attr-defined]
    for group in optimizer.param_groups:
        group["lr"].copy_(lr)


def _augmented_inputs(
    state: TrainState, raw: torch.Tensor, augment_config: AugmentConfig | None,
    stripe: Stripe | None = None,
) -> torch.Tensor:
    if augment_config is None:
        return _prepare_input(raw)
    if raw.dtype == torch.uint8 and augment_config.impl != "plain":
        # The fused chain reads the uint8 batch and writes the model's
        # compute dtype (bf16 halves its writes); on CUDA it is the kernel.
        return augment_stereo_batch_fused(
            state.generator, raw, augment_config, out_dtype=state.model.compute_dtype,
            stripe=stripe,
        )
    return augment_stereo_batch(state.generator, _prepare_input(raw), augment_config, stripe)


def _stripe(mesh: Mesh | None, height: int | None) -> Stripe | None:
    """This rank's ``Stripe`` of images ``height`` rows high on a spatial
    mesh, else None."""
    if mesh is None or mesh.spatial == 1:
        return None
    if height is None:
        raise ValueError("the augmentation on a spatial mesh needs the images' height")
    start, _ = mesh.height_block(height)
    return Stripe(mesh.spatial_group, start, height)


def make_train_step(
    augment_config: AugmentConfig | None = None,
    mesh: Mesh | None = None,
    height: int | None = None,
) -> Callable[[TrainState, Batch], tuple[TrainState, LossStats]]:
    """Train step on a batch {input (N,H,W,6) u8/f32, target (N,H,W),
    optional valid_mask}: augment -> forward -> loss -> backward -> AdamW.
    On a ``mesh`` of several ranks the batch is this rank's block and the
    state comes from ``create_train_state(..., mesh=mesh)``; the returned
    ``LossStats`` are the global batch's. On a spatial mesh the augmentation
    needs the whole images' ``height``."""
    distributed = mesh is not None and mesh.distributed
    stripe = None if augment_config is None else _stripe(mesh, height)

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, LossStats]:
        with span("train.step"):
            model, optimizer = state.model, state.optimizer
            with span("train.augment"):
                inputs = _augmented_inputs(
                    state, batch["input"], augment_config, stripe)
            target, mask = _targets_and_mask(batch)

            # Zero-valid-batch no-op, decided on the device without a host sync:
            # snapshot what the step changes (BatchNorm running stats change
            # inside forward, so before it) into the gate's buffer, run the
            # step, then restore from it unless valid_count > 0. On CUDA one
            # launch each (ops/gate.py): the snapshot moves the weights and the
            # two Adam moments once (~93 MB at base 32), the restore only reads
            # valid_count on a batch with valid pixels, where reading it on the
            # host would stall the step.
            with span("train.gate.snapshot"):
                state.gate.snapshot(_gated_tensors(state))

            model.train()
            with span("train.forward"):
                outputs = _forward_module(state, train=True)(inputs, **model.step_kwargs)
            with span("train.loss"):
                loss, stats = model.step_loss(outputs, target, mask)
            if distributed:
                # The global masked mean: the ranks' valid counts differ (invalid
                # pixels, padded rows), and DistributedDataParallel averages the
                # ranks' gradients, so each rank's sum is scaled by
                # world / global count.
                local_nll = stats.nll_sum
                stats = global_stats(stats, mesh)
                loss = local_nll * (mesh.world_size / stats.valid_count.clamp(min=1.0))
            optimizer.zero_grad(set_to_none=True)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                _set_learning_rate(optimizer)
                optimizer.step()

            with span("train.gate.select"):
                state.gate.restore(stats.valid_count)
            state.step += 1
            return state, LossStats(*(s.detach() for s in stats))

    return step


class DeviceDataTrainStep:
    """ONE train step per call over a DEVICE-RESIDENT dataset.

    Each pass over the payload (``steps_per_epoch`` calls, counted by this
    object) starts by drawing a ``torch.randperm`` of the samples from the
    state's generator; call ``pos`` of the pass gathers rows
    ``perm[pos*B:(pos+1)*B]`` with ``index_select`` on the device. Nothing
    crosses to the host per step. The permutation comes from the train
    state's generator, so a resumed run continues its random stream."""

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
        self._calls = 0
        self._perm: torch.Tensor | None = None

    def gather(self, state: TrainState) -> Batch:
        with span("train.gather"):
            pos = self._calls % self.steps_per_epoch
            if pos == 0:
                self._perm = torch.randperm(
                    self.images_u8.shape[0],
                    generator=state.generator,
                    device=self.images_u8.device,
                )
            self._calls += 1
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


class DeviceDataTrainLoop:
    """K train steps per call over a DEVICE-RESIDENT dataset: JAX
    ``make_device_data_train_loop``. Each step is a ``DeviceDataTrainStep``
    call (the on-device gather, then the step); the K steps' ``LossStats``
    are stacked on the device, so a call returns ``LossStats`` of (K,)
    tensors and nothing waits for the host between the steps. The caller
    reads the stats once per call."""

    def __init__(self, step: DeviceDataTrainStep, steps_per_call: int) -> None:
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got {steps_per_call}")
        self.step = step
        self.steps_per_call = steps_per_call

    def __call__(self, state: TrainState) -> tuple[TrainState, LossStats]:
        stats = []
        for _ in range(self.steps_per_call):
            state, s = self.step(state)
            stats.append(s)
        return state, LossStats(*(torch.stack(field) for field in zip(*stats)))


def make_device_data_train_loop(
    images_u8: torch.Tensor,
    targets: torch.Tensor,
    batch_size: int,
    augment_config: AugmentConfig | None = None,
    steps_per_call: int = 10,
    step_fn: Callable[[TrainState, Batch], tuple[TrainState, LossStats]] | None = None,
) -> DeviceDataTrainLoop:
    """``steps_per_call`` train steps per call over a device-resident payload:
    ``run(state) -> (state, stats)``, each field of ``stats`` a
    (steps_per_call,) tensor on the device."""
    return DeviceDataTrainLoop(
        make_device_data_train_step(images_u8, targets, batch_size, augment_config, step_fn),
        steps_per_call,
    )


def make_eval_step(mesh: Mesh | None = None) -> Callable[[TrainState, Batch], LossStats]:
    """Eval: running BN stats, no augmentation, metric sums only; on a mesh
    of several ranks, summed over the ranks."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> LossStats:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            outputs = _forward_module(state, train=False)(
                _prepare_input(batch["input"]), **model.step_kwargs)
        finally:
            model.train(was_training)
        target, mask = _targets_and_mask(batch)
        _, stats = model.step_loss(outputs, target, mask)
        return global_stats(stats, mesh)

    return eval_step


def make_predict_fn(
    model: StereoUNet, mesh: Mesh | None = None, compiled: nn.Module | None = None,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Inference: input NHWC (uint8 or float) -> (disparity, logvar), each
    (N, H, W) float32, with running BN stats. On a spatial ``mesh`` every
    rank of a data row calls it with the same whole images: each runs the
    model on its stripe, and the stripes are gathered with one all-reduce
    over the spatial group (each rank writes its rows of a zero buffer), so
    every rank returns the whole images.

    With ``compiled`` (``compile_model(model)``, the serving CLIs'
    ``--compile``) the forward runs through it. The model is put in eval
    mode here, outside the traced code, before every call, so the compiled
    graph always meets an eval-mode model and its guard on ``training``
    holds; the mode the model had is restored after the call."""
    spatial = mesh is not None and mesh.spatial > 1
    forward = model if compiled is None else compiled

    @torch.inference_mode()
    def predict(inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        start, stop = mesh.height_block(inputs.shape[1]) if spatial else (0, inputs.shape[1])
        was_training = model.training
        model.eval()
        try:
            disp, logvar = forward(_prepare_input(inputs[:, start:stop]),
                                   return_uncertainty=True)
        finally:
            model.train(was_training)
        if not spatial:
            return disp[..., 0], logvar[..., 0]
        whole = disp.new_zeros((2, inputs.shape[0], inputs.shape[1], inputs.shape[2]))
        whole[0, :, start:stop] = disp[..., 0]
        whole[1, :, start:stop] = logvar[..., 0]
        mesh.spatial_group.sum_(whole)
        return whole[0], whole[1]

    return predict
