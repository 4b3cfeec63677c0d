"""Training orchestrator: the ``foundation-stereo-depth`` CLI on one GPU or
several.

Counterpart of ``stereo_depth_estimation_tpu/training/trainer.py``:

    python -m stereo_depth_estimation_tpu_torch.training.trainer \\
        --dataset-root <root> --packed-cache-root <dir> [flags]

discovers samples and makes the seeded split, builds the packed uint8 cache,
stages the train set on the device (pinned, or in rotating windows) or
streams padded batches through a pinned-memory prefetcher, trains with the
augmentation on the device (kernel K1; the model's pools are K2/K3), logs to
the MLflow file store, evaluates, saves previews and writes
``checkpoints/last.pt`` every epoch and ``best.pt`` on a new best val MAE,
with the resume state. A JAX command line either runs the same training here
or fails loudly (``check_supported``).

``--mesh-devices N`` trains data-parallel on N local ranks, one GPU each;
``--multihost`` joins ranks across hosts (``parallel/distributed.py``).
``--spatial-devices S`` makes the ranks a (ranks / S, S) mesh that also
shards image height, as the JAX trainer's ``(data, spatial)`` mesh does
(``parallel/mesh.py``); a rank count that S does not divide raises
``ValueError``. ``--batch-size`` stays the global batch. Every rank runs the
same epochs on its block of each batch; only process 0 builds the packed
caches, tracks the run, writes previews and saves checkpoints (the others
get a ``_NullRun``), and a barrier after each epoch's saves keeps the ranks
together. On a spatial mesh the ranks of data row 0 compute the previews
together (each its stripe) and rank 0 writes them from whole images.
"""

from __future__ import annotations

import json
import random
import time
from dataclasses import asdict
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .._device import local_rank_count, resolve_cli_device
from ..data.dataset import StereoSampleLoader
from ..data.packed_cache import PackedCache, build_packed_cache, samples_fingerprint
from ..data.pipeline import batch_iterator, cuda_put, loader_fetch, prefetch_to_device
from ..data.samples import discover_samples, split_samples
from ..eval.preview import save_preview_montage
from ..models.psmnet import PSMNet
from ..models.unet import StereoUNet, count_params
from ..ops.augment import AugmentConfig
from ..ops.loss import LossStats, accumulate_stats, metrics_from_stats
from ..parallel.aot_cache import CompileCache, compile_cache_for
from ..parallel.distributed import MultihostBatcher, is_main_process, run_ranks
from ..parallel.mesh import Mesh, check_factors, pad_batch_to, replicate_to_mesh
from ..parallel.train_step import (
    DeviceDataTrainStep,
    TrainState,
    compile_options_from,
    create_train_state,
    make_adamw,
    make_eval_step,
    make_predict_fn,
    make_train_step,
)
from ..parallel.window import HBMWindowLoader, default_hbm_budget_bytes
from .checkpoint import load_model_variables, load_train_state, save_checkpoint
from .config import TrainConfig, parse_args
from .profiling import StepProfiler
from .tracking import TrackingRun

# --augment-impl takes the JAX package's values.
_AUGMENT_IMPL = {"auto": "auto", "pallas": "kernel", "xla": "plain"}


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def _env_rendezvous(cfg: TrainConfig) -> bool:
    """``--multihost`` with no address flags: the torch.distributed
    environment variables describe the group, one rank a process."""
    return cfg.multihost and (
        cfg.coordinator_address, cfg.num_processes, cfg.process_id) == (None, None, None)


def check_supported(cfg: TrainConfig, device: torch.device) -> None:
    """Raise before any rank starts on more ranks than ``device``'s kind has
    cards, and on a rank count that ``--spatial-devices`` does not divide
    where this process knows the count (with the environment's rendezvous
    the mesh raises once the group is joined)."""
    if cfg.model == "psmnet" and cfg.spatial_devices > 1:
        raise ValueError("--model psmnet trains on whole images: --spatial-devices must be 1")
    env = _env_rendezvous(cfg)
    local = local_rank_count(device, cfg.mesh_devices, env_rendezvous=env)
    if not env:
        processes = (cfg.num_processes or 1) if cfg.multihost else 1
        check_factors(local * processes, cfg.spatial_devices)


def compile_cache_from(cfg: TrainConfig, mesh: Mesh, verbose: bool) -> CompileCache | None:
    """The compile cache of a ``--compile`` run (``parallel/aot_cache.py``),
    or None: off with ``--aot-cache off``, and under ``--multihost`` unless
    ``--aot-cache-multihost``. Local ``--mesh-devices`` ranks use it (the
    JAX package runs them in one process); each rank keys its own blob."""
    if not cfg.compile or (cfg.multihost and not cfg.aot_cache_multihost):
        return None
    setting = {
        "compile_mode": cfg.compile_mode, "compile_backend": cfg.compile_backend,
        "base_channels": cfg.base_channels, "compute_dtype": cfg.compute_dtype,
        "batch_size": cfg.batch_size, "height": cfg.height, "width": cfg.width,
        "ranks": mesh.world_size, "rank": mesh.rank, "spatial": mesh.spatial,
    }
    if cfg.model != "stereounet":
        setting.update(model=cfg.model, max_disparity=cfg.max_disparity)
    return compile_cache_for(cfg.aot_cache, cfg.output_dir, setting, mesh.device, verbose)


def build_model(cfg: TrainConfig, mesh: Mesh) -> StereoUNet | PSMNet:
    """The ``--model`` network on this rank, its weights drawn from the seed;
    with several ranks its BatchNorm statistics are the mesh's."""
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    generator = torch.Generator().manual_seed(cfg.seed)
    bn_group = mesh.group if mesh.distributed else None
    if cfg.model == "psmnet":
        return PSMNet(max_disparity=cfg.max_disparity, channels=cfg.base_channels,
                      compute_dtype=compute_dtype, device=mesh.device, generator=generator,
                      bn_group=bn_group)
    return StereoUNet(
        in_channels=6,
        out_channels=1,
        base_channels=cfg.base_channels,
        compute_dtype=compute_dtype,
        device=mesh.device,
        generator=generator,
        bn_group=bn_group,
        spatial_group=mesh.spatial_group,
    )


def augment_config_from(cfg: TrainConfig) -> AugmentConfig | None:
    if not cfg.augment:
        return None
    return AugmentConfig(
        brightness_jitter=cfg.brightness_jitter,
        contrast_jitter=cfg.contrast_jitter,
        saturation_jitter=cfg.saturation_jitter,
        hue_jitter=cfg.hue_jitter,
        gamma_jitter=cfg.gamma_jitter,
        noise_std_max=cfg.noise_std_max,
        blur_prob=cfg.blur_prob,
        blur_sigma_max=cfg.blur_sigma_max,
        blur_kernel_size=cfg.blur_kernel_size,
        impl=_AUGMENT_IMPL[cfg.augment_impl],
    )


def tracking_params(
    cfg: TrainConfig, train_samples: int, val_samples: int, num_parameters: int
) -> dict[str, Any]:
    """The JAX trainer's key set (reference to_mlflow_params)."""
    params: dict[str, Any] = {
        "dataset_root": str(Path(cfg.dataset_root).expanduser()),
        "height": cfg.height,
        "width": cfg.width,
        "epochs": cfg.epochs,
        "batch_size": cfg.batch_size,
        "lr": cfg.lr,
        "weight_decay": cfg.weight_decay,
        "val_fraction": cfg.val_fraction,
        "seed": cfg.seed,
        "device": cfg.device,
        "train_samples": train_samples,
        "val_samples": val_samples,
        "num_parameters": num_parameters,
        "augment": cfg.augment,
        "uncertainty_head": True,
        "loss": "heteroscedastic_l1_nll",
        "mlflow_train_log_every_batches": cfg.log_every_batches,
        "compile": cfg.compile,  # torch.compile of the model, else eager
        "compute_dtype": cfg.compute_dtype,
        "mesh_devices": cfg.mesh_devices,
        "spatial_devices": cfg.spatial_devices,
        "base_channels": cfg.base_channels,
        "device_resident": cfg.device_resident,
        "hbm_window_gb": cfg.hbm_window_gb,
        "augment_impl": cfg.augment_impl,
        "input_precision": cfg.input_precision,
        "lr_schedule": cfg.lr_schedule,
    }
    if cfg.lr_warmup_steps:
        params["lr_warmup_steps"] = cfg.lr_warmup_steps
    if cfg.augment:
        params.update(
            brightness_jitter=cfg.brightness_jitter,
            contrast_jitter=cfg.contrast_jitter,
            saturation_jitter=cfg.saturation_jitter,
            hue_jitter=cfg.hue_jitter,
            gamma_jitter=cfg.gamma_jitter,
            noise_std_max=cfg.noise_std_max,
            blur_prob=cfg.blur_prob,
            blur_sigma_max=cfg.blur_sigma_max,
            blur_kernel_size=cfg.blur_kernel_size,
        )
    if cfg.cache_root:
        params["cache_root"] = str(Path(cfg.cache_root).expanduser())
    if cfg.init_checkpoint:
        params["init_checkpoint"] = str(Path(cfg.init_checkpoint).expanduser())
    params["require_cache"] = cfg.require_cache
    if cfg.max_samples > 0:
        params["max_samples"] = cfg.max_samples
    return params


def _step_metric_dict(stats: LossStats, prefix: str) -> dict[str, float]:
    m = metrics_from_stats(stats)
    return {
        f"{prefix}_loss_step": m["loss"],
        f"{prefix}_nll_step": m["nll"],
        f"{prefix}_mae_step": m["mae"],
        f"{prefix}_rmse_step": m["rmse"],
        f"{prefix}_sigma_step": m["sigma"],
    }


def _run_device_step(
    state: TrainState, runner: DeviceDataTrainStep
) -> tuple[TrainState, LossStats]:
    return runner(state)


def run_train_epoch(
    step_fn,
    state: TrainState,
    batches: Iterator[Any],
    *,
    run: TrackingRun | None,
    global_step: int,
    log_every_batches: int,
    progress_desc: str | None = None,
    profiler: StepProfiler | None = None,
) -> tuple[TrainState, dict[str, float], int]:
    """One epoch. Metric sums stay on the device and are read only at the
    logging cadence, where a non-finite loss raises."""
    total: LossStats | None = None
    interval: LossStats | None = None
    iterator = batches
    bar = None
    if progress_desc is not None:
        try:
            from tqdm import tqdm

            bar = tqdm(batches, leave=False, desc=progress_desc)
            iterator = bar
        except ImportError:
            pass

    for batch in iterator:
        global_step += 1
        if profiler is not None:
            profiler.step()
        state, stats = step_fn(state, batch)
        total = accumulate_stats(total, stats)
        interval = accumulate_stats(interval, stats)
        if (
            log_every_batches > 0
            and global_step % log_every_batches == 0
            and float(interval.valid_count) > 0
        ):
            metrics = _step_metric_dict(interval, "train")
            if not np.isfinite(metrics["train_nll_step"]):
                raise FloatingPointError(
                    f"Training loss is non-finite at step {global_step} "
                    "(divergence or corrupt input). The 'last' checkpoint "
                    "holds the most recent finite state; resume from it "
                    "with a lower --lr or inspect the data."
                )
            if run is not None:
                run.log_metrics(metrics, step=global_step)
            if bar is not None:
                bar.set_postfix(
                    mae=f"{metrics['train_mae_step']:.4f}",
                    nll=f"{metrics['train_nll_step']:.4f}",
                )
            interval = None
    # Flush a trailing partial interval (reference train.py:393-403).
    if (
        run is not None
        and log_every_batches > 0
        and interval is not None
        and float(interval.valid_count) > 0
    ):
        run.log_metrics(_step_metric_dict(interval, "train"), step=global_step)

    if total is None:
        raise RuntimeError("No batches in training epoch.")
    return state, metrics_from_stats(total), global_step


def run_eval_epoch(eval_fn, state: TrainState, batches: Iterator[Any]) -> dict[str, float]:
    total: LossStats | None = None
    for batch in batches:
        total = accumulate_stats(total, eval_fn(state, batch))
    if total is None:
        raise RuntimeError("No batches in eval epoch.")
    return metrics_from_stats(total)


def _make_fetch(
    cfg: TrainConfig, samples, packed_root: Path | None, main_process: bool = True,
) -> tuple[Callable[[np.ndarray], dict[str, np.ndarray]], int, PackedCache | None]:
    """The packed fast path when asked for, else the npz/PIL loader.
    Returns (fetch, n, packed_cache_or_None).

    On several ranks only process 0 (re)builds a packed cache; the others
    wait for its current ``meta.json``, which ``build_packed_cache`` writes
    last, so ranks sharing a filesystem never read a cache mid-build."""
    if cfg.input_precision == "float32" and cfg.cache_root:
        raise ValueError(
            "--input-precision float32 cannot be combined with "
            "--cache-root: the npz cache stores uint8 images, so cached "
            "epochs would silently see quantised values. Drop one of the "
            "two flags."
        )
    loader = StereoSampleLoader(
        samples,
        image_size=(cfg.height, cfg.width),
        cache_root=cfg.cache_root,
        require_cache=cfg.require_cache,
        float_inputs=cfg.input_precision == "float32",
    )
    if packed_root is None:
        return loader_fetch(loader, num_workers=cfg.num_workers), len(loader), None
    if cfg.input_precision == "float32":
        raise ValueError(
            "--input-precision float32 cannot be combined with "
            "--packed-cache-root: the packed cache stores uint8 images. "
            "Drop one of the two flags."
        )
    fingerprint = samples_fingerprint(samples)
    meta_path = packed_root / "meta.json"

    def meta_is_current() -> bool:
        """meta.json exists and describes this split and size. A stale meta
        a follower may see while process 0 rebuilds fails this check, and
        the fresh one appears only after the payload is complete."""
        try:
            meta = json.loads(meta_path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return False
        return meta.get("split_fingerprint") == fingerprint and (
            meta.get("height"), meta.get("width")
        ) == (cfg.height, cfg.width)

    if not main_process:
        deadline = time.time() + 3600.0
        while not meta_is_current():
            if time.time() > deadline:
                raise TimeoutError(f"Timed out waiting for process 0 to build {packed_root}")
            time.sleep(0.2)
        cache = PackedCache(packed_root)
        return cache.gather, len(cache), cache
    if meta_path.exists() and not meta_is_current():
        # Same counts can hide another split (train samples would leak into
        # val) and another size would feed wrong shapes: rebuild, meta first.
        print(
            f"Packed cache at {packed_root} was built for a different "
            "sample split or image size; rebuilding."
        )
        for name in ("meta.json", "images.bin", "disparity.bin"):
            (packed_root / name).unlink(missing_ok=True)
    if not meta_path.exists():
        print(f"Building packed cache at {packed_root} ...")
        build_packed_cache(
            loader, packed_root, progress=True,
            extra_meta={"split_fingerprint": fingerprint},
        )
    cache = PackedCache(packed_root)
    if len(cache) != len(samples):
        raise ValueError(
            f"Packed cache size {len(cache)} != sample count {len(samples)}; "
            "rebuild with a fresh --packed-cache-root."
        )
    return cache.gather, len(cache), cache


def _device_val_batches(
    cache: PackedCache, batch_size: int, device: torch.device
) -> list[dict[str, torch.Tensor]]:
    """The whole validation set staged on the device once, cut into static
    batches; the tail is padded with wrap rows flagged False (rank-1 row
    flags, as ``pad_batch_to`` pads)."""
    data = cache.load_all()  # read-only memmap views: copied before use
    images = torch.from_numpy(np.array(data["input"])).to(device)
    targets = torch.from_numpy(np.array(data["target"])).to(device)
    n = len(cache)
    batches = []
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        real = np.ones(batch_size, bool)
        pad = batch_size - len(idx)
        if pad > 0:
            idx = np.concatenate([idx, np.arange(pad) % n])
            real[batch_size - pad:] = False
        index = torch.from_numpy(idx).to(device)
        batches.append({
            "input": images.index_select(0, index),
            "target": targets.index_select(0, index),
            "valid_mask": torch.from_numpy(real).to(device),
        })
    return batches


class _NullRun:
    """Tracking sink of every rank but process 0: all ranks run the same
    epochs, only process 0 records anything."""

    run_id = "multihost-follower"
    backend = "null"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def log_params(self, *a, **k):
        pass

    def log_metrics(self, *a, **k):
        pass

    def log_artifact(self, *a, **k):
        pass

    def log_artifacts(self, *a, **k):
        pass

    def set_tag(self, *a, **k):
        pass


def _warn_on_horizon_drift(
    cfg: TrainConfig, meta: dict[str, Any], carry: dict[str, Any], steps_per_epoch: int
) -> None:
    """A resumed cosine run whose decay horizon (steps/epoch x epochs) moved."""
    saved_total = carry.get("schedule_total_steps")
    recomputed_total = steps_per_epoch * cfg.epochs
    saved_epochs = (meta.get("config") or {}).get("epochs")
    if saved_total is not None and int(saved_total) != recomputed_total:
        print(
            f"Warning: resuming a {cfg.lr_schedule} lr-schedule run "
            f"whose decay horizon was {saved_total} steps, but this "
            f"run computes {recomputed_total} "
            f"(steps/epoch {steps_per_epoch} x epochs {cfg.epochs}): "
            "the schedule's decay endpoint moves relative to the "
            "original plan."
        )
    elif saved_total is None and saved_epochs is not None and int(saved_epochs) != cfg.epochs:
        print(
            f"Warning: resuming a {cfg.lr_schedule} lr-schedule run "
            f"with --epochs {cfg.epochs} (checkpoint was trained for "
            f"{saved_epochs}): total_steps changes, so the schedule's "
            "decay endpoint moves relative to the original plan."
        )


def train(cfg: TrainConfig) -> dict[str, Any]:
    """Run the training ``cfg`` describes, on this process's ranks. Returns
    the run summary of its first rank: run id, best epoch and val MAE,
    checkpoint directory, global step, each epoch's metrics, how the train
    set was fed (``device_resident``: "pinned", "rotating" or "off"), and,
    unless the ranks were spawned, the final ``TrainState``."""
    device = resolve_cli_device(cfg.device)
    check_supported(cfg, device)
    local = local_rank_count(device, cfg.mesh_devices, env_rendezvous=_env_rendezvous(cfg))
    return run_ranks(
        train_rank, (cfg, local == 1), device=device, local_ranks=local,
        multihost=cfg.multihost, coordinator_address=cfg.coordinator_address,
        num_processes=cfg.num_processes, process_id=cfg.process_id,
        spatial=cfg.spatial_devices,
    )


def train_rank(mesh: Mesh, cfg: TrainConfig, keep_state: bool = True) -> dict[str, Any]:
    """The training of one rank of ``mesh`` (``train``'s summary; the
    ``TrainState`` only with ``keep_state``)."""
    set_seed(cfg.seed)
    device = mesh.device
    main_process = is_main_process()
    say = print if main_process else (lambda *args, **kwargs: None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"Using {mesh.world_size} device(s), one rank each, as {mesh.data_size} data row(s) "
        f"x {mesh.spatial} height stripe(s); rank 0 on {device} ({name})")

    all_samples = discover_samples(cfg.dataset_root)
    if cfg.max_samples > 0:
        all_samples = all_samples[: cfg.max_samples]
    if len(all_samples) < 2:
        raise ValueError("Need at least two samples to create train/validation splits.")
    train_samples, val_samples = split_samples(all_samples, cfg.val_fraction, cfg.seed)
    say(
        f"Discovered {len(all_samples)} samples: "
        f"train={len(train_samples)}, val={len(val_samples)}"
    )

    packed_base = Path(cfg.packed_cache_root) if cfg.packed_cache_root else None
    train_fetch, n_train, train_cache = _make_fetch(
        cfg, train_samples, packed_base / "train" if packed_base else None, main_process
    )
    val_fetch, n_val, val_cache = (
        _make_fetch(cfg, val_samples, packed_base / "val" if packed_base else None,
                    main_process)
        if val_samples
        else (None, 0, None)
    )

    preview_source = val_samples if val_samples else train_samples
    preview_split = "val" if val_samples else "train"
    # Previews predict through the StereoUNet's serving path.
    preview_count = min(cfg.preview_samples, len(preview_source)) if cfg.model == "stereounet" \
        else 0

    # Device-resident path (parallel/window.py): the packed train set pinned
    # in device memory when it fits the budget, else rotated through it in
    # windows; on several ranks each stages its rows of every window.
    # Planned before the optimizer: the cosine horizon is the number of
    # steps the run will take.
    windowed: HBMWindowLoader | None = None
    device_val_batches: list | None = None
    if cfg.device_resident == "on" and train_cache is None:
        say(
            "--device-resident on requested but unavailable "
            "(needs --packed-cache-root); falling back to streamed batches."
        )
    if cfg.device_resident != "off" and train_cache is not None:
        try:
            windowed = HBMWindowLoader(
                train_cache.gather,
                n_train,
                cfg.batch_size,
                device,
                bytes_per_sample=train_cache.nbytes // max(n_train, 1),
                budget_bytes=default_hbm_budget_bytes(cfg.hbm_window_gb, mesh.world_size),
                seed=cfg.seed,
                mesh=mesh,
            )
        except ValueError as exc:
            if cfg.device_resident == "on":
                raise ValueError(f"--device-resident: {exc}") from exc
            say(f"Device-resident unavailable ({exc}); streaming.")
        if windowed is not None:
            plan = windowed.plan
            mode = (
                "pinned (staged once, reused every epoch)"
                if plan.pinned
                else f"rotating {plan.num_windows} windows of "
                     f"{plan.window_samples} samples (next window staged "
                     "behind training)"
            )
            say(
                f"Device-resident training: {train_cache.nbytes / 1e6:.0f} MB "
                f"over {mesh.world_size} device(s), {mode}, "
                f"{plan.steps_per_epoch} steps/epoch."
            )
            if val_cache is not None and not mesh.distributed:
                # One device: the validation set is staged too, so an epoch
                # makes no host traffic. Several ranks stream their stripes.
                device_val_batches = _device_val_batches(val_cache, cfg.batch_size, device)

    model = build_model(cfg, mesh)
    steps_per_epoch = (
        windowed.plan.steps_per_epoch
        if windowed is not None
        else -(-len(train_samples) // cfg.batch_size)
    )
    optimizer = make_adamw(
        model.parameters(), cfg.lr, cfg.weight_decay,
        schedule=cfg.lr_schedule,
        total_steps=steps_per_epoch * cfg.epochs,
        warmup_steps=cfg.lr_warmup_steps,
    )
    state = create_train_state(model, optimizer, seed=cfg.seed, mesh=mesh,
                               compile=compile_options_from(cfg))
    num_parameters = count_params(model)
    start_epoch = 1
    if cfg.init_checkpoint:
        if cfg.resume:
            raise ValueError(
                "--init-checkpoint and --resume are mutually exclusive: "
                "resume restores the full TrainState including these weights."
            )
        load_model_variables(Path(cfg.init_checkpoint), model)
        say(f"Initialised model weights from {cfg.init_checkpoint}.")
    resume_carry: dict[str, Any] = {}
    if cfg.resume:
        state, meta = load_train_state(Path(cfg.resume), state)
        start_epoch = int(meta.get("epoch") or 0) + 1
        resume_carry = dict((meta.get("metrics") or {}).get("resume_carry", {}))
        if cfg.lr_schedule != "constant" and main_process:
            _warn_on_horizon_drift(cfg, meta, resume_carry, steps_per_epoch)
        if mesh.data_index > 0:
            # The checkpoint holds data row 0's generator; the other rows
            # draw a stream of their own again, from (seed, row, step).
            state.generator.manual_seed(int(np.random.SeedSequence(
                (cfg.seed, mesh.data_index, state.step)).generate_state(1)[0]))
        say(f"Resumed from {cfg.resume} at epoch {start_epoch - 1}.")
    if cfg.init_checkpoint or cfg.resume:
        state = replicate_to_mesh(state, mesh)

    train_step = make_train_step(augment_config_from(cfg), mesh, cfg.height)
    eval_step = make_eval_step(mesh)
    compile_cache = compile_cache_from(cfg, mesh, verbose=main_process)
    if compile_cache is not None:
        # Repeat runs of the same setting load Inductor's artifacts before
        # the first compile; after each epoch the steps' first calls report
        # their sources and the artifacts are saved (once, when any compiled).
        compile_cache.load()
        train_step = compile_cache.wrap(train_step, "train step")
        eval_step = compile_cache.wrap(eval_step, "eval step")
    # Previews stay eager (a few pairs an epoch). The ranks of data row 0
    # compute them: on one stripe a row that is rank 0 alone.
    predict = make_predict_fn(model, mesh)
    previews_here = preview_count > 0 and mesh.data_index == 0
    if mesh.distributed:
        # Each rank fetches only its block of every global batch, padded
        # to the static batch size and the data rows with flagged rows.
        train_fetch = MultihostBatcher(train_fetch, mesh, pad_to=cfg.batch_size)
        if val_fetch is not None:
            val_fetch = MultihostBatcher(val_fetch, mesh, pad_to=cfg.batch_size)
        put = cuda_put(device)
    else:
        put = cuda_put(device, lambda batch: pad_batch_to(batch, cfg.batch_size))

    run: Any = (
        TrackingRun(cfg.mlflow_tracking_uri, cfg.mlflow_experiment, cfg.run_name)
        if main_process
        else _NullRun()
    )
    summary: dict[str, Any] = {}
    with run:
        run_id = run.run_id
        output_dir = Path(cfg.output_dir).expanduser().resolve() / run_id
        checkpoints_dir = output_dir / "checkpoints"
        preview_root = output_dir / "mlflow_previews"
        if main_process:
            checkpoints_dir.mkdir(parents=True, exist_ok=True)
            preview_root.mkdir(parents=True, exist_ok=True)
            config_path = output_dir / "config.json"
            config_path.write_text(json.dumps(asdict(cfg), indent=2), encoding="utf-8")
            run.log_params(
                tracking_params(cfg, len(train_samples), len(val_samples), num_parameters)
            )
            run.log_artifact(config_path, artifact_path="config")
            if preview_count > 0:
                print(f"Previews: logging {preview_count} fixed {preview_split} "
                      "samples each epoch.")

        best_val_mae = float(resume_carry.get("best_val_mae", float("inf")))
        best_epoch = int(resume_carry.get("best_epoch", -1))
        global_step = int(resume_carry.get("global_step", 0))
        profiler = StepProfiler(cfg.profile_dir if main_process else None, cfg.profile_steps)
        history = []

        for epoch in range(start_epoch, cfg.epochs + 1):
            start_time = time.time()
            if windowed is not None:
                # Each item is the window's DeviceDataTrainStep: it gathers
                # its batch on the device and runs train_step.
                step_fn = _run_device_step
                train_batches: Any = windowed.epoch_steps(epoch, train_step)
            else:
                step_fn = train_step
                train_batches = prefetch_to_device(
                    batch_iterator(
                        train_fetch, n_train, cfg.batch_size,
                        shuffle=True, seed=cfg.seed, epoch=epoch,
                    ),
                    put=put,
                )
            state, train_metrics, global_step = run_train_epoch(
                step_fn,
                state,
                train_batches,
                run=run,
                global_step=global_step,
                log_every_batches=cfg.log_every_batches,
                progress_desc=f"epoch {epoch}" if main_process else None,
                profiler=profiler,
            )
            profiler.stop()  # flush even if the epoch was shorter than asked
            if device_val_batches is not None:
                val_metrics = run_eval_epoch(eval_step, state, iter(device_val_batches))
            elif val_fetch is not None:
                val_batches = prefetch_to_device(
                    batch_iterator(val_fetch, n_val, cfg.batch_size), put=put
                )
                val_metrics = run_eval_epoch(eval_step, state, val_batches)
            else:
                val_metrics = train_metrics

            epoch_metrics = {
                "train_loss": train_metrics["loss"],
                "train_nll": train_metrics["nll"],
                "train_mae": train_metrics["mae"],
                "train_rmse": train_metrics["rmse"],
                "train_sigma": train_metrics["sigma"],
                "epoch_seconds": time.time() - start_time,
            }
            if val_fetch is not None:
                epoch_metrics.update(
                    val_loss=val_metrics["loss"],
                    val_nll=val_metrics["nll"],
                    val_mae=val_metrics["mae"],
                    val_rmse=val_metrics["rmse"],
                    val_sigma=val_metrics["sigma"],
                )
            run.log_metrics(epoch_metrics, step=epoch)
            history.append({"epoch": epoch, "global_step": global_step, **epoch_metrics})
            if compile_cache is not None:
                compile_cache.finish()

            if previews_here:
                previews_dir = preview_root / f"epoch_{epoch:04d}"
                log_epoch_previews(
                    predict, cfg, preview_source[:preview_count], previews_dir, device,
                    write=main_process,
                )
                run.log_artifacts(previews_dir, artifact_path=f"previews/epoch_{epoch:04d}")

            # Every rank sees the same global metrics, so all agree on the
            # best epoch; process 0 alone writes.
            if val_metrics["mae"] < best_val_mae:
                best_val_mae = val_metrics["mae"]
                best_epoch = epoch
                if main_process:
                    save_checkpoint(
                        checkpoints_dir, "best", state,
                        epoch=epoch, config=asdict(cfg), metrics=epoch_metrics,
                    )
            # `last` carries resume continuity (global step, global best so
            # far, the schedule horizon this run computed); saved after the
            # best check so the carry reflects this epoch.
            if main_process:
                save_checkpoint(
                    checkpoints_dir, "last", state,
                    epoch=epoch, config=asdict(cfg),
                    metrics={
                        **epoch_metrics,
                        "resume_carry": {
                            "global_step": global_step,
                            "best_val_mae": best_val_mae,
                            "best_epoch": best_epoch,
                            "schedule_total_steps": steps_per_epoch * cfg.epochs,
                        },
                    },
                )
            mesh.barrier()  # no rank runs ahead of process 0's saves

            if not main_process:
                pass
            elif val_fetch is not None:
                print(
                    f"Epoch {epoch}/{cfg.epochs}: "
                    f"train_mae={train_metrics['mae']:.4f}, "
                    f"val_mae={val_metrics['mae']:.4f}, "
                    f"train_rmse={train_metrics['rmse']:.4f}, "
                    f"val_rmse={val_metrics['rmse']:.4f}"
                )
            else:
                print(
                    f"Epoch {epoch}/{cfg.epochs}: "
                    f"train_mae={train_metrics['mae']:.4f}, "
                    f"train_rmse={train_metrics['rmse']:.4f}"
                )

        run.set_tag("best_epoch", best_epoch)
        run.set_tag("best_val_mae", best_val_mae)
        if main_process and checkpoints_dir.exists():
            run.log_artifacts(checkpoints_dir, artifact_path="checkpoints")

        say(f"Run: {run_id} (tracking backend: {run.backend})")
        say(f"Best validation MAE: {best_val_mae:.4f} at epoch {best_epoch}")
        say(f"Checkpoints saved to: {checkpoints_dir}")
        summary = {
            "run_id": run_id,
            "best_epoch": best_epoch,
            "best_val_mae": best_val_mae,
            "checkpoints_dir": str(checkpoints_dir),
            "global_step": global_step,
            "epochs": history,
            "device_resident": (
                "off" if windowed is None
                else "pinned" if windowed.plan.pinned
                else "rotating"
            ),
            "compile_cache": {} if compile_cache is None else compile_cache.reports,
        }
        if keep_state:
            summary["state"] = state
    return summary


def log_epoch_previews(
    predict,
    cfg: TrainConfig,
    samples,
    previews_dir: Path,
    device: torch.device,
    write: bool = True,
) -> int:
    """Predict ``samples`` and, with ``write``, save their montages (on a
    spatial mesh every rank of the row predicts, one rank writes)."""
    loader = StereoSampleLoader(
        samples,
        image_size=(cfg.height, cfg.width),
        cache_root=cfg.cache_root,
        require_cache=cfg.require_cache,
    )
    items = [loader[i] for i in range(len(loader))]
    inputs = np.stack([it["input"] for it in items])
    targets = np.stack([it["target"] for it in items])
    disp, _ = predict(torch.from_numpy(inputs).to(device))
    if not write:
        return 0
    previews_dir.mkdir(parents=True, exist_ok=True)
    disp = disp.cpu().numpy()
    for i in range(inputs.shape[0]):
        save_preview_montage(
            previews_dir / f"sample_000_{i:02d}.png", inputs[i], targets[i], disp[i]
        )
    return inputs.shape[0]


def main(argv: list[str] | None = None) -> dict[str, Any]:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
