"""Training configuration: the JAX trainer's dataclass, flags and defaults.

Counterpart of ``stereo_depth_estimation_tpu/training/config.py``: the same
field names, flags and defaults, so a JAX command line parses here and runs
the same training.
"""

from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, fields


@dataclass
class TrainConfig:
    dataset_root: str = "/mnt/bulk2/NVidia Foundation Stereo"
    height: int = 240
    width: int = 320
    epochs: int = 100
    batch_size: int = 30
    lr: float = 1e-3
    weight_decay: float = 1e-4
    lr_schedule: str = "constant"  # constant|cosine
    lr_warmup_steps: int = 0
    num_workers: int = 4
    val_fraction: float = 0.1
    max_samples: int = 0
    seed: int = 42
    device: str = "auto"  # auto|cuda|cpu; auto is the card
    mlflow_tracking_uri: str = "sqlite:///mlflow.db"
    mlflow_experiment: str = "foundation-stereo-depth"
    run_name: str | None = None
    output_dir: str = "./outputs"
    cache_root: str | None = None
    require_cache: bool = False
    compile: bool = False
    compile_mode: str = "default"
    compile_backend: str = "xla"
    augment: bool = True
    brightness_jitter: float = 0.25
    contrast_jitter: float = 0.25
    saturation_jitter: float = 0.25
    hue_jitter: float = 0.09
    gamma_jitter: float = 0.2
    noise_std_max: float = 0.05
    blur_prob: float = 0.03
    blur_sigma_max: float = 1.0
    blur_kernel_size: int = 5
    augment_impl: str = "auto"  # auto|xla|pallas: auto, plain, the CUDA kernel
    input_precision: str = "uint8"  # uint8|float32
    base_channels: int = 32  # UNet width; 32 = reference spec (7.76M params)
    # Port-only: the network the trainer builds (models/unet.py or
    # models/psmnet.py), and PSMNet's disparity range.
    model: str = "stereounet"  # stereounet|psmnet
    max_disparity: int = 192
    mesh_devices: int = 0  # ranks, one GPU each; 0 = all visible GPUs (1 on the CPU)
    spatial_devices: int = 1
    compute_dtype: str = "bfloat16"
    packed_cache_root: str | None = None
    device_resident: str = "auto"  # auto|on|off
    hbm_window_gb: float = 4.0  # device byte budget for resident windows
    aot_cache: str = "auto"
    aot_cache_multihost: bool = False
    resume: str | None = None  # a last.pt / best.pt to resume from
    init_checkpoint: str | None = None  # a reference .pt: weights only
    log_every_batches: int = 10
    preview_samples: int = 8
    profile_dir: str | None = None
    profile_steps: int = 10
    multihost: bool = False
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    def to_dict(self) -> dict:
        return asdict(self)


def add_compile_arguments(parser: argparse.ArgumentParser, graphs: str) -> None:
    """``--compile``, ``--compile-mode`` and ``--compile-backend``, with the
    trainer's defaults (eager unless asked), for the trainer and the serving
    CLIs; ``graphs`` says what one CLI compiles."""
    defaults = TrainConfig()
    parser.add_argument(
        "--compile", action=argparse.BooleanOptionalAction, default=defaults.compile,
        help=f"Run the model through torch.compile ({graphs}; the CUDA kernels "
             "stay in it as custom ops). Off: eager.")
    parser.add_argument(
        "--compile-mode", type=str, default=defaults.compile_mode,
        choices=("default", "reduce-overhead", "max-autotune"),
        help="torch.compile mode with --compile.")
    parser.add_argument(
        "--compile-backend", type=str, default=defaults.compile_backend,
        help="torch.compile backend with --compile: 'xla' (the JAX package's "
             "default) is Inductor, the compiler in XLA's place; any other name "
             "(aot_eager, eager, ...) goes to torch.compile, which raises on an "
             "unknown one.")


def parse_args(argv: list[str] | None = None) -> TrainConfig:
    defaults = TrainConfig()
    parser = argparse.ArgumentParser(
        description="Train the stereo disparity model on FoundationStereo "
                    "(PyTorch, one NVIDIA GPU or several)."
    )
    add = parser.add_argument
    add("--dataset-root", type=str, default=defaults.dataset_root,
        help="Path to FoundationStereo dataset root.")
    add("--height", type=int, default=defaults.height, help="Training image height.")
    add("--width", type=int, default=defaults.width, help="Training image width.")
    add("--epochs", type=int, default=defaults.epochs, help="Number of epochs.")
    add("--batch-size", type=int, default=defaults.batch_size,
        help="Global batch size, split over the ranks.")
    add("--lr", type=float, default=defaults.lr, help="Learning rate.")
    add("--weight-decay", type=float, default=defaults.weight_decay, help="Weight decay.")
    add("--lr-schedule", type=str, default=defaults.lr_schedule,
        choices=("constant", "cosine"), dest="lr_schedule",
        help="LR schedule; cosine decays to 0 over the configured epochs.")
    add("--lr-warmup-steps", type=int, default=defaults.lr_warmup_steps,
        dest="lr_warmup_steps",
        help="Linear warmup steps before the cosine decay (0 = none).")
    add("--num-workers", type=int, default=defaults.num_workers,
        help="Host batch-assembly worker threads.")
    add("--val-fraction", type=float, default=defaults.val_fraction,
        help="Validation fraction in [0, 1).")
    add("--max-samples", type=int, default=defaults.max_samples,
        help="Optional cap on number of samples.")
    add("--seed", type=int, default=defaults.seed, help="Random seed.")
    add("--device", type=str, default=defaults.device,
        help='Device: "auto" or "cuda" (the GPU; raises without CUDA) or "cpu".')
    add("--mlflow-tracking-uri", type=str, default=defaults.mlflow_tracking_uri,
        help="MLflow tracking URI (FileStore/JSONL if mlflow is unavailable).")
    add("--mlflow-experiment", type=str, default=defaults.mlflow_experiment,
        help="MLflow experiment name.")
    add("--run-name", type=str, default=None, help="Optional run name.")
    add("--output-dir", type=str, default=defaults.output_dir,
        help="Directory for checkpoints/config.")
    add("--cache-root", type=str, default=None,
        help="Optional npz cache root (read-through).")
    add("--require-cache", action="store_true",
        help="Fail if any requested sample is missing from --cache-root.")
    add_compile_arguments(
        parser, "one graph for the training forward and backward, one for eval")
    add("--augment", action=argparse.BooleanOptionalAction, default=defaults.augment,
        help="Enable asymmetric RGB augmentations independently on left/right.")
    add("--brightness-jitter", type=float, default=defaults.brightness_jitter,
        help="Brightness jitter; factor sampled from [1-x, 1+x].")
    add("--contrast-jitter", type=float, default=defaults.contrast_jitter,
        help="Contrast jitter; factor sampled from [1-x, 1+x].")
    add("--saturation-jitter", type=float, default=defaults.saturation_jitter,
        help="Saturation jitter; factor sampled from [1-x, 1+x].")
    add("--hue-jitter", type=float, default=defaults.hue_jitter,
        help="Hue jitter; shift sampled from [-x, x].")
    add("--gamma-jitter", type=float, default=defaults.gamma_jitter,
        help="Gamma jitter; factor sampled from [max(0.1, 1-x), 1+x].")
    add("--noise-std-max", type=float, default=defaults.noise_std_max,
        help="Max stddev for additive Gaussian noise sampled in [0, x].")
    add("--blur-prob", type=float, default=defaults.blur_prob,
        help="Probability of applying Gaussian blur per image.")
    add("--blur-sigma-max", type=float, default=defaults.blur_sigma_max,
        help="Max sigma for Gaussian blur (<= 0 disables blur).")
    add("--blur-kernel-size", type=int, default=defaults.blur_kernel_size,
        help="Gaussian blur kernel size (odd integer >= 3).")
    add("--augment-impl", type=str, default=defaults.augment_impl,
        choices=("auto", "xla", "pallas"), dest="augment_impl",
        help="Augmentation implementation: auto (the CUDA kernel on the GPU), "
             "pallas (the CUDA kernel, raises on the CPU), xla (plain PyTorch).")
    add("--input-precision", type=str, default=defaults.input_precision,
        choices=("uint8", "float32"), dest="input_precision",
        help="Host batch image precision (float32 is not usable with the "
             "packed cache).")
    add("--base-channels", type=int, default=defaults.base_channels,
        help="UNet width multiplier (32 = reference architecture); PSMNet's "
             "channels (32 = the published network).")
    add("--model", type=str, default=defaults.model, choices=("stereounet", "psmnet"),
        help="The network to train: the StereoUNet, or PSMNet (stacked hourglass, "
             "Chang & Chen 2018; three outputs, weighted smooth L1). Only the "
             "StereoUNet is served by predict, evaluate, export and the live viewer.")
    add("--max-disparity", type=int, default=defaults.max_disparity, dest="max_disparity",
        help="PSMNet's disparity range (a multiple of 16); targets at or above it "
             "are masked out of the loss.")
    add("--mesh-devices", type=int, default=defaults.mesh_devices,
        help="Data-parallel ranks on this host, one GPU each (0 = all visible "
             "GPUs; one rank on the CPU). More than the visible GPUs raises.")
    add("--spatial-devices", type=int, default=defaults.spatial_devices,
        help="Shard image height over this many ranks of a (ranks / N, N) mesh "
             "(with --mesh-devices or --multihost); it must divide the rank count.")
    add("--compute-dtype", type=str, default=defaults.compute_dtype,
        choices=("bfloat16", "float32"), help="Network compute dtype.")
    add("--packed-cache-root", type=str, default=None,
        help="Packed array cache (fast path); built automatically if missing.")
    add("--device-resident", type=str, default=defaults.device_resident,
        choices=("auto", "on", "off"), dest="device_resident",
        help="Stage the packed training set into device memory (pinned when "
             "it fits --hbm-window-gb, else rotating windows).")
    add("--hbm-window-gb", type=float, default=defaults.hbm_window_gb,
        dest="hbm_window_gb",
        help="Device memory budget (GB) for device-resident windows.")
    add("--aot-cache", type=str, default=defaults.aot_cache, dest="aot_cache",
        help="Compile cache of --compile across processes: 'auto' = "
             "<output-dir>/.aot_cache, 'off', or a directory. The first run saves "
             "Inductor's compile artifacts there and later runs of the same "
             "setting load them instead of compiling; each rank keys its own.")
    add("--aot-cache-multihost", action="store_true",
        dest="aot_cache_multihost",
        help="Use --aot-cache under --multihost too (off by default there).")
    add("--resume", type=str, default=None,
        help="Checkpoint (.pt) to resume training from.")
    add("--init-checkpoint", type=str, default=None, dest="init_checkpoint",
        help="Initialise model weights from a reference-format .pt (also one "
             "written by the JAX package's export); optimizer and epoch "
             "counter start fresh.")
    add("--log-every-batches", type=int, default=defaults.log_every_batches,
        help="Step-metric logging cadence in training batches.")
    add("--preview-samples", type=int, default=defaults.preview_samples,
        help="Fixed preview sample count logged each epoch.")
    add("--profile-dir", type=str, default=None,
        help="Write a torch.profiler trace of early training batches here; its "
             "trace.json carries the train step's train.* spans.")
    add("--profile-steps", type=int, default=defaults.profile_steps,
        help="Training batches to capture when --profile-dir is set.")
    add("--multihost", action="store_true",
        help="Train across hosts: each host process starts its --mesh-devices "
             "ranks. Give the three address flags, or none to read MASTER_ADDR, "
             "MASTER_PORT, WORLD_SIZE and RANK from the environment.")
    add("--coordinator-address", type=str, default=None,
        help="host:port of the rendezvous (on process 0's host) for --multihost.")
    add("--num-processes", type=int, default=None,
        help="Host processes of a --multihost run.")
    add("--process-id", type=int, default=None,
        help="This host process's index (0 tracks and checkpoints) in a "
             "--multihost run.")
    namespace = parser.parse_args(argv)
    values = vars(namespace)
    known = {f.name for f in fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in values.items() if k in known})
