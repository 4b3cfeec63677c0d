"""PyTorch/CUDA port of ``stereo_depth_estimation_tpu`` for NVIDIA Hopper.

Module names follow the JAX package so each counterpart is easy to find:

- ``ops``       loss, photometric augmentation (plain PyTorch), the
                hand-written CUDA kernels (``ops.augment_cuda``, source
                ``csrc/augment.cu``; ``ops.pool``, the model's 2x2 max pool,
                source ``csrc/maxpool.cu``), disparity codec, resize,
                rectification maps and remap, stereo geometry
- ``models``    StereoUNet as an ``nn.Module`` + checkpoint key scheme and
                weight carry-over from the JAX package's variables
- ``parallel``  train / eval steps, AdamW with the JAX package's schedules,
                device-resident data step and windows, predict fn, batch
                padding
- ``data``      sample discovery and split, npz and packed caches (and the
                cache CLI), loader, batch iteration and pinned-memory
                prefetch
- ``training``  the trainer CLI (``python -m
                stereo_depth_estimation_tpu_torch.training.trainer``), its
                config, ``.pt`` checkpoints, MLflow file-store tracking,
                profiling, the export CLI
- ``eval``      the evaluate and predict CLIs, preview montages
- ``live``      the live depth viewer (``LiveDepthEngine``), the SGBM
                baseline, chessboard calibration, camera plumbing

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
asking for CUDA on a host without it raises. Kernels are compiled from
``csrc/`` with ``nvcc`` at first use (``_build.py``).
"""

__version__ = "0.1.0"
