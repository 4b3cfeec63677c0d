"""PyTorch/CUDA port of ``stereo_depth_estimation_tpu`` for NVIDIA Hopper.

Module names follow the JAX package so each counterpart is easy to find:

- ``ops``       loss, photometric augmentation (plain PyTorch) and the
                hand-written CUDA augmentation kernel (``ops.augment_cuda``,
                source in ``csrc/augment.cu``)
- ``models``    StereoUNet as an ``nn.Module`` + checkpoint key scheme and
                weight carry-over from the JAX package's variables
- ``parallel``  train / eval steps, AdamW with the JAX package's schedules,
                device-resident data step, predict fn

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
asking for CUDA on a host without it raises. Kernels are compiled from
``csrc/`` with ``nvcc`` at first use (``_build.py``).
"""

__version__ = "0.1.0"
