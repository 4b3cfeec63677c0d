"""Smoke run of the PyTorch/CUDA port (``stereo_depth_estimation_tpu_torch``)
on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``stereo_depth_estimation_tpu_torch/csrc``
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version on the card (BN1-BN4, the BatchNorm + ReLU kernels of
``csrc/batchnorm.cu``, at the main path's 18 BatchNorm shapes in bf16, at
batch 16 in float32 and with bf16 statistics, at C = 4 and 36 and ragged row
counts, each launched twice and bitwise repeatable; BN1 and BN3 also with
the per-channel epilogue in their second pass, against the plain epilogue on
the kernel's own sums and the epilogue launched alone), holds the tensor
disparity codec against the numpy one, holds a fresh model built as the
trainer builds it (base 32, bf16, seed 42, on the card) to the JAX package's
initialisers and, bitwise, to the one built on the CPU from the same seed
(the "init:" line), and drives the port's paths:

- the augmented StereoUNet train step at full width (base 32, 240x320, batch
  128, bf16, over a device-resident uint8 payload), then predict: the
  augmentation's gray-mean kernel and kernel K1 (the colour chain) once per
  step, K2/K3 (the model's four 2x2 max pools, forward and backward) four
  times each per step, K2 four times per predict; then one call of the
  K-step loop (``make_device_data_train_loop``, 10 steps) under
  ``torch.cuda.set_sync_debug_mode("warn")``, its host synchronisations
  counted;
- the trainer CLI on the packed cache: a synthetic FoundationStereo-layout
  dataset, two epochs device-resident (pinned), then a resumed third;
- the convergence harness (``scripts/convergence_run.py card``) at full
  width on 288 scenes of the port's synthetic stereo generator for two
  epochs, its artifact and the kernels' launches checked; then the rescale
  CLI (``scripts/rescale_transfer.py``, width 128 to 320) on the run's
  ``best.pt``, its disparity head held to 2.5x the original's and its
  log-variance to the original's + log(2.5) in float32 on the card; then the
  progressive-resolution transfer on the same scenes: the kernels held
  against their plain versions at the 96x128 and 128x160 runs' shapes (batch
  256), the harness at 96x128 and batch 256, the rescale CLI on its
  ``best.pt``, and a finetune at 240x320 from ``rescaled.pt`` and one from
  ``best.pt`` as it is, each starting from weights bitwise those of the
  in-process rescale (or of ``best.pt``), with its artifact and launches
  checked;
- the serving path on that dataset and the trainer's ``last.pt`` (base 32,
  float32): the evaluate CLI (held against ``make_eval_step`` on the CPU),
  the predict CLI, and the live engine (640x480 captures rectified and
  resized to 240x320, batch 1) held against itself on the CPU and
  hot-reloaded; K2 four times per forward;
- data-parallel training on two ranks: two processes join one gloo group
  on the card (NCCL refuses two ranks on one GPU; gloo runs ``all_reduce``
  and ``broadcast`` on CUDA tensors, all the step needs). They take three
  full-width float32 steps in a row on the two stripes of a batch of 32,
  each held against one rank taking it over the whole batch from the two
  ranks' state before it, then run the trainer CLI with ``--multihost
  --num-processes 2`` on the trainer phase's dataset for one epoch, each
  rank running every kernel; then the script itself joins a one-rank NCCL
  group through the CLI's default backend;
- height sharding: two gloo processes on the card as a 1 (data) x 2
  (spatial) mesh, each holding a height stripe of every image (128 and 112
  of the 240 rows), the model exchanging halo rows around each of its 18
  3x3 convolutions and the augmentation (gray means and K1) running on the
  stripes. They take three full-width float32 augmented steps in a row on a
  batch of 16 whose invalid pixels lie mostly in the lower stripe, each held
  against one rank taking it over the whole images from the two ranks'
  state before it, then run the trainer CLI with ``--multihost
  --num-processes 2 --spatial-devices 2`` for one epoch, each rank running
  every kernel on its stripes;
- the compiled train step (the trainer's ``--compile``: Inductor, mode
  default, ``fullgraph=True``) at the main path's setting, with the four
  kernels inside the graph as custom ops: its cold compile, its step time
  beside the eager one, its profile, one step held against the eager model
  from the same weights on the same batch; then the trainer CLI with
  ``--compile --aot-cache <dir>`` at that shape, in this process (which
  fills the cache) and in a child process with empty Inductor and Triton
  caches of its own, which must load every graph from the blob. Inductor's
  and Triton's caches point at a fresh directory under ``build/`` for the
  whole run, so the first compile is cold, and are removed at the end;
- the StereoUNet's one constructor mode beyond width, dtype and ranks,
  ``bn_stats_dtype`` bfloat16, at the main path's setting from the default
  model's weights: one forward and backward held against the default
  model's, then timed steps with their launches and peak memory (every
  training model runs its 18 BatchNorms a step on BN1-BN4; the two-rank and
  spatial phases' models also launch the epilogue alone, "BNE", after each
  all-reduce);
- the serving forwards compiled (the serving CLIs' ``--compile``):
  evaluate over a ragged tail and predict, each against its eager run, the
  steady compiled ``predict_fn`` and eval step beside eager, the live engine
  compiled in mode ``default`` and ``reduce-overhead`` (CUDA graphs, its K2
  launches counted by the profiler) against the eager engine and across a
  hot reload, and a child process with empty Inductor and Triton caches that
  loads all three from the blobs the first process saved;
- the zero-valid gate (``csrc/gate.cu``): its snapshot and restore kernels
  against the plain versions, bitwise, over the StereoUNet's and PSMNet's
  full-width gated sets at a valid count of 1, 0 and
  NaN, timed beside their byte bound, the per-tensor loop they replaced and
  ``torch._foreach_copy_``; then five train steps with one zero-valid batch
  and its ``restores`` counter. Every training path above launches each of
  the two once a step ("G" and "GR").

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. It times each kernel against its bound, its plain version
and a PyTorch library call where one computes the same function (BN1-BN4
also beside PyTorch's BatchNorm + ReLU, forward and backward), times the
augmentation layer part by part (``augment_timing.py``), and prints one JSON
line with the kernel list and, last, the result line. Any failed
check raises, so the exit code is non-zero and no result line is printed.
Without CUDA, or outside the repository, it exits non-zero too.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from augment_timing import describe as describe_augmentation
from augment_timing import time_augmentation, time_ms
from stereo_depth_estimation_tpu_torch import _build
from stereo_depth_estimation_tpu_torch.data.dataset import StereoSampleLoader
from stereo_depth_estimation_tpu_torch.data.packed_cache import PackedCache
from stereo_depth_estimation_tpu_torch.data.pipeline import batch_iterator, loader_fetch
from stereo_depth_estimation_tpu_torch.data.samples import discover_samples, split_samples
from stereo_depth_estimation_tpu_torch.eval import evaluate, predict
from stereo_depth_estimation_tpu_torch.eval.preview import normalize_map
from stereo_depth_estimation_tpu_torch.live.depth_live_dl import CheckpointWatcher, LiveDepthEngine
from stereo_depth_estimation_tpu_torch.models import StereoUNet
from stereo_depth_estimation_tpu_torch.models.compat import rescale_resolution_transfer
from stereo_depth_estimation_tpu_torch.models.psmnet import PSMNet
from stereo_depth_estimation_tpu_torch.ops import batchnorm, cost_volume, gate, pool
from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig, sample_factors
from stereo_depth_estimation_tpu_torch.ops.augment_cuda import (
    _pack_factors,
    gray_means_cuda,
    gray_means_plain,
    pointwise_chain_cuda,
    pointwise_chain_plain,
)
from stereo_depth_estimation_tpu_torch.ops import codec
from stereo_depth_estimation_tpu_torch.ops.codec import disparity_encode_np
from stereo_depth_estimation_tpu_torch.ops.augment_cuda import augment_stereo_batch_fused
from stereo_depth_estimation_tpu_torch.ops.loss import (
    LossStats,
    accumulate_stats,
    heteroscedastic_laplace_nll,
    metrics_from_stats,
)
from stereo_depth_estimation_tpu_torch.ops.remap import Rectifier
from stereo_depth_estimation_tpu_torch.parallel import (
    CompileOptions,
    TrainState,
    compile_model,
    create_train_state,
    make_adamw,
    make_device_data_train_loop,
    make_device_data_train_step,
    make_eval_step,
    make_predict_fn,
    make_train_step,
    train_step,
)
from stereo_depth_estimation_tpu_torch.parallel.distributed import (
    initialize_multihost,
    next_farm_port,
    run_process_farm,
)
from stereo_depth_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    height_blocks,
    make_mesh,
    shard_batch_to_mesh,
)
from stereo_depth_estimation_tpu_torch.scripts import convergence_run, rescale_transfer
from stereo_depth_estimation_tpu_torch.training import checkpoint, trainer

BATCH, HW, PAYLOAD, STEPS, WARMUP = 128, (240, 320), 512, 5, 2
# The K-step loop's steps a call (make_device_data_train_loop).
LOOP_STEPS = 10
# The pools' inputs on the main path (NHWC): the four encoder levels at
# base 32 (channels 32, 64, 128, 256).
POOL_SHAPES = [(BATCH, HW[0] >> k, HW[1] >> k, 32 << k) for k in range(4)]
# Ragged cases: channels off the 16-byte groups, odd pooled sides.
POOL_RAGGED = [(2, 6, 10, 3), (2, 6, 10, 6), (3, 14, 22, 40), (1, 2, 2, 8)]
# Trainer phase: a synthetic dataset above the training size (resize runs).
TRAIN_SAMPLES, TRAIN_SOURCE_HW, TRAIN_BATCH = 160, (288, 384), 32
# Convergence phase: the harness's card mode (convergence_run) at full width
# (base 32, 240x320, batch 128, bf16, augmented, packed cache pinned on the
# card) on CONV_SAMPLES samples of the port's synthetic stereo generator (8
# scenes, seed 0) for CONV_EPOCHS epochs; then rescale_transfer from width
# 128 to 320 on the run's best.pt, both models in float32 eval mode on the
# card (TF32 off), on the validation set. The disparity head's pre-softplus
# output must be 2.5x the original's within RESCALE_TOL of its largest
# magnitude; the disparity itself 2.5x the original's within RESCALE_TOL
# relative where softplus is linear (pre-activation above SOFTPLUS_LINEAR:
# softplus(z) = z + log1p(exp(-z)), within 6.2e-6 of z there); the
# log-variance the original's + log(2.5) within RESCALE_TOL absolute where
# neither is clamped to [-6, 3]. The logvar head's weights are unchanged, so
# its two outputs differ by the bias's rounding; the disparity head's
# scaled weights round each product anew (float32 sums of 32 terms: about
# 1e-6 of the largest magnitude). A wrong ratio or a missed bias reads O(1).
CONV_SAMPLES, CONV_EPOCHS, CONV_RATIO = 288, 2, (128, 320)
RESCALE_TOL, SOFTPLUS_LINEAR = 1e-4, 12.0
# Then the progressive-resolution transfer (docs/CONVERGENCE.md section 4) on
# the same scenes: the harness at TRANSFER_HW, batch TRANSFER_BATCH (the 260
# train samples give one whole step) for CONV_EPOCHS epochs, rescale_transfer
# 128 -> 320 on its best.pt, and the harness at 240x320 (batch 128) for
# FINETUNE_EPOCHS from rescaled.pt, then from best.pt as it is (naive). The
# weights each finetune starts from, as the trainer loads them, must equal
# bitwise rescale_resolution_transfer of best.pt (naive: best.pt's).
TRANSFER_HW, TRANSFER_BATCH, FINETUNE_EPOCHS = (96, 128), 256, 1
# The kernels at the shapes of the fast (96x128) and mid (128x160) runs, batch
# 256, bf16: K1 and the gray means at (256, h, w, 6) with the blur on (the
# default blur_prob and every view), at phase_kernel_checks' and
# phase_gray_mean_checks' tolerances; K2 and K3 on each of the four pool
# levels at the model's widths (32, 64, 128, 256 channels; 96x128 pools down
# to 6x8, 128x160 to 8x10), tolerance 0 as phase_pool_checks.
TRANSFER_SHAPES = [(TRANSFER_BATCH, 96, 128), (TRANSFER_BATCH, 128, 160)]
# Serving phase, at the JAX serving CLIs' defaults: evaluate and predict at
# batch 30, the live viewer at batch 1 from 640x480 captures; StereoUNet base
# 32 in float32. Evaluate scores 60 samples of the set (two batches) and the
# val split; predict takes 40 pairs (a full batch and a tail of 10).
SERVE_BATCH, CAPTURE_HW, EVAL_SAMPLES, PREDICT_PAIRS = 30, (480, 640), 60, 40
LIVE_WARMUP, LIVE_FRAMES, LIVE_SPLIT_FRAMES = 3, 20, 5
SERVE_POOL_SHAPES = {n: [(n, HW[0] >> k, HW[1] >> k, 32 << k) for k in range(4)]
                     for n in (SERVE_BATCH, 1)}
# Card vs CPU in float32 with TF32 off: evaluate's metrics within 1e-4
# relative; the live engine's and predict_fn's disparity and log-variance
# within 1e-4 absolute (values of order 1 after 23 convolutions whose sums
# run in another order; ~1e-5 expected), the live views within one level.
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4
# Card with cuDNN's TF32 convolutions (PyTorch's default, what a user of the
# serving CLIs gets) vs CPU: disparity and log-variance within 1e-2 of the
# CPU output's largest magnitude (floored at 1). TF32 rounds each product's
# operands to 10 mantissa bits (2^-11 relative); TF32 rounding emulated in
# the convolutions on the CPU moved a base-32 forward by ~1e-4 of that
# scale. The JAX package's default convolution precision on its TPU rounds
# operands to bfloat16's 7 bits, coarser still.
TF32_TOL = 1e-2
# Steady device windows of the serving path: predict_fn and the eval step
# at batch 30, each call timed on its own; the CPU reference for predict_fn
# takes the batch's first CPU_PAIRS pairs (eval-mode BN is per sample).
SERVE_REPS, CPU_PAIRS = 12, 2
# Multi-rank phase: two ranks take MR_STEPS float32 steps in a row of the
# full-width model (base 32, 240x320, no augmentation, seed-0 weights) on the
# two stripes of a global batch of MR_BATCH; each step is held against one
# rank taking that step over the whole batch from the same state (weights,
# BatchNorm statistics, AdamW moments and count, saved by rank 0 before the
# step). Then the trainer CLI on two ranks for MR_EPOCHS epoch.
MR_BATCH, MR_STEPS, MR_EPOCHS = 32, 3, 1
# Two ranks vs one, both on the card, TF32 off, from the same state. Float
# noise separates them (the cross-rank BatchNorm's E[x^2] - E[x]^2,
# convolutions at batch 16 against 32, the gradient all-reduce): the summed
# LossStats within MR_STATS_RTOL relative, each BatchNorm running statistic
# within MR_BN_RTOL of its norm, each gradient leaf within MR_GRAD_RTOL of its
# norm (floored as GRAD_FLOOR says), and weights over lr/2 apart only where
# the two gradients are float noise across zero (the reference step's rule).
# Each limit is a small factor above what an H100 read (PERF.md section 6);
# the gradient's is the 0.8% a ReLU kink moves a leaf by on the reference
# step. One rank's own consecutive steps are not held to these:
# where a gradient is float noise, AdamW's first update lr * g / (|g| + eps)
# lands anywhere in [-lr, lr], and the next steps amplify it
# (``rank_drift.py`` measures that drift).
MR_STATS_RTOL, MR_BN_RTOL, MR_GRAD_RTOL = 1e-6, 5e-6, 0.008
# Spatial phase: two ranks as a 1 x 2 (data x spatial) mesh take SP_STEPS
# float32 augmented steps in a row (half the views blurred, so K1 blurs
# across the stripes' edges) of the full-width model on a global batch of
# SP_BATCH, each held against one rank taking that step over the whole
# images from the same state (its generator included: a 1 x S mesh draws
# the factors and noise one rank draws). Then the trainer CLI on the 1 x 2
# mesh for SP_EPOCHS epoch.
SP_BATCH, SP_STEPS, SP_EPOCHS = 16, 3, 1
SP_AUGMENT = AugmentConfig(blur_prob=0.5)
# Spatial vs one rank, both on the card, TF32 off, from the same state, the
# limits read as the MR_* ones and set as they were, a small factor above the
# reading (the gradient's at the 0.8% a ReLU kink moves a leaf by). Float
# noise separates them: the stripes' gray-mean sums, cuDNN's algorithms at 128
# and 112 rows against 240, the cross-rank BatchNorm's E[x^2] - E[x]^2.
# An H100 read 8.16e-8, 3.37e-7 and 0.22% (PERF.md section 6).
SP_STATS_RTOL, SP_BN_RTOL, SP_GRAD_RTOL = 1e-6, 5e-6, 0.008
# Compiled serving phase (the serving CLIs' --compile: Inductor, mode default
# unless said), on the serving phase's dataset and last.pt, base 32 f32, TF32
# off: evaluate scores SERVE_RAGGED samples (a batch of 30 and a tail of 20,
# padded), held to SERVE_RTOL against the eager evaluate of the same call;
# predict's npz files within a float16 ulp plus SERVE_ATOL of eager predict's;
# the live engine compiled in each mode of LIVE_MODES against the eager
# engine within SERVE_ATOL (disparity, log-variance) and one level (views).
SERVE_RAGGED = 50
LIVE_MODES = ("default", "reduce-overhead")
# Knobs phase: the StereoUNet with ``bn_stats_dtype`` bfloat16 at the main
# path's setting (base 32, bf16, batch 128, 240x320, augmented), from the
# default model's weights. One forward and backward on one augmented batch
# is held against the default model's: the summed LossStats within the
# knob's limit relative and each gradient leaf within its limit of the
# leaf's norm (floored as GRAD_FLOOR says). Then KNOB_STEPS train steps,
# timed, with peak memory.
KNOB_STEPS = 3
# name -> (the model's keyword arguments, the LossStats limit, the gradient
# limit). With every model on BN1-BN4 an H100 read 3.4e-5 and 10.7%; the
# comparisons run on cuDNN's deterministic algorithms, so that a reading
# repeats, and the default model against a copy of itself reads 0 there. bf16 statistics compute the BatchNorm backward's
# cancelling terms from bf16-rounded moments, which moves the first layer's
# gradient by half its norm: that is the knob's arithmetic, as in the JAX
# model.
KNOBS = {"bn_stats_dtype bf16": ({"bn_stats_dtype": torch.bfloat16}, 1e-3, 1.0)}
# The train step before the pools ran on K2/K3, same path and card
# (PERF.md section 5, H100 80GB HBM3 at 700 W).
BEFORE_POOL_KERNELS = "103.60 ms/step, peak memory 15.04 GiB"
# The augmentation before K1's redesign and the gray-mean kernel, same shape
# and card (PERF.md section 6, H100 80GB HBM3 at 700 W; the whole call as
# first read, before timed launches were queued behind a spin).
BEFORE_AUGMENT_REDESIGN = "K1 442.0 us, whole augment_stereo_batch_fused 2212.7 us"

# BatchNorm kernels BN1-BN4 (csrc/batchnorm.cu): the main path's 18
# BatchNorm inputs as (N, H, W, C) by level, with the number of BatchNorms
# at each (two in each encoder and decoder block, two in the bottleneck).
# The kernels take them as (M = N*H*W, C) rows of channels.
BN_LEVELS = [(BATCH, HW[0] >> k, HW[1] >> k, 32 << k, 2 if k == 4 else 4) for k in range(5)]
BN_NAMES = ("BN1", "BN2", "BN3", "BN4")
BN_EPS = 1e-5
# The checks also run these shapes at batch BN_F32_BATCH (float32, as the
# multi-rank and spatial phases run them; and bf16 statistics), and ragged
# (M, C): C = 4 and 36 (no 16-byte groups in bf16; 36 float32 channels are
# nine), and M off every multiple of a block's rows.
BN_F32_BATCH = 16
BN_RAGGED = [(1_000_003, 4), (77_777, 36), (4_099, 64), (33, 512)]
# Kernel vs plain: the sums (BN1, BN3) within BN_SUM_RTOL of the sum of their
# terms' magnitudes, per channel: they add in another order (registers, a
# block's rows, then the blocks' partials). With bf16 statistics each mean
# within one bf16 ulp: the means are rounded to bf16 after the sum, and a
# sum within float noise of a rounding boundary goes the other way. BN2 and
# BN4 within one ulp of their output dtype (the same correctly rounded
# float32 operations as the plain version; 0 is expected).
BN_SUM_RTOL = 1e-5
# The epilogue (the statistics, the running update, BN4's coefficients) on
# the same sums: each step one correctly rounded float32 operation in the
# kernel and in the plain version's PyTorch ops, so 0 ulps is expected.
BN_EPILOGUE_ULPS = 1.0
# (name, function, what the kernel stands for in the JAX package: XLA fuses
# that work there, so the line is the JAX source's, not a TPU kernel's).
BN_KERNELS = (
    ("BN1", "bn_stats", "stereo_depth_estimation_tpu/models/unet.py:67-70 (flax BatchNorm "
     "statistics) and :133-135 (_fcbr_fwd_math), XLA fusions"),
    ("BN2", "bn_relu_fwd", "stereo_depth_estimation_tpu/models/unet.py:86-88 (flax "
     "BatchNorm normalisation + ReLU) and :136-138, XLA fusions"),
    ("BN3", "bn_relu_bwd_sums", "stereo_depth_estimation_tpu/models/unet.py:183-194 "
     "(_fcbr_bwd sums), XLA fusions"),
    ("BN4", "bn_relu_bwd_dx", "stereo_depth_estimation_tpu/models/unet.py:196-200 "
     "(_fcbr_bwd dz), XLA fusions"),
)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Operations per pixel and view of the colour chain and gamma, counting each
# f32 add, sub, mul, div, min, max, compare, select, floor, int->float
# conversion and powf as one (csrc/augment.cu chain_view + load_pixel):
# decode 6, brightness 9, contrast 14, saturation 19, rgb->hsv 44,
# hsv->rgb + gamma 50.
CHAIN_OPS_PER_PIXEL_VIEW = 142
# Operations per input byte of the gray means, counted the same way:
# decode 2 (int->float, * 1/255), brightness 3 (mul, min, max), weight 1,
# sum 1.
GRAY_MEAN_OPS_PER_BYTE = 7

# Reference step, card vs CPU (f32, TF32 off): each parameter's gradient
# within 5% of its norm, the norm floored at 1% of the largest one's. Where
# no ReLU input lies within float noise of 0 the two agree to ~1e-5 of the
# norm. Where one does, it falls on the other side of the kink on the other
# device, and a leaf's gradient moves by about one of its ~1e4 summands
# (~1%). Measured on an H100: up to 0.8%, the same 0.8% that separates x/255
# from the still augmentation chain's output (1e-6 apart) on the CPU alone.
# A K3 that routes to the wrong window position is off by 65-74% of the
# norm of every first-level leaf.
GRAD_RTOL, GRAD_FLOOR = 0.05, 1e-2

# Compiled step (Inductor, the trainer's --compile default) vs the eager
# model, one step from the same weights on the same augmented bf16 batch at
# the main path's shape: the summed LossStats within COMPILED_STATS_RTOL
# relative, each gradient leaf within COMPILED_GRAD_RTOL of its norm
# (floored as GRAD_FLOOR says). Inductor fuses BatchNorm, ReLU and the
# elementwise passes into generated kernels that round to bf16 at other
# places and sum in another order than PyTorch's eager kernels. Each limit
# is a few times the most an H100 read at this point (PERF.md section 6:
# 1.6e-5 and 0.80%); K3 routed to the wrong window position inside the graph
# reads 44x the gradient's (``compile_fault.py``).
COMPILED_STATS_RTOL, COMPILED_GRAD_RTOL = 1e-4, 0.02

# Kernel vs plain: f32 outputs within 1e-5 (FMA contraction, the kernel's
# approximate ex2/lg2/rcp and expf ulps; near 0, the min channel of hsv->rgb
# is a cancellation that x^gamma amplifies, to ~5e-6). bf16 outputs within one bf16 ulp of the
# larger value plus that f32 tolerance. The gray means (each <= 1) within
# 1e-5 too, and bitwise equal on two runs of the kernel.
F32_TOL = 1e-5

# Hand-set factors for the fast-math edge cases, cycled over a batch's views:
# the ends of the default ranges (brightness 0.75/1.25, gamma exactly
# 0.8/1.2, hue shifts of +-0.09) and identities.
EDGE_FACTORS = {
    "brightness": [0.75, 1.25, 1.0],
    "contrast": [0.75, 1.25, 1.0, 1.1],
    "saturation": [0.75, 1.25, 1.0],
    "hue": [0.09, -0.09, 0.0, 0.05],
    "gamma": [0.8, 1.2, 1.0],
    "blur_on": [1.0, 0.0, 0.0, 1.0, 1.0],
    "blur_sigma": [0.3, 1.0],
    "noise_std": [0.0],
}
# Saturation factors that pull every channel to within ~1e-6 of the luma, so
# that channels fall within the max-channel rule's eps of the max.
NEAR_MAX_SATURATION = [1e-6, 2e-6, 5e-7, 0.0]
EDGE_KINDS = ("0/255", "gray", "near max", "hue wrap")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_case(gen, n, h, w, blur_prob, config=None):
    """Random uint8 batch + sampled, packed factors at one shape and config."""
    cfg = config or AugmentConfig(blur_prob=blur_prob)
    images = torch.randint(0, 256, (n, h, w, 6), dtype=torch.uint8, device="cuda",
                           generator=gen)
    factors = sample_factors(gen, 2 * n, cfg)
    packed = _pack_factors(images, factors, n)
    blur_k = cfg.blur_kernel_size if cfg.blur_enabled else 0
    return images, packed, blur_k


def compare_kernel(images, packed, blur_k, out_dtype) -> tuple[float, torch.Tensor]:
    """K1 against its plain version on the same inputs; returns the largest
    error and the kernel's output."""
    out = pointwise_chain_cuda(images, packed, blur_k, out_dtype)
    ref = pointwise_chain_plain(images, packed, blur_k, out_dtype)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, "kernel shape/dtype")
    check(bool(torch.isfinite(out.float()).all()), "kernel output not finite")
    err = (out.float() - ref.float()).abs()
    if out_dtype == torch.float32:
        check(float(err.max()) <= F32_TOL, f"kernel vs plain f32 err {float(err.max())}")
    else:
        ulp = torch.maximum(bf16_ulp(out.float()), bf16_ulp(ref.float()))
        check(bool((err <= ulp + F32_TOL).all()),
              f"kernel vs plain bf16 err {float(err.max())} > 1 ulp + {F32_TOL:g}")
    return float(err.max()), out


def misaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of the uint8 batch ``x`` whose data starts one pixel (6 bytes)
    past a 16-byte boundary: the kernels' one-pixel-a-thread path."""
    buf = torch.empty(x.numel() + 6, dtype=x.dtype, device=x.device)
    buf[6:].copy_(x.flatten())
    return buf[6:].view(x.shape)


def edge_case(gen, kind: str, n: int, h: int, w: int):
    """A uint8 batch of one edge-case ``kind`` and its packed hand-set factors."""
    u8 = dict(dtype=torch.uint8, device="cuda", generator=gen)
    if kind == "0/255":  # the darkest and brightest pixels; image 0 all 0, image 1 all 255
        images = torch.randint(0, 2, (n, h, w, 6), **u8) * 255
        images[0], images[1] = 0, 255
    elif kind == "gray":  # r == g == b in both views: the eqc path
        images = torch.randint(0, 256, (n, h, w, 2), **u8).repeat_interleave(3, dim=-1)
    elif kind == "near max":
        images = torch.randint(0, 256, (n, h, w, 6), **u8)
    else:  # "hue wrap": red maxima with green and blue close, so h lies near 0 or 1
        r = torch.randint(150, 256, (n, h, w, 2, 1), **u8)
        gb = r - torch.randint(0, 40, (n, h, w, 2, 2), **u8)
        images = torch.cat([r, gb], dim=-1).flatten(-2)
    lists = dict(EDGE_FACTORS)
    if kind == "near max":
        lists["saturation"] = NEAR_MAX_SATURATION
    factors = {name: torch.tensor([v[i % len(v)] for i in range(2 * n)], device="cuda")
               for name, v in lists.items()}
    factors["blur_on"] = factors["blur_on"] > 0
    return images, _pack_factors(images, factors, n, gray_means_plain)


def phase_kernel_checks() -> dict[tuple, float]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errors = {}
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(BATCH, *HW, bp) for bp in (0.0, 0.03, 1.0)]
    # Ragged sides, the smallest image k=5 reflect padding allows, and a
    # resolution above the TPU kernel's whole-image limit: one kernel for all.
    cases += [(2, 37, 53, 0.0), (2, 37, 53, 1.0), (2, 3, 3, 1.0), (2, 480, 640, 1.0)]
    for n, h, w, bp in cases:
        for dtype in dtypes:
            images, packed, blur_k = kernel_case(gen, n, h, w, bp)
            blurred = int((packed[:, [6, 14]] > 0).sum()) if blur_k else 0
            err, _ = compare_kernel(images, packed, blur_k, dtype)
            tol = f"{F32_TOL:g}" if dtype == torch.float32 else f"1 bf16 ulp + {F32_TOL:g}"
            print(f"kernel check: {n}x{h}x{w} blur_prob={bp} blur_k={blur_k} "
                  f"blurred_views={blurred} out={str(dtype).split('.')[-1]} "
                  f"max_abs_err={err:.3g} tol={tol} ok")
            errors[(n, h, w, bp, dtype)] = err

    # The fast math's edge cases at the same tolerances, on the 16-byte path
    # (4x40x56) and the one-pixel path (a ragged 3x37x53), with and without
    # the blur; an all-0 image must give exact zeros (x^g at x = 0).
    for kind in EDGE_KINDS:
        worst = 0.0
        for n, h, w in ((4, 40, 56), (3, 37, 53)):
            images, packed = edge_case(gen, kind, n, h, w)
            for blur_k in (0, 5):
                for dtype in dtypes:
                    err, out = compare_kernel(images, packed, blur_k, dtype)
                    worst = max(worst, err)
                    if kind == "0/255":
                        check(bool((out[0] == 0).all()), f"K1 of an all-0 image is not 0 "
                              f"({n}x{h}x{w} blur_k={blur_k} {dtype})")
        print(f"kernel check: edge case {kind!r} at 4x40x56 and 3x37x53, blur_k 0 and 5, "
              f"f32 and bf16 out: max_abs_err={worst:.3g} (same tolerances)"
              + ("; an all-0 image gives exact zeros" if kind == "0/255" else "") + " ok")
        errors[("edge", kind)] = worst
    # A misaligned input view: the one-pixel path at a shape whose H*W alone
    # would take the 16-byte path.
    for bp in (0.0, 1.0):
        images, packed, blur_k = kernel_case(gen, 2, *HW, bp)
        images = misaligned_copy(images)
        for dtype in dtypes:
            errors[("misaligned", bp, dtype)], _ = compare_kernel(images, packed, blur_k, dtype)
        print(f"kernel check: misaligned 2x{HW[0]}x{HW[1]} input (one pixel a thread), "
              f"blur_prob={bp}, f32 and bf16 out: max_abs_err="
              f"{max(errors[('misaligned', bp, d)] for d in dtypes):.3g} (same tolerances) ok")
    return errors


def phase_gray_mean_checks() -> float:
    """The gray-mean kernel against its plain version (within F32_TOL) and
    against a second run of itself (bitwise), on the 16-byte path, ragged
    shapes and a misaligned view; returns the main shape's error."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    main_err = 0.0
    cases = [((BATCH, *HW), False), ((3, 37, 53), False), ((2, 3, 3), False),
             ((2, *HW), True)]
    for shape, off in cases:
        images = torch.randint(0, 256, (*shape, 6), dtype=torch.uint8, device="cuda",
                               generator=gen)
        if off:
            images = misaligned_copy(images)
        brightness = torch.rand(2 * shape[0], device="cuda", generator=gen) * 0.5 + 0.75
        brightness[:4] = torch.tensor([0.75, 1.25, 0.75, 1.25])  # the range's ends
        first = gray_means_cuda(images, brightness)
        second = gray_means_cuda(images, brightness)
        ref = gray_means_plain(images, brightness)
        torch.cuda.synchronize()
        err = float((first - ref).abs().max())
        check(err <= F32_TOL, f"gray means vs plain err {err} at {shape}")
        check(torch.equal(first.view(torch.int32), second.view(torch.int32)),
              f"gray means differ between two runs at {shape}")
        if shape == (BATCH, *HW):
            main_err = err
        print(f"gray-mean check: {'x'.join(map(str, shape))}{' misaligned' if off else ''}: "
              f"max_abs_err={err:.3g} tol={F32_TOL:g}, two runs bitwise equal ok")
    return main_err


def tie_rich(gen, shape, dtype, nan: bool = False, misaligned: bool = False) -> torch.Tensor:
    """Post-ReLU normals on a 1/4 grid (ties in most windows), NHWC; ``nan``
    puts a NaN at each window position of the first four windows of channel
    0; ``misaligned`` offsets the data by one element (the kernels' scalar
    path)."""
    x = (torch.relu(torch.randn(shape, device="cuda", generator=gen)) * 4).round() / 4
    if nan:
        for k in range(min(4, shape[2] // 2)):
            x[0, k // 2 % 2, 2 * k + k % 2, 0] = float("nan")
    x = x.to(dtype)
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(x.flatten())
        x = buf[1:].view(shape)
    return x


def equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and values, NaN where NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def phase_pool_checks() -> None:
    """K2/K3 against their plain versions, equal (the pool only selects:
    tolerance 0): y, idx and dx at the four main-path shapes and the ragged
    cases, f32 and bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    cases = [(s, {}) for s in POOL_SHAPES]
    cases += [(s, {"nan": True}) for s in POOL_RAGGED]
    cases += [(POOL_SHAPES[0][:1] + POOL_SHAPES[3][1:], {"misaligned": True})]
    for shape, opts in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = tie_rich(gen, shape, dtype, **opts)
            y, idx = pool.maxpool2x2_fwd_cuda(x)
            ref_y, ref_idx = pool.maxpool2x2_fwd_plain(x)
            dy = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
            dx = pool.maxpool2x2_bwd_cuda(dy, idx)
            ref_dx = pool.maxpool2x2_bwd_plain(dy, ref_idx)
            torch.cuda.synchronize()
            check(equal_nan(y, ref_y), f"K2 y differs at {shape} {dtype} {opts}")
            check(torch.equal(idx, ref_idx), f"K2 idx differs at {shape} {dtype} {opts}")
            check(equal_nan(dx, ref_dx), f"K3 dx differs at {shape} {dtype} {opts}")
            ties = float((idx > 0).float().mean())
            print(f"pool check: {'x'.join(map(str, shape))} {str(dtype).split('.')[-1]} "
                  f"{' '.join(opts) or 'aligned'}: K2 y, idx and K3 dx equal to the plain "
                  f"versions (tol 0; {100 * ties:.1f}% of windows not at position 0) ok")
            del x, y, idx, dy, dx, ref_y, ref_idx, ref_dx


def pool_bytes(shape, itemsize: int) -> int:
    """Bytes one K2 (or K3) call must move: x (dx) once, y (dy) once, idx once."""
    n, h, w, c = shape
    out = n * (h // 2) * (w // 2) * c
    return n * h * w * c * itemsize + out * itemsize + out


def phase_pool_timing(shapes=POOL_SHAPES, dtype=torch.bfloat16,
                      backward: bool = True) -> dict[str, dict]:
    """K2 (and K3 with ``backward``) at ``shapes``: kernel, plain and library
    (F.max_pool2d with indices and its backward) times, summed over the
    shapes, with the byte bound. At each shape the kernels' outputs are held
    equal to the plain versions' (tolerance 0, as in phase_pool_checks)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    names = ("K2", "K3") if backward else ("K2",)
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for name in names}
    itemsize = torch.empty((), dtype=dtype).element_size()
    type_name = str(dtype).split(".")[-1]
    for shape in shapes:
        launches = (pool.maxpool2x2_fwd_cuda.launches, pool.maxpool2x2_bwd_cuda.launches)
        x = tie_rich(gen, shape, dtype)
        y, idx = pool.maxpool2x2_fwd_cuda(x)
        ref_y, ref_idx = pool.maxpool2x2_fwd_plain(x)
        torch.cuda.synchronize()
        check(equal_nan(y, ref_y) and torch.equal(idx, ref_idx),
              f"K2 differs from its plain version at {shape} {dtype} (timed shape)")
        errs = {"K2": float((y.float() - ref_y.float()).nan_to_num(0.0).abs().max())}
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last, as the model holds it
        lib_y, lib_idx = F.max_pool2d(x_nchw, 2, return_indices=True)
        times = {"K2": (time_ms(lambda: pool.maxpool2x2_fwd_cuda(x), 20),
                        time_ms(lambda: pool.maxpool2x2_fwd_plain(x), 3),
                        time_ms(lambda: F.max_pool2d(x_nchw, 2, return_indices=True), 20))}
        if backward:
            dy = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
            dx, ref_dx = pool.maxpool2x2_bwd_cuda(dy, idx), pool.maxpool2x2_bwd_plain(dy, idx)
            torch.cuda.synchronize()
            check(equal_nan(dx, ref_dx),
                  f"K3 differs from its plain version at {shape} {dtype} (timed shape)")
            errs["K3"] = float((dx.float() - ref_dx.float()).nan_to_num(0.0).abs().max())
            del dx, ref_dx
            dy_nchw = dy.permute(0, 3, 1, 2)
            times["K3"] = (
                time_ms(lambda: pool.maxpool2x2_bwd_cuda(dy, idx), 20),
                time_ms(lambda: pool.maxpool2x2_bwd_plain(dy, idx), 3),
                time_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    dy_nchw, x_nchw, [2, 2], [2, 2], [0, 0], [1, 1], False, lib_idx), 20))
            del dy, dy_nchw
        # Timing launches are not the main path's: restore the counts.
        pool.maxpool2x2_fwd_cuda.launches, pool.maxpool2x2_bwd_cuda.launches = launches
        nbytes = pool_bytes(shape, itemsize)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        for name, (ms, plain_ms, lib_ms) in times.items():
            sums[name]["ms"] += ms
            sums[name]["plain_ms"] += plain_ms
            sums[name]["library_ms"] += lib_ms
            sums[name]["bound_ms"] += bound_ms
            sums[name]["max_abs_err"] = max(sums[name]["max_abs_err"], errs[name])
            print(f"pool timing: {name} {'x'.join(map(str, shape))} {type_name}: kernel "
                  f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library "
                  f"{lib_ms * 1e3:.1f} us, byte bound {bound_ms * 1e3:.1f} us "
                  f"({nbytes / 1e6:.1f} MB), {100 * bound_ms / ms:.1f}% of bound; equal to "
                  f"the plain version (max_abs_err {errs[name]:g}, tol 0) ok")
        del x, y, idx, ref_y, ref_idx, x_nchw, lib_y, lib_idx
    for name, s in sums.items():
        print(f"pool timing: {name} over the {len(shapes)} levels at batch {shapes[0][0]} "
              f"{type_name}: kernel {s['ms'] * 1e3:.1f} us, plain {s['plain_ms'] * 1e3:.1f} us, "
              f"library {s['library_ms'] * 1e3:.1f} us, byte bound {s['bound_ms'] * 1e3:.1f} "
              f"us, {100 * s['bound_ms'] / s['ms']:.1f}% of bound")
    return sums


def bn_relative_gap(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """Largest |got - want| relative to ``scale`` (floored at the smallest
    normal float32)."""
    return float(((got - want).abs() / scale.clamp(min=2.0**-126)).max())


def ulp_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest distance of ``got`` from ``want`` in ulps of ``want``'s dtype
    at ``want``'s magnitude."""
    g, w = got.float(), want.float()
    if want.dtype == torch.bfloat16:
        spacing = bf16_ulp(w)
    else:
        a = w.abs()
        spacing = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return float(((g - w).abs() / spacing).max())


def bn_inputs(gen, m: int, c: int, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """x, dy (m, c) in ``dtype`` (x normal with a per-channel offset, so
    that about half the pre-activations are below 0), gamma and beta."""
    shift = torch.randn((c,), device="cuda", generator=gen)
    x = torch.randn((m, c), device="cuda", generator=gen).mul_(1.5).add_(shift).to(dtype)
    dy = torch.randn((m, c), device="cuda", generator=gen).to(dtype)
    gamma = 1.0 + 0.2 * torch.randn((c,), device="cuda", generator=gen)
    beta = 0.2 * torch.randn((c,), device="cuda", generator=gen)
    return {"x": x, "dy": dy, "gamma": gamma, "beta": beta}


def bn_running(gen, c: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Running buffers part way through training: mean, var and count."""
    return (torch.randn((c,), device="cuda", generator=gen),
            0.5 + torch.rand((c,), device="cuda", generator=gen),
            torch.full((), 7, dtype=torch.long, device="cuda"))


def copies(tensors) -> tuple[torch.Tensor, ...]:
    return tuple(t.clone() for t in tensors)


def bn_case(gen, m: int, c: int, dtype: torch.dtype, relu: bool, bf16_stats: bool) -> dict:
    """BN1-BN4 against their plain versions on one case, each kernel
    launched twice, bitwise equal. BN1 and BN3 also with the epilogue in
    their second pass, as ``bn_relu_forward`` and ``bn_relu_backward`` run
    them (the statistics with the running update; dbeta, dgamma, t1 and
    t2): within BN_EPILOGUE_ULPS of the plain epilogue on the kernel's own
    sums, and bitwise equal to the epilogue alone (the group path's launch)
    on those sums; their BN2 and BN4 bitwise the kernels' launched alone on
    the same statistics and coefficients. Returns each kernel's gap, its unit ("rel":
    BN1, BN3 relative to the sum of the terms' magnitudes; "ulps": BN1's
    bf16-statistics means in bf16 ulps, the epilogues, BN2 and BN4 in ulps)
    and its largest absolute error."""
    t = bn_inputs(gen, m, c, dtype)
    x, dy, gamma, beta = t["x"], t["dy"], t["gamma"], t["beta"]
    what = f"({m}, {c}) {str(dtype).split('.')[-1]} relu {relu} bf16 statistics {bf16_stats}"
    out = {}

    sums, want = batchnorm.bn_stats_cuda(x, bf16_stats), batchnorm.bn_stats_plain(x, bf16_stats)
    check(torch.equal(sums, batchnorm.bn_stats_cuda(x, bf16_stats)), f"BN1 repeat differs {what}")
    check(float(sums[2 * c]) == m, f"BN1 count {float(sums[2 * c])}, expected {m} {what}")
    if bf16_stats:
        gap = ulp_gap((sums[:2 * c] / m).bfloat16(), (want[:2 * c] / m).bfloat16())
    else:
        xf = x.float()
        gap = bn_relative_gap(sums[:2 * c], want[:2 * c],
                              torch.cat([xf.abs().sum(0), (xf * xf).sum(0)]))
        del xf
    out["BN1"] = (gap, "ulps" if bf16_stats else "rel", float((sums - want).abs().max()))

    running = bn_running(gen, c)
    folded, plain, alone = copies(running), copies(running), copies(running)
    y, stats = batchnorm.bn_relu_forward_cuda(x, gamma, beta, *folded, BN_EPS, 0.1, bf16_stats,
                                              relu)
    want = batchnorm.bn_moments_plain(sums, gamma, *plain, BN_EPS, 0.1)
    check(torch.equal(stats, batchnorm.bn_moments_cuda(sums, gamma, *alone, BN_EPS, 0.1))
          and all(torch.equal(a, b) for a, b in zip(folded, alone)),
          f"BN1's epilogue folded and alone differ {what}")
    check(torch.equal(folded[2], plain[2]) and int(folded[2]) == 8,
          f"num_batches_tracked {int(folded[2])}, expected 8 {what}")
    out["BN1 epilogue"] = (max(ulp_gap(stats, want), ulp_gap(folded[0], plain[0]),
                               ulp_gap(folded[1], plain[1])), "ulps",
                           float((stats - want).abs().max()))

    got = batchnorm.bn_relu_fwd_cuda(x, stats, beta, relu)
    want = batchnorm.bn_relu_fwd_plain(x, stats, beta, relu)
    check(torch.equal(got, batchnorm.bn_relu_fwd_cuda(x, stats, beta, relu))
          and torch.equal(got, y), f"BN2 repeat or bn_relu_forward's BN2 differs {what}")
    out["BN2"] = (ulp_gap(got, want), "ulps", float((got.float() - want.float()).abs().max()))
    del got, want, y

    sums = batchnorm.bn_relu_bwd_sums_cuda(dy, x, stats, beta, relu)
    want = batchnorm.bn_relu_bwd_sums_plain(dy, x, stats, beta, relu)
    check(torch.equal(sums, batchnorm.bn_relu_bwd_sums_cuda(dy, x, stats, beta, relu)),
          f"BN3 repeat differs {what}")
    dyp = batchnorm._masked(dy, x, stats, beta, relu)
    terms = torch.cat([dyp.abs().sum(0), (dyp * (x.float() - stats[:c])).abs().sum(0)])
    del dyp
    out["BN3"] = (bn_relative_gap(sums, want, terms), "rel", float((sums - want).abs().max()))

    dz, coef = batchnorm.bn_relu_backward_cuda(dy, x, stats, beta, BN_EPS, relu)
    want = batchnorm.bn_bwd_coefficients_plain(sums, sums, stats, BN_EPS)
    check(torch.equal(coef, batchnorm.bn_bwd_coefficients_cuda(sums, sums, stats, BN_EPS)),
          f"BN3's epilogue folded and alone differ {what}")
    out["BN3 epilogue"] = (ulp_gap(coef, want), "ulps", float((coef - want).abs().max()))

    got = batchnorm.bn_relu_bwd_dx_cuda(dy, x, stats, beta, coef, relu)
    want = batchnorm.bn_relu_bwd_dx_plain(dy, x, stats, beta, coef, relu)
    check(torch.equal(got, batchnorm.bn_relu_bwd_dx_cuda(dy, x, stats, beta, coef, relu))
          and torch.equal(got, dz), f"BN4 repeat or bn_relu_backward's BN4 differs {what}")
    out["BN4"] = (ulp_gap(got, want), "ulps", float((got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()
    for name, (gap, unit, _) in out.items():
        tol = (BN_EPILOGUE_ULPS if "epilogue" in name else 1.0) if unit == "ulps" else BN_SUM_RTOL
        check(gap <= tol, f"{name} off its plain version by {gap:.3g} (tol {tol:g}) {what}")
    return out


def bn_check_cases() -> list[tuple[int, int, torch.dtype, bool, bool]]:
    """(m, c, dtype, relu, bf16 statistics) of the BN-check phase: the main
    path's five shapes in bf16 (ReLU on), f32 at batch 16 (ReLU off), bf16
    statistics at batch 16 (ReLU on), and the ragged cases in both dtypes."""
    cases = [(n * h * w, c, torch.bfloat16, True, False) for n, h, w, c, _ in BN_LEVELS]
    cases += [(BN_F32_BATCH * h * w, c, torch.float32, False, False)
              for _, h, w, c, _ in BN_LEVELS]
    cases += [(BN_F32_BATCH * h * w, c, torch.bfloat16, True, True)
              for _, h, w, c, _ in BN_LEVELS]
    for i, (m, c) in enumerate(BN_RAGGED):
        cases += [(m, c, torch.bfloat16, i % 2 == 0, i % 2 == 1),
                  (m, c, torch.float32, i % 2 == 1, False)]
    return cases


def phase_bn_checks() -> dict[str, float]:
    """BN1-BN4 against their plain versions (``bn_case``) on every case of
    ``bn_check_cases``. Returns each kernel's largest absolute error at the
    main path's bf16 shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    before = launcher_counts()
    worst: dict[str, float] = {}
    main_err = dict.fromkeys(BN_NAMES, 0.0)
    main = {(n * h * w, c) for n, h, w, c, _ in BN_LEVELS}
    for m, c, dtype, relu, bf16_stats in bn_check_cases():
        out = bn_case(gen, m, c, dtype, relu, bf16_stats)
        for name, (gap, unit, err) in out.items():
            key = f"{name} {unit}"
            worst[key] = max(worst.get(key, 0.0), gap)
            if (m, c) in main and dtype == torch.bfloat16 and name in main_err:
                main_err[name] = max(main_err[name], err)
        print(f"bn check: ({m}, {c}) {str(dtype).split('.')[-1]} relu {relu} bf16 statistics "
              f"{bf16_stats}: " + ", ".join(f"{k} {g:.3g} {u}" for k, (g, u, _) in out.items())
              + " ok; two launches of each bitwise equal")
        torch.cuda.empty_cache()
    restore_counts(before)  # check launches are not a path's
    print(f"bn check: every case within its tolerance (sums {BN_SUM_RTOL:g} of the terms' "
          f"magnitudes, bf16-statistics means and elementwise outputs one ulp, the epilogues "
          f"{BN_EPILOGUE_ULPS:g} ulp on the kernel's own sums and bitwise the epilogue alone); "
          f"worst "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return main_err


def bn_bytes(name: str, m: int, c: int, itemsize: int) -> int:
    """Bytes a kernel must move at (m, c): its (m, c) inputs read once and
    outputs written once (the (C,) vectors and sums are negligible but
    counted)."""
    big = {"BN1": 1, "BN2": 2, "BN3": 2, "BN4": 3}[name] * m * c * itemsize
    small = {"BN1": 2 * c + 1, "BN2": 3 * c, "BN3": 5 * c, "BN4": 5 * c}[name] * 4
    return big + small


def phase_bn_timing() -> dict[str, dict]:
    """BN1-BN4 at the main path's 18 BatchNorm inputs (bf16, ReLU on), summed
    over the layers: kernel, plain version, the PyTorch primitive
    that computes the same function (batch_norm_stats, batch_norm_elemt,
    batch_norm_backward_reduce, batch_norm_backward_elemt, which the port
    never calls) and the byte bound; the two calls the model makes
    (``bn_relu_forward``: BN1 with the epilogue in its second pass, then
    BN2; ``bn_relu_backward``: BN3 with the epilogue, then BN4); and
    PyTorch's BatchNorm + ReLU, forward (torch.batch_norm in training +
    relu_) and autograd backward, beside them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    before = launcher_counts()
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
            for name in BN_NAMES}
    cudnn = {"forward": 0.0, "backward": 0.0}
    passes = {"forward": 0.0, "backward": 0.0}
    for n_img, h, w, c, layers in BN_LEVELS:
        m = n_img * h * w
        t = bn_inputs(gen, m, c, torch.bfloat16)
        x, dy, gamma, beta = t["x"], t["dy"], t["gamma"], t["beta"]
        running = bn_running(gen, c)
        stats = batchnorm.bn_relu_forward_plain(x, gamma, beta, *copies(running), BN_EPS, 0.1,
                                                False, True)[1]
        coef = batchnorm.bn_relu_backward_plain(dy, x, stats, beta, BN_EPS, True)[1]
        # The (N, C, H, W) channels_last views the library calls take.
        x4, dy4 = (v.view(n_img, h, w, c).permute(0, 3, 1, 2) for v in (x, dy))
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        lib_mean, lib_invstd = torch.batch_norm_stats(x4, BN_EPS)
        reduced = torch.batch_norm_backward_reduce(dy4, x4, lib_mean, lib_invstd, gamma,
                                                   True, True, True)
        count = torch.full((1,), m, dtype=torch.int32, device="cuda")
        kernels = {
            "BN1": (lambda: batchnorm.bn_stats_cuda(x, False),
                    lambda: batchnorm.bn_stats_plain(x, False),
                    lambda: torch.batch_norm_stats(x4, BN_EPS)),
            "BN2": (lambda: batchnorm.bn_relu_fwd_cuda(x, stats, beta, True),
                    lambda: batchnorm.bn_relu_fwd_plain(x, stats, beta, True),
                    lambda: torch.batch_norm_elemt(x4, gamma, beta, lib_mean, lib_invstd,
                                                   BN_EPS)),
            "BN3": (lambda: batchnorm.bn_relu_bwd_sums_cuda(dy, x, stats, beta, True),
                    lambda: batchnorm.bn_relu_bwd_sums_plain(dy, x, stats, beta, True),
                    lambda: torch.batch_norm_backward_reduce(dy4, x4, lib_mean, lib_invstd,
                                                             gamma, True, True, True)),
            "BN4": (lambda: batchnorm.bn_relu_bwd_dx_cuda(dy, x, stats, beta, coef, True),
                    lambda: batchnorm.bn_relu_bwd_dx_plain(dy, x, stats, beta, coef, True),
                    lambda: torch.batch_norm_backward_elemt(dy4, x4, lib_mean, lib_invstd,
                                                            gamma, reduced[0], reduced[1],
                                                            count)),
        }
        # The model's two calls: BN1 with the epilogue then BN2, BN3 with the
        # epilogue then BN4.
        passes["forward"] += layers * time_ms(
            lambda: batchnorm.bn_relu_forward_cuda(x, gamma, beta, *running, BN_EPS, 0.1, False,
                                                   True), 20)
        passes["backward"] += layers * time_ms(
            lambda: batchnorm.bn_relu_backward_cuda(dy, x, stats, beta, BN_EPS, True), 20)
        line = []
        for name, (kernel, plain, library) in kernels.items():
            ms, plain_ms, lib_ms = time_ms(kernel, 20), time_ms(plain, 3), time_ms(library, 20)
            bound = bn_bytes(name, m, c, 2) / HBM_BYTES_PER_S * 1e3
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", bound)):
                sums[name][key] += layers * v
            line.append(f"{name} {ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f}, library "
                        f"{lib_ms * 1e3:.1f}, bound {bound * 1e3:.1f}, "
                        f"{100 * bound / ms:.0f}%)")
        xg = x4.detach().requires_grad_()
        wg, bg = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        y = torch.relu(torch.batch_norm(xg, wg, bg, rm, rv, True, 0.1, BN_EPS, True))
        fwd = time_ms(lambda: torch.relu_(torch.batch_norm(x4, gamma, beta, rm, rv, True, 0.1,
                                                           BN_EPS, True)), 20)
        bwd = time_ms(lambda: torch.autograd.grad(y, (xg, wg, bg), dy4, retain_graph=True), 20)
        cudnn["forward"] += layers * fwd
        cudnn["backward"] += layers * bwd
        print(f"bn timing: ({m}, {c}) bf16 x{layers}: " + "; ".join(line)
              + f"; PyTorch BatchNorm + ReLU forward {fwd * 1e3:.1f} us, backward "
              f"{bwd * 1e3:.1f} us ({card()})")
        del t, x, dy, x4, dy4, xg, y, kernels
        torch.cuda.empty_cache()
    restore_counts(before)  # timing launches are not a path's
    for name, s in sums.items():
        print(f"bn timing: {name} over the 18 BatchNorms of a step (batch {BATCH} bf16): kernel "
              f"{s['ms']:.3f} ms, plain {s['plain_ms']:.3f} ms, library {s['library_ms']:.3f} "
              f"ms, byte bound {s['bound_ms']:.3f} ms, {100 * s['bound_ms'] / s['ms']:.1f}% "
              f"of bound")
    total = sum(s["ms"] for s in sums.values())
    print(f"bn timing: BN1-BN4 {total:.3f} ms a step; as the model calls them, BN1 with the "
          f"epilogue + BN2 {passes['forward']:.3f} ms, BN3 with the epilogue + BN4 "
          f"{passes['backward']:.3f} ms = {passes['forward'] + passes['backward']:.3f} ms; "
          f"against PyTorch's BatchNorm + ReLU {cudnn['forward']:.3f} ms forward + "
          f"{cudnn['backward']:.3f} ms backward = {cudnn['forward'] + cudnn['backward']:.3f} ms "
          f"({card()})")
    for name in BN_NAMES:
        sums[name]["cudnn_ms"] = cudnn["forward" if name in ("BN1", "BN2") else "backward"]
    return sums


def write_dataset(root: Path, n: int, hw: tuple[int, int], seed: int) -> None:
    """A FoundationStereo-layout dataset of ``n`` samples at ``hw`` in two
    scenes: random RGB pairs, disparity PNGs made with the port's codec
    (a band of zeros: invalid pixels)."""

    def write(i: int) -> None:
        rng = np.random.default_rng((seed, i))
        base = root / f"scene_{i % 2}" / "dataset" / "data"
        for side in ("left", "right"):
            rgb = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            Image.fromarray(rgb).save(base / side / "rgb" / f"{i:06d}.png", compress_level=1)
        disparity = rng.uniform(0.5, 64.0, hw).astype(np.float32)
        disparity[:8] = 0.0
        Image.fromarray(disparity_encode_np(disparity)).save(
            base / "left" / "disparity" / f"{i:06d}.png", compress_level=1)

    for scene in range(2):
        for sub in ("left/rgb", "right/rgb", "left/disparity"):
            (root / f"scene_{scene}" / "dataset" / "data" / sub).mkdir(parents=True)
    with ThreadPoolExecutor(8) as workers:
        list(workers.map(write, range(n)))


def counted(entry_point, argv: list[str]):
    """``entry_point(argv)`` with the launch counts set to 0 just before and
    read just after; returns its result, the counts and the seconds."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    result = entry_point(argv)
    torch.cuda.synchronize()
    return result, counts(), time.perf_counter() - t0


def phase_trainer(tmp: Path) -> Path:
    """The trainer CLI on the packed cache: two epochs device-resident
    (the budget must pin the set), then ``--resume`` from ``last.pt`` for a
    third. Checks the metrics, the kernels' launches, the carried global
    step, the checkpoints, and that ``last.pt`` in a fresh model predicts
    what the trained model predicts. The dataset goes to ``tmp / "data"``.
    Returns the resumed run's ``last.pt``."""
    h, w = HW
    t0 = time.perf_counter()
    write_dataset(tmp / "data", TRAIN_SAMPLES, TRAIN_SOURCE_HW, seed=5)
    print(f"trainer: wrote {TRAIN_SAMPLES} samples at {TRAIN_SOURCE_HW[0]}x"
          f"{TRAIN_SOURCE_HW[1]} in {time.perf_counter() - t0:.1f} s")
    common = [
        "--dataset-root", str(tmp / "data"), "--packed-cache-root", str(tmp / "packed"),
        "--height", str(h), "--width", str(w), "--base-channels", "32",
        "--compute-dtype", "bfloat16", "--batch-size", str(TRAIN_BATCH),
        "--device-resident", "auto", "--preview-samples", "4", "--log-every-batches", "2",
        "--mlflow-tracking-uri", str(tmp / "mlruns"), "--output-dir", str(tmp / "outputs"),
    ]
    train_samples, val_samples = split_samples(discover_samples(tmp / "data"), 0.1, 42)
    steps_per_epoch = len(train_samples) // TRAIN_BATCH  # pinned: whole batches
    val_batches = -(-len(val_samples) // TRAIN_BATCH)

    first, first_counts, first_s = counted(trainer.main, common + ["--epochs", "2"])
    last = Path(first["checkpoints_dir"]) / "last.pt"
    resumed, resumed_counts, resumed_s = counted(
        trainer.main, common + ["--epochs", "3", "--resume", str(last)])

    for summary, run_counts, epochs in ((first, first_counts, 2), (resumed, resumed_counts, 1)):
        check(summary["device_resident"] == "pinned",
              f"trainer staged the set as {summary['device_resident']}, not pinned")
        steps = epochs * steps_per_epoch
        # Per epoch: the gray means, K1, 4 K3 and BN1-BN4 for each of 18
        # BatchNorms per train step; 4 K2 per train step, per validation
        # batch and per preview predict.
        expected = expect_launches(GM=steps, K1=steps,
                                   K2=4 * (steps + epochs * (val_batches + 1)),
                                   K3=4 * steps, **bn_launches(18 * steps),
                                   **gate_launches(steps))
        got = {k: run_counts[k] for k in expected}
        check(got == expected, f"trainer launches {got}, expected {expected}")
        for epoch in summary["epochs"]:
            values = [epoch[k] for k in epoch if k.startswith(("train_", "val_"))]
            check(len(values) == 10 and all(math.isfinite(v) for v in values),
                  f"trainer epoch {epoch['epoch']} metrics {epoch}")
            print(f"trainer: epoch {epoch['epoch']}: {epoch['epoch_seconds']:.2f} s, "
                  f"{steps_per_epoch / epoch['epoch_seconds']:.2f} steps/s "
                  f"({steps_per_epoch} steps of {TRAIN_BATCH}, eval and previews "
                  f"included), train_mae {epoch['train_mae']:.4f}, val_mae "
                  f"{epoch['val_mae']:.4f}, val_nll {epoch['val_nll']:.4f}, global step "
                  f"{epoch['global_step']}")
    check(first["global_step"] == 2 * steps_per_epoch, f"global step {first['global_step']}")
    check(resumed["global_step"] == 3 * steps_per_epoch
          and [e["epoch"] for e in resumed["epochs"]] == [3],
          f"resume: global step {resumed['global_step']}, epochs {resumed['epochs']}")
    # best.pt is banked on a new best val MAE, which the resumed epoch
    # need not reach (the best so far is carried across the resume).
    for summary, names in ((first, ("best.pt", "last.pt")), (resumed, ("last.pt",))):
        for name in names:
            check((Path(summary["checkpoints_dir"]) / name).is_file(), f"no {name}")
    check(resumed["best_epoch"] in (first["best_epoch"], 3),
          f"best epoch {resumed['best_epoch']} after the resume")

    trained = resumed["state"].model
    device = next(trained.parameters()).device
    fresh = StereoUNet(base_channels=32, compute_dtype=torch.bfloat16, device=device)
    loaded = checkpoint.load_model_variables(
        Path(resumed["checkpoints_dir"]) / "last.pt", fresh)
    check(loaded["epoch"] == 3 and not loaded["missing_keys"]
          and not loaded["unexpected_keys"], f"last.pt load: {loaded}")
    val = PackedCache(tmp / "packed" / "val").load_all()["input"]
    inputs = torch.from_numpy(np.array(val)).to(device)  # the validation set
    want = make_predict_fn(trained)(inputs)
    got = make_predict_fn(fresh)(inputs)
    for a, b in zip(got, want):
        check(torch.equal(a, b), "last.pt in a fresh model predicts otherwise than the "
              f"trained model: max diff {float((a - b).abs().max())}")
    print(f"trainer: 2 epochs in {first_s:.1f} s and a resumed third in {resumed_s:.1f} s "
          f"(packed cache built in the first), device-resident pinned; launches "
          f"{first_counts} then {resumed_counts}; global step {first['global_step']} -> "
          f"{resumed['global_step']} across the resume; last.pt in a fresh model predicts "
          "the trained model's disparity and log-variance exactly ok")
    return Path(resumed["checkpoints_dir"]) / "last.pt"


def head_outputs(path: Path, inputs: torch.Tensor) -> dict[str, torch.Tensor]:
    """The float32 eval-mode StereoUNet of the checkpoint at ``path``, on the
    card: disparity, log-variance and both heads' pre-activations."""
    model = StereoUNet(base_channels=32, compute_dtype=torch.float32, device="cuda")
    loaded = checkpoint.load_model_variables(path, model)
    check(not loaded["missing_keys"] and not loaded["unexpected_keys"], f"{path}: {loaded}")
    out = {}
    hooks = [getattr(model, head).register_forward_hook(
        lambda module, args, y, head=head: out.__setitem__(head, y.float()))
        for head in ("disparity_head", "logvar_head")]
    try:
        out["disparity"], out["logvar"] = make_predict_fn(model)(inputs)
    finally:
        for hook in hooks:
            hook.remove()
    return out


def harness_run(work: Path, docs: Path, tag: str, epochs: int,
                *extra: str) -> tuple[dict, dict, dict[str, int]]:
    """The convergence harness's card mode on the phase's scenes, counted:
    its artifact (finite metrics, the card, the previews), the set pinned,
    and the kernels' launches (the trainer phase's pattern). Returns the
    artifact, the trainer's summary and the counts."""
    result, run_counts, seconds = counted(convergence_run.main, [
        "card", "--epochs", str(epochs), "--samples", str(CONV_SAMPLES),
        "--workdir", str(work), "--docs-dir", str(docs), "--tag", tag, *extra])
    summary = result.pop("summary")
    artifact = json.loads((docs / f"card_metrics{tag}.json").read_text())
    check(artifact == json.loads(json.dumps(result)), f"card_metrics{tag}.json is not the run's")
    series = artifact["series"]
    check(series["epoch"] == list(range(1, epochs + 1))
          and all(math.isfinite(v) for key in convergence_run.METRIC_KEYS
                  for v in series[key]), f"convergence{tag} series {series}")
    check(artifact["device"]["name"] == torch.cuda.get_device_name(0)
          and artifact["best_val_mae"] == min(series["val_mae"]),
          f"convergence{tag} artifact {artifact['device']}, best {artifact['best_val_mae']}")
    for name in ("first", "last"):
        check((docs / f"card_preview{tag}_{name}_epoch.png").is_file(),
              f"no {name} preview{tag}")
    check(summary["device_resident"] == "pinned",
          f"convergence{tag} staged the set as {summary['device_resident']}, not pinned")
    train_samples, val_samples = split_samples(discover_samples(work / "data"), 0.1, 42)
    batch = artifact["config"]["batch_size"]
    steps_per_epoch = len(train_samples) // batch  # pinned: whole batches
    steps = epochs * steps_per_epoch
    val_batches = -(-len(val_samples) // batch)
    # As the trainer phase: per train step the gray means, K1, 4 K3 and
    # BN1-BN4 18 times; 4 K2 per train step, per validation batch and per
    # preview predict.
    expected = expect_launches(GM=steps, K1=steps,
                               K2=4 * (steps + epochs * (val_batches + 1)),
                               K3=4 * steps, **bn_launches(18 * steps),
                               **gate_launches(steps))
    check(run_counts == expected, f"convergence{tag} launches {run_counts}, "
          f"expected {expected}")
    epoch_s = [e["epoch_seconds"] for e in summary["epochs"]]
    h, w = artifact["config"]["resolution"]
    init = artifact["config"]["init_checkpoint"]
    print(f"convergence{tag}: card mode at {h}x{w}, {epochs} epochs of {steps_per_epoch} "
          f"steps (batch {batch}, base 32, bf16, augmented, pinned; {len(train_samples)} "
          f"train, {len(val_samples)} val{f', from {Path(init).name}' if init else ''}) in "
          f"{seconds:.1f} s (wall {artifact['wall_seconds']} s in train()); epochs "
          f"{', '.join(f'{t:.2f}' for t in epoch_s)} s, "
          f"{', '.join(f'{steps_per_epoch / t:.2f}' for t in epoch_s)} steps/s, "
          f"{artifact['pairs_per_second']} pairs/s; val_mae "
          f"{', '.join(f'{v:.4f}' for v in series['val_mae'])}; launches {run_counts} ok "
          f"({artifact['device']['name']}, {artifact['device']['power_limit']})")
    return artifact, summary, run_counts


def phase_convergence(tmp: Path) -> dict[str, dict[str, int]]:
    """The convergence harness's card mode at full width for CONV_EPOCHS
    epochs on the port's generator's scenes, then ``rescale_transfer`` on its
    ``best.pt`` against the original model (the RESCALE_TOL checks), then the
    progressive-resolution transfer (``phase_transfer``). Returns the launch
    counts of each harness run."""
    work, docs = tmp / "convergence", tmp / "convergence_docs"
    _, summary, run_counts = harness_run(work, docs, "", CONV_EPOCHS)
    meta = json.loads((work / "data" / "synth_meta.json").read_text())
    print(f"convergence: generated {meta['samples']} samples ({meta['scenes']} scenes, seed "
          f"{meta['seed']}) at {meta['height']}x{meta['width']} in "
          f"{meta['elapsed_seconds']} s")

    best = Path(summary["checkpoints_dir"]) / "best.pt"
    source_width, target_width = CONV_RATIO
    ratio = target_width / source_width
    rescaled = rescale_transfer.main([
        "--checkpoint", str(best), "--from-width", str(source_width),
        "--to-width", str(target_width), "--out", str(tmp / "rescaled"),
        "--base-channels", "32"])
    saved = checkpoint.load_checkpoint_meta(rescaled)
    check(saved["epoch"] == summary["best_epoch"]
          and saved["config"]["rescale_width_ratio"] == ratio,
          f"rescaled.pt meta {saved}")
    val = torch.from_numpy(np.array(
        PackedCache(work / "packed" / "val").load_all()["input"])).cuda()
    was_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want, got = head_outputs(best, val), head_outputs(rescaled, val)
    finally:
        torch.backends.cudnn.allow_tf32 = was_tf32
    z, z_new = want["disparity_head"], got["disparity_head"]
    pre_gap = float((z_new - ratio * z).abs().max() / (ratio * z).abs().max())
    check(pre_gap <= RESCALE_TOL, f"rescaled disparity pre-activation gap {pre_gap:.3g} "
          f"of its scale (tol {RESCALE_TOL})")
    linear = z[:, 0] > SOFTPLUS_LINEAR
    d, d_new = want["disparity"][linear], got["disparity"][linear]
    disp_gap = float(((d_new - ratio * d).abs() / (ratio * d)).max()) if d.numel() else 0.0
    check(disp_gap <= RESCALE_TOL, f"rescaled disparity {disp_gap:.3g} from {ratio}x the "
          f"original's where softplus is linear (tol {RESCALE_TOL})")
    shift = math.log(ratio)
    free = (want["logvar"] > -6.0) & (want["logvar"] + shift < 3.0)
    free &= (got["logvar"] > -6.0) & (got["logvar"] < 3.0)
    check(bool(free.any()), "the log-variance is clamped at every pixel")
    lv_gap = float((got["logvar"][free] - (want["logvar"][free] + shift)).abs().max())
    check(lv_gap <= RESCALE_TOL, f"rescaled log-variance {lv_gap:.3g} from the original's "
          f"+ log({ratio}) where unclamped (tol {RESCALE_TOL})")
    pixels = linear.numel()
    print(f"convergence: rescale_transfer {source_width} -> {target_width} on best.pt (epoch "
          f"{summary['best_epoch']}), float32 eval on the card, {val.shape[0]} val pairs: "
          f"disparity pre-activation (in [{float(z.min()):.4f}, {float(z.max()):.4f}]) within "
          f"{pre_gap:.3g} of its scale of {ratio}x; "
          f"disparity within {disp_gap:.3g} relative of {ratio}x over {int(linear.sum())} of "
          f"{pixels} pixels where softplus is linear; log-variance within {lv_gap:.3g} of "
          f"+{shift:.6f} over {int(free.sum())} unclamped pixels (tol {RESCALE_TOL}) ok")
    return {"card": run_counts, **phase_transfer(tmp, work, docs)}


def transfer_kernel_checks() -> None:
    """K1, the gray means, K2 and K3 against their plain versions at the
    fast and mid runs' shapes (TRANSFER_SHAPES)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    for n, h, w in TRANSFER_SHAPES:
        for bp in (AugmentConfig().blur_prob, 1.0):
            images, packed, blur_k = kernel_case(gen, n, h, w, bp)
            err, _ = compare_kernel(images, packed, blur_k, torch.bfloat16)
            brightness = torch.rand(2 * n, device="cuda", generator=gen) * 0.5 + 0.75
            first, second = gray_means_cuda(images, brightness), gray_means_cuda(images, brightness)
            ref = gray_means_plain(images, brightness)
            torch.cuda.synchronize()
            gm_err = float((first - ref).abs().max())
            check(gm_err <= F32_TOL, f"gray means vs plain err {gm_err} at {n}x{h}x{w}")
            check(torch.equal(first.view(torch.int32), second.view(torch.int32)),
                  f"gray means differ between two runs at {n}x{h}x{w}")
            blurred = int((packed[:, [6, 14]] > 0).sum())
            print(f"transfer check: K1 {n}x{h}x{w} blur_prob={bp} blur_k={blur_k} "
                  f"blurred_views={blurred} out=bfloat16 max_abs_err={err:.3g} tol=1 bf16 ulp "
                  f"+ {F32_TOL:g}; gray means max_abs_err={gm_err:.3g} tol={F32_TOL:g}, two "
                  "runs bitwise equal ok")
            del images, packed, first, second, ref
        for k in range(4):
            shape = (n, h >> k, w >> k, 32 << k)
            x = tie_rich(gen, shape, torch.bfloat16)
            y, idx = pool.maxpool2x2_fwd_cuda(x)
            ref_y, ref_idx = pool.maxpool2x2_fwd_plain(x)
            dy = torch.randn(y.shape, device="cuda", generator=gen).to(torch.bfloat16)
            dx = pool.maxpool2x2_bwd_cuda(dy, idx)
            ref_dx = pool.maxpool2x2_bwd_plain(dy, ref_idx)
            torch.cuda.synchronize()
            check(equal_nan(y, ref_y) and torch.equal(idx, ref_idx),
                  f"K2 differs from its plain version at {shape} bf16")
            check(equal_nan(dx, ref_dx), f"K3 differs from its plain version at {shape} bf16")
            print(f"transfer check: {'x'.join(map(str, shape))} bf16 -> "
                  f"{y.shape[1]}x{y.shape[2]}: K2 y, idx and K3 dx equal to the plain versions "
                  "(tol 0) ok")
            del x, y, idx, dy, dx, ref_y, ref_idx, ref_dx


def phase_transfer(tmp: Path, work: Path, docs: Path) -> dict[str, dict[str, int]]:
    """The progressive-resolution transfer through the harness (see
    TRANSFER_HW): the fast pretrain, ``rescale_transfer`` on its ``best.pt``,
    the rescaled and the naive finetune at 240x320, each with its artifact
    and launches checked, and the weights each finetune starts from (caught
    at the trainer's own ``load_model_variables``) held bitwise against
    ``rescale_resolution_transfer`` of ``best.pt`` (naive: ``best.pt``).
    Returns the launch counts of each run."""
    transfer_kernel_checks()
    source_width, target_width = TRANSFER_HW[1], HW[1]
    runs = {}
    fast, fast_summary, runs["fast"] = harness_run(
        work, docs, "_fast", CONV_EPOCHS, "--height", str(TRANSFER_HW[0]),
        "--width", str(TRANSFER_HW[1]), "--batch-size", str(TRANSFER_BATCH))
    check(fast["config"]["resolution"] == list(TRANSFER_HW)
          and fast["config"]["batch_size"] == TRANSFER_BATCH, f"fast config {fast['config']}")
    best = Path(fast_summary["checkpoints_dir"]) / "best.pt"
    rescaled = rescale_transfer.main([
        "--checkpoint", str(best), "--from-width", str(source_width),
        "--to-width", str(target_width), "--out", str(tmp / "rescaled_fast"),
        "--base-channels", "32"])
    original = StereoUNet(base_channels=32, device="cpu")
    checkpoint.load_model_variables(best, original)
    wants = {"prog_rescaled": rescale_resolution_transfer(
        original.state_dict(), target_width / source_width), "prog_naive": original.state_dict()}

    load = trainer.load_model_variables
    for tag, init in (("prog_rescaled", rescaled), ("prog_naive", best)):
        started = {}

        def load_and_keep(path, model):
            loaded = load(path, model)
            started.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
            return loaded

        trainer.load_model_variables = load_and_keep
        try:
            artifact, _, runs[tag] = harness_run(
                work, docs, f"_{tag}", FINETUNE_EPOCHS, "--init-checkpoint", str(init))
        finally:
            trainer.load_model_variables = load
        check(artifact["config"]["init_checkpoint"] == str(init)
              and artifact["config"]["resolution"] == [240, 320],
              f"{tag} artifact config {artifact['config']}")
        want = wants[tag]
        check(started.keys() == want.keys()
              and all(torch.equal(started[k], want[k]) for k in want),
              f"{tag}: the weights the trainer started from are not "
              f"{'the rescale of ' if tag == 'prog_rescaled' else ''}best.pt's")
        print(f"convergence_{tag}: the trainer started from {init.name} (epoch "
              f"{fast_summary['best_epoch']} of the {TRANSFER_HW[0]}x{TRANSFER_HW[1]} run), "
              f"all {len(want)} tensors bitwise "
              + ("rescale_resolution_transfer(best.pt, "
                 f"{target_width / source_width:g}) in this process" if tag == "prog_rescaled"
                 else "best.pt's") + " ok")
    return runs


def rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    """The rotation matrix of the axis-angle vector (rx, ry, rz) (Rodrigues)."""
    v = np.array([rx, ry, rz], dtype=np.float64)
    theta = float(np.linalg.norm(v))
    k = v / theta
    cross = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * cross + (1.0 - np.cos(theta)) * cross @ cross


def synthetic_calibration(w: int, h: int, baseline_m: float = 0.07) -> dict[str, np.ndarray]:
    """A calibration bundle of a plausible rig, made with numpy: intrinsics
    that differ a little between the cameras, mild distortion, rectifying
    rotations of a few mrad, and rectified projections with the baseline in
    P2 (the keys the calibrate CLI writes and the live viewer reads)."""
    f = 0.8 * w
    p1 = np.array([[f, 0.0, w / 2, 0.0], [0.0, f, h / 2, 0.0], [0.0, 0.0, 1.0, 0.0]])
    p2 = p1.copy()
    p2[0, 3] = -f * baseline_m
    return {
        "image_size": np.array([w, h]),
        "mtx_l": np.array([[f, 0.0, w / 2 - 2], [0.0, f, h / 2 + 1], [0.0, 0.0, 1.0]]),
        "dist_l": np.array([-0.08, 0.02, 1e-3, -5e-4, 0.0]),
        "mtx_r": np.array([[1.01 * f, 0.0, w / 2 + 1], [0.0, 1.01 * f, h / 2 - 1],
                           [0.0, 0.0, 1.0]]),
        "dist_r": np.array([-0.07, 0.02, -8e-4, 6e-4, 0.0]),
        "R1": rotation(0.001, 0.005, 0.001), "R2": rotation(0.001, -0.005, 0.001),
        "P1": p1, "P2": p2, "T": np.array([[-baseline_m], [0.0], [0.0]]),
    }


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's TF32 convolutions on, PyTorch's default, as a user of the
    serving CLIs runs them; the flag is restored afterwards."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def rep_ms(fn, reps: int) -> list[float]:
    """Device milliseconds of each of ``reps`` back-to-back calls of ``fn``
    after one warm-up call (a CUDA event after each call)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def spread(times: list[float]) -> str:
    """Median (min-max) of ``times`` in ms."""
    return f"{statistics.median(times):.2f} ms ({min(times):.2f}-{max(times):.2f})"


def max_err(got, want) -> tuple[float, float]:
    """The largest absolute difference of two (disparity, logvar) pairs, and
    that difference over the largest magnitude of ``want`` (floored at 1)."""
    errs = [float((g.float().cpu() - w.float().cpu()).abs().max()) for g, w in zip(got, want)]
    scales = [max(1.0, float(w.abs().max())) for w in want]
    return max(errs), max(e / sc for e, sc in zip(errs, scales))


def serving_counts(k2: int) -> dict[str, int]:
    """The launch counts of a serving run: ``k2`` forward pools, nothing else."""
    return expect_launches(K2=k2)


def check_evaluate(data: Path, ckpt: Path, *argv: str) -> tuple[dict, float, int]:
    """The evaluate CLI as a user runs it (``--device auto``, batch 30);
    checks its launches and metrics. Returns its JSON line, seconds and K2
    launches."""
    result, got, seconds = counted(evaluate.main, [
        "--dataset-root", str(data), "--checkpoint", str(ckpt), *argv,
        "--batch-size", str(SERVE_BATCH), "--height", str(HW[0]), "--width", str(HW[1])])
    split = " ".join(argv)
    batches = -(-result["samples"] // SERVE_BATCH)
    check(got == serving_counts(4 * batches),
          f"evaluate {split}: launches {got} in {batches} batches, expected K2 "
          f"{4 * batches}")
    check(result["valid_pixels"] > 0 and all(
        math.isfinite(result[k]) for k in ("loss", "nll", "mae", "rmse", "sigma")),
        f"evaluate {split}: {result}")
    return result, seconds, got["K2"]


def check_predict(data: Path, ckpt: Path, out: Path, calib: Path,
                  *argv: str) -> tuple[dict, float, int]:
    """The predict CLI on the dataset's first ``PREDICT_PAIRS`` pairs with
    ``--save-png``, a calibration and ``argv``; checks its launches and every
    npz. Returns its JSON line, seconds and K2 launches."""
    result, got, seconds = counted(predict.main, [
        "--dataset-root", str(data), "--split", "all", "--max-samples", str(PREDICT_PAIRS),
        "--checkpoint", str(ckpt), "--predictions-dir", str(out), "--save-png",
        "--calibration", str(calib), "--batch-size", str(SERVE_BATCH),
        "--height", str(HW[0]), "--width", str(HW[1]), *argv])
    batches = -(-PREDICT_PAIRS // SERVE_BATCH)
    check(got == serving_counts(4 * batches),
          f"predict: launches {got} in {batches} batches, expected K2 {4 * batches}")
    files = sorted(out.glob("*.npz"))
    check(result["pairs"] == len(files) == len(list(out.glob("*_disparity.png")))
          == PREDICT_PAIRS and result["depth"], f"predict wrote {result}")
    for path in files:
        with np.load(path) as npz:
            check(sorted(npz.files) == ["confidence", "depth_m", "disparity", "logvar"],
                  f"{path.name} holds {npz.files}")
            arrays = {k: npz[k] for k in npz.files}
        check(all(a.shape == HW and a.dtype == np.float16 for a in arrays.values()),
              f"{path.name}: shapes or dtypes")
        check(all(np.isfinite(arrays[k]).all() for k in ("disparity", "logvar", "confidence")),
              f"{path.name}: non-finite values")
        # Depth overflows float16 (or is NaN) only where disparity is ~0.
        check(bool((np.isfinite(arrays["depth_m"]) | (arrays["disparity"] < 1e-3)).all()),
              f"{path.name}: non-finite depth where disparity is not ~0")
    return result, seconds, got["K2"]


def phase_serving(tmp: Path, ckpt: Path) -> int:
    """The serving path at full width on the trainer phase's dataset and
    ``last.pt`` (StereoUNet base 32 in float32, as the JAX serving CLIs build
    it): the evaluate CLI (the whole set, and the val split held against
    ``make_eval_step`` on the CPU), the predict CLI, and the live engine
    (640x480 captures rectified and resized to 240x320, batch 1) held
    against the same engine on the CPU, then hot-reloaded. Returns the K2
    launches of the runs it drove."""
    data = tmp / "data"
    k2 = 0
    whole, whole_s, n = check_evaluate(data, ckpt, "--split", "all",
                                       "--max-samples", str(EVAL_SAMPLES))
    k2 += n
    val, val_s, n = check_evaluate(data, ckpt, "--split", "val")
    k2 += n

    # make_eval_step on the CPU, same weights, same val samples.
    t0 = time.perf_counter()
    _, val_samples = split_samples(discover_samples(data), 0.1, 42)
    cpu_model = StereoUNet(base_channels=32, device="cpu")
    checkpoint.load_model_variables(ckpt, cpu_model)
    state, eval_step = TrainState(cpu_model, None, None), make_eval_step()
    loader = StereoSampleLoader(val_samples, image_size=HW)
    total = None
    for batch in batch_iterator(loader_fetch(loader, 4), len(loader), SERVE_BATCH):
        total = accumulate_stats(
            total, eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}))
    ref = metrics_from_stats(total)
    cpu_s = time.perf_counter() - t0
    worst = max(abs(val[k] - ref[k]) / abs(ref[k]) for k in ("mae", "rmse", "nll", "sigma"))
    check(int(total.valid_count) == val["valid_pixels"] and worst <= SERVE_RTOL,
          f"evaluate on the card {val} vs make_eval_step on the CPU {ref}: {worst:.3g}")
    # The host's share: the evaluate CLI's sample loader alone.
    loader_ms = {}
    for workers in (0, 4):
        fetch = loader_fetch(loader, workers)
        t0 = time.perf_counter()
        fetch(np.arange(len(loader)))
        loader_ms[workers] = (time.perf_counter() - t0) * 1e3 / len(loader)
    print(f"evaluate: base 32 f32, batch {SERVE_BATCH}, {HW[0]}x{HW[1]}, TF32 off: per-run "
          f"CLI latency {whole_s:.2f} s for {whole['samples']} samples (--split all "
          f"--max-samples {EVAL_SAMPLES}; model build, checkpoint load, decode, resize and "
          f"cuDNN's first algorithm choices included: {whole['samples'] / whole_s:.1f} "
          f"samples/s of one run, not a steady rate), mae {whole['mae']:.4f}; --split val "
          f"{val['samples']} samples in {val_s:.2f} s, metrics within {worst:.2g} (rel) of "
          f"make_eval_step on the CPU (tol {SERVE_RTOL:g}; {cpu_s:.2f} s on the CPU), valid "
          f"pixels {val['valid_pixels']} equal; K2 launches 4 a batch ok; its sample loader "
          f"alone (decode and resize on the host) {loader_ms[4]:.1f} ms a sample with the "
          f"CLI's 4 workers, {loader_ms[0]:.1f} ms with none")

    calib_arrays = synthetic_calibration(CAPTURE_HW[1], CAPTURE_HW[0])
    calib = tmp / "stereo_calib.npz"
    np.savez(calib, **calib_arrays)
    result, predict_s, n = check_predict(data, ckpt, tmp / "predictions", calib)
    k2 += n
    model = StereoUNet(base_channels=32, device="cuda")
    checkpoint.load_model_variables(ckpt, model)
    predict_fn = make_predict_fn(model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    batch = torch.randint(0, 256, (SERVE_BATCH, *HW, 6), dtype=torch.uint8, device="cuda",
                          generator=gen)
    target = torch.rand((SERVE_BATCH, *HW), device="cuda", generator=gen) * 63.5 + 0.5
    eval_state = TrainState(model, None, None)
    steady = {"predict_fn": lambda: predict_fn(batch),
              "eval step": lambda: eval_step(eval_state, {"input": batch, "target": target})}
    # Steady windows, TF32 off and then as users run them; the outputs of
    # both against the CPU model on the batch's first pairs.
    off_ms = {name: rep_ms(fn, SERVE_REPS) for name, fn in steady.items()}
    off_out = predict_fn(batch)
    with cudnn_tf32():
        on_ms = {name: rep_ms(fn, SERVE_REPS) for name, fn in steady.items()}
        on_out = predict_fn(batch)
    cpu_ref = make_predict_fn(cpu_model)(batch[:CPU_PAIRS].cpu())
    off_err, _ = max_err([t[:CPU_PAIRS] for t in off_out], cpu_ref)
    on_err, on_rel = max_err([t[:CPU_PAIRS] for t in on_out], cpu_ref)
    check(off_err <= SERVE_ATOL, f"predict_fn card (TF32 off) vs CPU: {off_err:.3g} > "
          f"{SERVE_ATOL:g}")
    check(on_rel <= TF32_TOL, f"predict_fn card (cuDNN TF32) vs CPU: {on_err:.3g}, "
          f"{on_rel:.3g} of the output's scale > {TF32_TOL:g}")
    for name in steady:
        print(f"{name}: steady device window at batch {SERVE_BATCH} f32, {SERVE_REPS} calls "
              f"after a warm-up: TF32 off {spread(off_ms[name])} = "
              f"{SERVE_BATCH * 1e3 / statistics.median(off_ms[name]):.1f} samples/s; with "
              f"cudnn.allow_tf32=True (PyTorch's default) {spread(on_ms[name])} = "
              f"{SERVE_BATCH * 1e3 / statistics.median(on_ms[name]):.1f} samples/s")
    print(f"predict_fn: card vs CPU on {CPU_PAIRS} pairs of the batch: TF32 off within "
          f"{off_err:.3g} (tol {SERVE_ATOL:g}); cuDNN TF32 within {on_err:.3g} = "
          f"{on_rel:.3g} of the output's scale (tol {TF32_TOL:g}) ok")
    # The host's share per pair: decode and resize, and the PNG preview.
    pairs = predict._pairs(predict.build_parser().parse_args([
        "--dataset-root", str(data), "--split", "all", "--max-samples", "10",
        "--predictions-dir", str(tmp)]))
    t0 = time.perf_counter()
    for _, left, right in pairs:
        predict._load_pair_u8(left, right, HW)
    load_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
    disp = predict_fn(batch[:1])[0][0].cpu().numpy()
    t0 = time.perf_counter()
    for _ in pairs:
        Image.fromarray(normalize_map(disp)).save(tmp / "preview.png")
    png_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
    print(f"predict: per-run CLI latency {predict_s:.2f} s for {result['pairs']} pairs "
          f"(batches of {SERVE_BATCH} and a tail of {PREDICT_PAIRS % SERVE_BATCH}; model build, "
          f"checkpoint load, PNG decode, resize, npz and PNG writes included: "
          f"{result['pairs'] / predict_s:.1f} pairs/s of one run, the CLI's own "
          f"{result['pairs_per_sec']} pairs/s without the build and load), TF32 off; on the host "
          f"{load_ms:.1f} ms a pair to decode and resize, {png_ms:.1f} ms for its PNG "
          "preview; npz files with disparity/logvar/confidence/depth_m finite ok")
    del model, predict_fn, batch, target, eval_state, off_out, on_out

    k2 += check_live(tmp, ckpt, calib_arrays)
    return k2


def stage_split(engine: LiveDepthEngine, frames) -> dict[str, float]:
    """Median milliseconds of each stage of ``engine.process`` over
    ``frames``: CUDA events between the stages, so the host's enqueue time
    falls inside the span it delays."""
    stages = ("H2D", "remap + resize", "forward", "D2H")
    spans: dict[str, list[float]] = {name: [] for name in stages}
    for left, right in frames:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        events[0].record()
        up = engine.upload(left, right)
        events[1].record()
        views = engine.preprocess(*up)
        events[2].record()
        out = engine.forward(*views)
        events[3].record()
        engine.download(*out)
        events[4].record()
        torch.cuda.synchronize()
        for k, name in enumerate(stages):
            spans[name].append(events[k].elapsed_time(events[k + 1]))
    return {name: statistics.median(v) for name, v in spans.items()}


def check_live(tmp: Path, ckpt: Path, calib: dict[str, np.ndarray]) -> int:
    """The live engine at the viewer's defaults on random BGR frames:
    timing, launches, split by stage, device-busy share, peak memory, card
    vs CPU, a TF32 run and a hot reload. Returns its K2 launches."""
    live_pt = tmp / "live.pt"
    shutil.copyfile(ckpt, live_pt)
    model_wh = (HW[1], HW[0])
    engine = LiveDepthEngine(model_wh, Rectifier.from_calibration(calib, "cuda"), "cuda", 32)
    epoch, uncertainty = engine.load_checkpoint(live_pt)
    check(uncertainty, "last.pt has no logvar head")
    rng = np.random.default_rng(12)
    frames = [tuple(rng.integers(0, 256, (*CAPTURE_HW, 3), dtype=np.uint8) for _ in range(2))
              for _ in range(LIVE_WARMUP + LIVE_FRAMES)]
    timed = frames[LIVE_WARMUP:]

    def run_frames() -> tuple[list[float], list]:
        times, outs = [], []
        for left, right in timed:
            t0 = time.perf_counter()
            outs.append(engine.process(left, right))
            times.append(time.perf_counter() - t0)
        return times, outs

    for left, right in frames[:LIVE_WARMUP]:
        engine.process(left, right)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, outs = run_frames()
    live_counts = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(live_counts == serving_counts(4 * LIVE_FRAMES),
          f"live: launches {live_counts} in {LIVE_FRAMES} frames, expected K2 {4 * LIVE_FRAMES}")
    for disp, logvar, left_view, right_view in outs:
        check(disp.shape == logvar.shape == HW and left_view.shape == right_view.shape
              == (*HW, 3) and left_view.dtype == np.uint8, "live: output shapes")
        check(bool(np.isfinite(disp).all() and np.isfinite(logvar).all()), "live: not finite")
        check(float(disp.min()) >= 0.0, "live: negative disparity")
        check(-6.0 <= float(logvar.min()) and float(logvar.max()) <= 3.0,
              "live: logvar out of [-6, 3]")

    split = stage_split(engine, timed[:LIVE_SPLIT_FRAMES])
    flips = []
    for left, _ in timed[:LIVE_SPLIT_FRAMES]:
        t0 = time.perf_counter()
        np.ascontiguousarray(left[..., ::-1])
        flips.append(2 * (time.perf_counter() - t0) * 1e3)  # two frames a pair
    rows, window_us = profile_kernels(lambda: engine.process(*timed[0]), LIVE_SPLIT_FRAMES)
    kernel_ms = sum(r[0] for r in rows) / 1e3 / LIVE_SPLIT_FRAMES
    launches_per_frame = sum(r[1] for r in rows) / LIVE_SPLIT_FRAMES
    ms_frame = statistics.median(times) * 1e3
    print(f"live: {CAPTURE_HW[1]}x{CAPTURE_HW[0]} captures rectified and resized to "
          f"{HW[1]}x{HW[0]}, base 32 f32, batch 1, TF32 off (cuda.matmul and cudnn): median "
          f"{ms_frame:.2f} ms/frame over {LIVE_FRAMES} frames after {LIVE_WARMUP} warm-up "
          f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
          f"{1e3 / ms_frame:.1f} frames/s; K2 launches {live_counts['K2']} (4 a frame); peak "
          f"memory {peak_gib:.3f} GiB")
    print("live: split of a frame (CUDA events, median of "
          f"{LIVE_SPLIT_FRAMES} frames): " + ", ".join(
              f"{name} {ms:.3f} ms" for name, ms in split.items())
          + f" (the H2D span holds the host's BGR->RGB flip, {statistics.median(flips):.3f} ms "
          f"a pair); device kernels {kernel_ms:.3f} ms a frame ({launches_per_frame:.0f} "
          f"kernels) = device busy {100 * kernel_ms / ms_frame:.1f}% of the median frame "
          f"({100 * kernel_ms * LIVE_SPLIT_FRAMES * 1e3 / window_us:.1f}% of the "
          f"{window_us / 1e3 / LIVE_SPLIT_FRAMES:.2f} ms profiled frame, torch.profiler on); "
          "largest: " + ", ".join(
              f"{key[:40]} {dev / 1e3 / LIVE_SPLIT_FRAMES:.3f} ms" for dev, _, key in rows[:3]))

    # The same engine on the CPU, same frame and weights.
    t0 = time.perf_counter()
    cpu_engine = LiveDepthEngine(model_wh, Rectifier.from_calibration(calib, "cpu"), "cpu", 32)
    cpu_engine.load_checkpoint(live_pt)
    cpu_out = cpu_engine.process(*timed[0])
    errs = [float(np.abs(a - b).max()) for a, b in zip(outs[0][:2], cpu_out[:2])]
    view_err = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                   for a, b in zip(outs[0][2:], cpu_out[2:]))
    check(max(errs) <= SERVE_ATOL and view_err <= 1,
          f"live engine card vs CPU: disparity {errs[0]:.3g}, logvar {errs[1]:.3g} (tol "
          f"{SERVE_ATOL:g}), views {view_err} levels (tol 1)")
    print(f"live: card vs CPU on one frame: disparity within {errs[0]:.3g}, logvar within "
          f"{errs[1]:.3g} (tol {SERVE_ATOL:g}), rectified views within {view_err} level "
          f"(tol 1) ok ({time.perf_counter() - t0:.2f} s with the CPU engine's build)")

    # What a user of the CLI gets: cuDNN's TF32 convolutions, PyTorch's
    # default; its first timed frame held against the CPU's.
    with cudnn_tf32():
        for left, right in frames[:LIVE_WARMUP]:
            engine.process(left, right)
        tf32_times, tf32_outs = run_frames()
        tf32_split = stage_split(engine, timed[:LIVE_SPLIT_FRAMES])
    tf32_err, tf32_rel = max_err([torch.from_numpy(a) for a in tf32_outs[0][:2]],
                                 [torch.from_numpy(a) for a in cpu_out[:2]])
    tf32_view_err = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                        for a, b in zip(tf32_outs[0][2:], cpu_out[2:]))
    check(tf32_rel <= TF32_TOL and tf32_view_err <= 1,
          f"live engine card (cuDNN TF32) vs CPU: {tf32_err:.3g}, {tf32_rel:.3g} of the "
          f"output's scale (tol {TF32_TOL:g}), views {tf32_view_err} levels (tol 1)")
    print(f"live: with cudnn.allow_tf32=True (PyTorch's default for convolutions): median "
          f"{statistics.median(tf32_times) * 1e3:.2f} ms/frame over {LIVE_FRAMES} frames; "
          "split " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in tf32_split.items())
          + f"; card vs CPU on one frame: disparity and logvar within {tf32_err:.3g} = "
          f"{tf32_rel:.3g} of the output's scale (tol {TF32_TOL:g}; {max(errs):.3g} with TF32 "
          f"off), views within {tf32_view_err} level ok")

    # Hot reload: another checkpoint replaces live.pt atomically.
    t0 = time.perf_counter()
    watcher = CheckpointWatcher(engine, live_pt, poll_sec=0.0)
    payload = torch.load(live_pt, map_location="cpu", weights_only=False)
    payload["epoch"] = 99
    payload["model_state_dict"]["disparity_head.bias"] += 0.5
    staged = live_pt.with_name("live.pt.tmp")
    torch.save(payload, staged)
    os.replace(staged, live_pt)
    bump = time.time_ns() + 10**9
    os.utime(live_pt, ns=(bump, bump))
    watcher.maybe_reload()
    reloaded = engine.process(*timed[0])
    moved = float(np.abs(reloaded[0] - outs[0][0]).max())
    check(engine.loaded_epoch == 99 and moved > 1e-3,
          f"hot reload: epoch {engine.loaded_epoch}, disparity moved {moved}")
    print(f"live: hot reload through CheckpointWatcher: epoch {epoch} -> "
          f"{engine.loaded_epoch}, disparity moved by up to {moved:.3f} ok "
          f"({time.perf_counter() - t0:.2f} s with the checkpoint's rewrite)")
    return live_counts["K2"]


def npz_gap(got_dir: Path, want_dir: Path) -> float:
    """The largest gap between two predict runs' npz files, less a float16
    ulp of the larger value (what storing float32 outputs in float16 can
    add): at most SERVE_ATOL when they agree."""
    worst = 0.0
    for path in sorted(want_dir.glob("*.npz")):
        with np.load(path) as want, np.load(got_dir / path.name) as got:
            for key in want.files:
                a, b = got[key].astype(np.float32), want[key].astype(np.float32)
                finite = np.isfinite(b)
                check(bool((np.isfinite(a) == finite).all()), f"{path.name} {key}: finiteness")
                ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
                worst = max(worst, float((np.abs(a - b) - ulp.astype(np.float32))[finite].max()))
    return worst


def live_stage_split(engine: LiveDepthEngine, frames) -> dict[str, float]:
    """``stage_split`` of a compiled engine: the upload, the compiled program
    and the download."""
    stages = ("H2D", "program", "D2H")
    spans: dict[str, list[float]] = {name: [] for name in stages}
    for left, right in frames:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
        up = engine.upload(left, right)
        events[1].record()
        out = engine.run_compiled(*up)
        events[2].record()
        engine.download(*out)
        events[3].record()
        torch.cuda.synchronize()
        for k, name in enumerate(stages):
            spans[name].append(events[k].elapsed_time(events[k + 1]))
    return {name: statistics.median(v) for name, v in spans.items()}


def live_engine_runs(engines: dict[str, LiveDepthEngine], frames, warmup: int) -> dict:
    """Each engine's first call (its compile) and warm-up on ``frames``, its
    peak memory over LIVE_SPLIT_FRAMES frames alone; then the timed frames
    in turns, one frame through every engine before the next, the order
    rotating frame by frame, so the host's drift falls on all alike: each
    engine's host seconds, outputs and the kernels' launch counters over
    its frames; then each one's split by stage and the profiler's device
    time, busy share and K2 launches a frame."""
    runs = {}
    for name, engine in engines.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.process(*frames[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for left, right in frames[1:warmup]:
            engine.process(left, right)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for left, right in frames[warmup:warmup + LIVE_SPLIT_FRAMES]:
            engine.process(left, right)
        torch.cuda.synchronize()
        runs[name] = {"first_s": first_s, "times": [], "outs": [],
                      "counts": dict.fromkeys(counts(), 0),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    names = list(engines)
    for i, (left, right) in enumerate(frames[warmup:]):
        for name in names[i % len(names):] + names[:i % len(names)]:
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            runs[name]["outs"].append(engines[name].process(left, right))
            runs[name]["times"].append(time.perf_counter() - t0)
            for k, v in counts().items():
                runs[name]["counts"][k] += v - before[k]
    timed = frames[warmup:]
    for name, engine in engines.items():
        run = runs[name]
        run["split"] = (stage_split if engine.compile is None else live_stage_split)(
            engine, timed[:LIVE_SPLIT_FRAMES])
        rows, _ = profile_kernels(lambda: engine.process(*timed[0]), LIVE_SPLIT_FRAMES)
        run["kernel_ms"] = sum(r[0] for r in rows) / 1e3 / LIVE_SPLIT_FRAMES
        run["ms"] = statistics.median(run["times"]) * 1e3
        run["busy"] = 100 * run["kernel_ms"] / run["ms"]
        run["k2_profiled"] = sum(r[1] for r in rows if "maxpool2x2_fwd" in r[2])
        run["kernels"] = sum(r[1] for r in rows) / LIVE_SPLIT_FRAMES
    return runs


def live_frame_gap(got, want) -> tuple[float, int]:
    """The largest disparity/log-variance gap and view gap (levels) of two
    engines' outputs for one frame."""
    err = max(float(np.abs(a - b).max()) for a, b in zip(got[:2], want[:2]))
    view = max(int(np.abs(a.astype(int) - b.astype(int)).max())
               for a, b in zip(got[2:], want[2:]))
    return err, view


def reload_with_bias(path: Path, source: Path, epoch: int) -> None:
    """Replace ``path`` atomically with ``source`` whose disparity head bias
    is moved by 0.5, marked ``epoch``, its mtime a second ahead."""
    payload = torch.load(source, map_location="cpu", weights_only=False)
    payload["epoch"] = epoch
    payload["model_state_dict"]["disparity_head.bias"] += 0.5
    staged = path.with_name(path.name + ".tmp")
    torch.save(payload, staged)
    os.replace(staged, path)
    bump = time.time_ns() + 10**9
    os.utime(path, ns=(bump, bump))


def check_live_compiled(tmp: Path, ckpt: Path, calib: dict[str, np.ndarray],
                        aot: Path) -> dict:
    """The live engine compiled in each of LIVE_MODES (the ``default`` one
    with the compile cache at ``aot``) beside the eager engine on the same
    frames, in turns (``live_engine_runs``): ms/frame, split, busy share,
    peak memory, output against the eager engine, launches (the counters
    and the profiler); then a hot reload of every engine that recompiles
    nothing and gives the eager engine's output on the new weights. Returns
    the runs by engine and the K2 launches."""
    model_wh = (HW[1], HW[0])
    rng = np.random.default_rng(13)
    frames = [tuple(rng.integers(0, 256, (*CAPTURE_HW, 3), dtype=np.uint8) for _ in range(2))
              for _ in range(LIVE_WARMUP + LIVE_FRAMES)]
    engines, paths = {}, {}
    for name in ("eager", *LIVE_MODES):
        paths[name] = tmp / f"live_{name}.pt"
        shutil.copyfile(ckpt, paths[name])
        options = None if name == "eager" else CompileOptions(mode=name)
        engines[name] = LiveDepthEngine(
            model_wh, Rectifier.from_calibration(calib, "cuda"), "cuda", 32, compile=options,
            compile_cache=aot if name == "default" else None)
        engines[name].load_checkpoint(paths[name])
    torch._dynamo.reset()
    g0 = graph_count()
    runs = live_engine_runs(engines, frames, LIVE_WARMUP)
    graphs = graph_count() - g0
    check(graphs == len(LIVE_MODES), f"live: {graphs} graphs over the compiled engines' "
          f"frames, expected one each ({len(LIVE_MODES)})")
    # Hot reload: the weights are copied into the tensors each program (and
    # its CUDA graph) reads.
    for name, engine in engines.items():
        watcher = CheckpointWatcher(engine, paths[name], poll_sec=0.0)
        reload_with_bias(paths[name], ckpt, 99)
        watcher.maybe_reload()
        check(engine.loaded_epoch == 99, f"live {name}: reloaded epoch {engine.loaded_epoch}")
    reloaded = {name: engine.process(*frames[LIVE_WARMUP]) for name, engine in engines.items()}
    recompiles = graph_count() - g0 - graphs
    check(recompiles == 0, f"live: the hot reload recompiled {recompiles} times")
    k2 = {}
    for mode in LIVE_MODES:
        run = runs[mode]
        gaps = [live_frame_gap(a, b) for a, b in zip(run["outs"], runs["eager"]["outs"])]
        err, view = max(g[0] for g in gaps), max(g[1] for g in gaps)
        check(err <= SERVE_ATOL and view <= 1, f"live {mode} vs eager: {err:.3g} (tol "
              f"{SERVE_ATOL:g}), views {view} levels")
        reload_err, reload_view = live_frame_gap(reloaded[mode], reloaded["eager"])
        moved = float(np.abs(reloaded[mode][0] - run["outs"][0][0]).max())
        check(moved > 1e-3 and reload_err <= SERVE_ATOL and reload_view <= 1,
              f"live {mode} hot reload: moved {moved:.3g}, vs eager on the new weights "
              f"{reload_err:.3g}, views {reload_view}")
        check(run["k2_profiled"] == 4 * LIVE_SPLIT_FRAMES,
              f"live {mode}: the profiler saw {run['k2_profiled']} K2 launches in "
              f"{LIVE_SPLIT_FRAMES} frames")
        replayed = mode == "reduce-overhead"  # CUDA graph replays run no Python counter
        want_k2 = 0 if replayed else 4 * LIVE_FRAMES
        check(run["counts"] == serving_counts(want_k2),
              f"live {mode}: launch counters {run['counts']} over {LIVE_FRAMES} frames, "
              f"expected K2 {want_k2}")
        run.update(err=err, view=view, reload_err=reload_err)
        k2[f"live {mode}"] = {"counter": run["counts"]["K2"],
                              "profiler": run["k2_profiled"], "frames": LIVE_FRAMES,
                              "profiled_frames": LIVE_SPLIT_FRAMES}
    runs["default"]["cache"] = engines["default"].compile_cache.reports["live frame"]

    def describe(name: str, run: dict) -> str:
        return (f"{name} {run['ms']:.2f} ms/frame median (min {min(run['times']) * 1e3:.2f}, "
                f"max {max(run['times']) * 1e3:.2f}; first call {run['first_s']:.1f} s), split "
                + ", ".join(f"{k} {v:.3f}" for k, v in run["split"].items())
                + f" ms, device kernels {run['kernel_ms']:.3f} ms a frame "
                f"({run['kernels']:.0f} kernels) = busy {run['busy']:.1f}%, peak "
                f"{run['peak_gib']:.3f} GiB")

    print(f"live compiled: {CAPTURE_HW[1]}x{CAPTURE_HW[0]} captures rectified and resized to "
          f"{HW[1]}x{HW[0]}, base 32 f32, batch 1, TF32 off, {LIVE_FRAMES} frames after "
          f"{LIVE_WARMUP}, the engines in turns: "
          + "; ".join(describe(k, r) for k, r in runs.items()))
    for mode in LIVE_MODES:
        run = runs[mode]
        print(f"live compiled: {mode}: 1 graph, vs the eager engine on every frame: disparity "
              f"and logvar within {run['err']:.3g} (tol {SERVE_ATOL:g}), views within "
              f"{run['view']} level; hot reload (epoch 99): 0 recompiles, vs the eager engine "
              f"on the new weights {run['reload_err']:.3g} ok; K2 launches: the counter "
              f"{run['counts']['K2']} over {LIVE_FRAMES} frames, the profiler "
              f"{run['k2_profiled']} in {LIVE_SPLIT_FRAMES} frames ok; "
              f"{runs['eager']['ms'] / run['ms']:.3f}x the eager frame")
    return {"runs": runs, "k2": k2}


def serving_argv(aot: Path) -> dict[str, list[str]]:
    """The compiled serving CLIs' flags beyond ``check_evaluate``'s and
    ``check_predict``'s: evaluate over SERVE_RAGGED samples; both compiled
    with the compile cache at ``aot``."""
    return {
        "evaluate": ["--split", "all", "--max-samples", str(SERVE_RAGGED),
                     "--compile", "--aot-cache", str(aot)],
        "predict": ["--compile", "--aot-cache", str(aot)],
    }


def serving_cache_child(tmp_dir: str) -> None:
    """The second process of the serving compile-cache check (``python -c``,
    from the repository root, with empty Inductor and Triton caches of its
    own): evaluate, predict and the live engine compiled on the first
    process's ``--aot-cache`` directory; prints one RESULT line."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() runs the first
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp_dir)
    ckpt, aot, calib = tmp / "serving.pt", tmp / "serving_aot", tmp / "stereo_calib.npz"
    argv = serving_argv(aot)
    t0 = time.perf_counter()
    ev, _, _ = check_evaluate(tmp / "data", ckpt, *argv["evaluate"])
    pr, _, _ = check_predict(tmp / "data", ckpt, tmp / "predictions_child", calib,
                             *argv["predict"])
    with np.load(calib) as bundle:
        rectifier = Rectifier.from_calibration(dict(bundle), "cuda")
    engine = LiveDepthEngine((HW[1], HW[0]), rectifier, "cuda", 32,
                             compile=CompileOptions(), compile_cache=aot)
    engine.load_checkpoint(ckpt)
    rng = np.random.default_rng(14)
    engine.process(*(rng.integers(0, 256, (*CAPTURE_HW, 3), dtype=np.uint8) for _ in range(2)))
    print("RESULT " + json.dumps({
        "evaluate": ev["compile_cache"]["eval step"], "predict": pr["compile_cache"]["predict"],
        "live": engine.compile_cache.reports["live frame"],
        "seconds": time.perf_counter() - t0}), flush=True)


def steady_compiled(ckpt: Path) -> dict:
    """predict_fn and the eval step at batch 30 f32, eager and compiled
    (Inductor, default mode) from ``ckpt``, SERVE_REPS calls each after a
    warm-up, TF32 off and then on; the compiled predict_fn's output against
    the eager one's (TF32 off)."""
    model = StereoUNet(base_channels=32, device="cuda").eval()
    checkpoint.load_model_variables(ckpt, model)
    compiled = compile_model(model, CompileOptions())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    batch = torch.randint(0, 256, (SERVE_BATCH, *HW, 6), dtype=torch.uint8, device="cuda",
                          generator=gen)
    target = torch.rand((SERVE_BATCH, *HW), device="cuda", generator=gen) * 63.5 + 0.5
    eval_step = make_eval_step()
    fns = {}
    for name, module in (("eager", None), ("compiled", compiled)):
        predict_fn = make_predict_fn(model, compiled=module)
        state = TrainState(model, None, None, compiled=module)
        fns[f"predict_fn {name}"] = functools.partial(predict_fn, batch)
        fns[f"eval step {name}"] = functools.partial(
            eval_step, state, {"input": batch, "target": target})
    g0 = graph_count()
    off = {name: rep_ms(fn, SERVE_REPS) for name, fn in fns.items()}
    graphs_off = graph_count() - g0
    err, _ = max_err(fns["predict_fn compiled"](), fns["predict_fn eager"]())
    check(err <= SERVE_ATOL, f"compiled predict_fn vs eager (TF32 off): {err:.3g}")
    with cudnn_tf32():
        on = {name: rep_ms(fn, SERVE_REPS) for name, fn in fns.items()}
    graphs_on = graph_count() - g0 - graphs_off
    for what in ("predict_fn", "eval step"):
        e_off, c_off = off[f"{what} eager"], off[f"{what} compiled"]
        e_on, c_on = on[f"{what} eager"], on[f"{what} compiled"]
        print(f"{what} compiled: batch {SERVE_BATCH} f32, {SERVE_REPS} calls after a warm-up: "
              f"TF32 off compiled {spread(c_off)} vs eager {spread(e_off)} "
              f"({statistics.median(e_off) / statistics.median(c_off):.3f}x); with "
              f"cudnn.allow_tf32=True compiled {spread(c_on)} vs eager {spread(e_on)} "
              f"({statistics.median(e_on) / statistics.median(c_on):.3f}x)")
    print(f"predict_fn compiled: vs eager on the batch (TF32 off) within {err:.3g} (tol "
          f"{SERVE_ATOL:g}) ok; new graphs {graphs_off} with TF32 off (a graph the CLIs "
          f"compiled serves where its guards hold), {graphs_on} after turning cuDNN TF32 on")
    return {"off": off, "on": on, "err": err}


def phase_compiled_serving(tmp: Path, ckpt: Path, caches: Path) -> dict:
    """The serving CLIs with ``--compile`` (Inductor, mode default) on the
    serving phase's dataset and ``last.pt``: evaluate over a ragged tail and
    predict, each held against its eager run of this call, with the compile
    cache at one directory; the steady compiled forwards beside eager; the
    live engine compiled in each mode; then a child process with empty
    Inductor and Triton caches runs all three from that directory's blobs.
    Returns the K2 launches and the compile seconds."""
    data, aot, calib = tmp / "data", tmp / "serving_aot", tmp / "stereo_calib.npz"
    shutil.copyfile(ckpt, tmp / "serving.pt")
    ckpt = tmp / "serving.pt"
    argv = serving_argv(aot)
    eager, eager_s, _ = check_evaluate(data, ckpt, *argv["evaluate"][:4])
    torch._dynamo.reset()
    g0 = graph_count()
    got, got_s, k2_eval = check_evaluate(data, ckpt, *argv["evaluate"])
    graphs = graph_count() - g0
    eval_cache = got["compile_cache"]["eval step"]
    check(graphs == 1, f"compiled evaluate: {graphs} graphs over a ragged tail, expected 1")
    check(eval_cache["source"] == "compiled", f"compiled evaluate cache {eval_cache}")
    worst = max(abs(got[k] - eager[k]) / abs(eager[k]) for k in ("mae", "rmse", "nll", "sigma"))
    check(got["valid_pixels"] == eager["valid_pixels"] and worst <= SERVE_RTOL,
          f"compiled evaluate {got} vs eager {eager}: {worst:.3g}")
    print(f"evaluate compiled: --compile --aot-cache <dir>, base 32 f32, batch {SERVE_BATCH}, "
          f"{got['samples']} samples (a batch of {SERVE_BATCH} and a tail of "
          f"{got['samples'] % SERVE_BATCH} padded to it), TF32 off: {got_s:.2f} s with its cold "
          f"compile ({eval_cache['seconds']:.1f} s the first batch) vs eager {eager_s:.2f} s; "
          f"1 graph, 0 recompiles; metrics within {worst:.2g} (rel) of the eager evaluate's "
          f"(tol {SERVE_RTOL:g}), valid pixels {got['valid_pixels']} equal; K2 launches "
          f"{k2_eval} (4 a batch) ok")

    g0 = graph_count()
    pred, pred_s, k2_pred = check_predict(data, ckpt, tmp / "predictions_compiled", calib,
                                          *argv["predict"])
    graphs = graph_count() - g0
    pred_cache = pred["compile_cache"]["predict"]
    check(graphs == 1 and pred_cache["source"] == "compiled",
          f"compiled predict: {graphs} graphs, cache {pred_cache}")
    gap = npz_gap(tmp / "predictions_compiled", tmp / "predictions")
    check(gap <= SERVE_ATOL, f"compiled predict vs eager predict: npz gap {gap:.3g} beyond a "
          f"float16 ulp (tol {SERVE_ATOL:g})")
    print(f"predict compiled: --compile --aot-cache <dir>, {pred['pairs']} pairs (a batch of "
          f"{SERVE_BATCH} and a padded tail of {PREDICT_PAIRS % SERVE_BATCH}), TF32 off: "
          f"{pred_s:.2f} s with its cold compile ({pred_cache['seconds']:.1f} s the first "
          f"batch); 1 graph; every npz within a float16 ulp plus {max(gap, 0.0):.3g} of the "
          f"eager predict's (tol {SERVE_ATOL:g}); K2 launches {k2_pred} ok")

    steady = steady_compiled(ckpt)
    with np.load(calib) as bundle:
        live = check_live_compiled(tmp, ckpt, dict(bundle), aot)

    env = dict(os.environ)
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor_serving_child"),
                     ("TRITON_CACHE_DIR", "triton_serving_child")):
        (caches / sub).mkdir()
        env[var] = str(caches / sub)
    t0 = time.perf_counter()
    [(line, _)] = run_process_farm(
        "import sys, chip_smoke; chip_smoke.serving_cache_child(sys.argv[1])",
        lambda i: [str(tmp)], num_processes=1, timeout=600,
        cwd=str(Path(__file__).resolve().parent), env=env)
    child_s = time.perf_counter() - t0
    child = json.loads(line)
    for label in ("evaluate", "predict", "live"):
        report = child[label]
        check(report["source"] == "aot-cache" and report["fxgraph_cache_hit"] > 0
              and report["fxgraph_cache_miss"] == 0,
              f"serving child {label}: {report} (expected its graph from the blob)")
    cold = {"evaluate": eval_cache["seconds"], "predict": pred_cache["seconds"],
            "live": live["runs"]["default"]["cache"]["seconds"]}
    blobs = sorted(aot.glob("aot_*.bin"))
    print("serving compile cache: --aot-cache <dir> shared by the three: cold compile in this "
          "process (first call) " + ", ".join(f"{k} {v:.1f} s" for k, v in cold.items())
          + "; a second process with empty Inductor and Triton caches loads each from the blob: "
          + ", ".join(f"{k} {child[k]['seconds']:.1f} s (aot-cache, FX-graph cache hits "
                      f"{child[k]['fxgraph_cache_hit']}, misses 0)" for k in cold)
          + f"; {len(blobs)} blobs, {sum(b.stat().st_size for b in blobs) / 1e6:.1f} MB; the "
          f"child {child['seconds']:.1f} s for all three runs, {child_s:.1f} s with its start ok")
    return {"k2": {"evaluate": k2_eval, "predict": k2_pred, **live["k2"]},
            "cold": cold, "from_blob": {k: child[k]["seconds"] for k in cold},
            "steady": steady}


def knob_forward_backward(model: StereoUNet, inputs: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor) -> tuple[list[float], dict]:
    """One train-mode forward and backward: LossStats and gradients."""
    model.train()
    model.zero_grad(set_to_none=True)
    disp, logvar = model(inputs, return_uncertainty=True)
    loss, stats = heteroscedastic_laplace_nll(disp[..., 0], logvar[..., 0], target, mask)
    loss.backward()
    return ([float(s.detach()) for s in stats],
            {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})


def knob_gaps(want, got) -> tuple[float, float, str]:
    (stats_w, grads_w), (stats_g, grads_g) = want, got
    stats_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(stats_g, stats_w))
    gap, leaf = largest_leaf_gap(grads_w, grads_g)
    return stats_gap, gap, leaf


def phase_knobs(images: torch.Tensor, targets: torch.Tensor) -> dict:
    """Each of KNOBS at the main path's setting from the default model's
    weights: one forward and backward held against the default model's on
    one augmented batch, then KNOB_STEPS timed train steps with their
    launches and peak memory."""
    default = seeded_model(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    weights = {k: v.clone() for k, v in default.state_dict().items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    batch = {"input": images[:BATCH], "target": targets[:BATCH]}
    inputs = augment_stereo_batch_fused(gen, batch["input"], AugmentConfig(),
                                        out_dtype=torch.bfloat16)
    target, mask = train_step._targets_and_mask(batch)

    def build(kwargs) -> StereoUNet:
        model = StereoUNet(base_channels=32, compute_dtype=torch.bfloat16, device="cuda",
                           **kwargs)
        model.load_state_dict(weights)
        return model

    # cuDNN's deterministic algorithms for the comparisons, so that their
    # readings repeat; the timed steps below run the autotuned ones.
    torch.backends.cudnn.deterministic = True
    try:
        want = knob_forward_backward(default, inputs, target, mask)
        floor = knob_gaps(want, knob_forward_backward(build({}), inputs, target, mask))
        results = {}
        for name, (kwargs, _, _) in KNOBS.items():
            gaps = knob_gaps(want, knob_forward_backward(build(kwargs), inputs, target, mask))
            results[name] = {"stats_gap": gaps[0], "grad_gap": gaps[1], "leaf": gaps[2]}
    finally:
        torch.backends.cudnn.deterministic = False

    # The default model first and last: the spread of the two readings is
    # the drift of the call.
    for name, (kwargs, _, _) in {"default": ({}, 0, 0), **KNOBS,
                                 "default again": ({}, 0, 0)}.items():
        model = build(kwargs)
        state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
        step = make_train_step(AugmentConfig())
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(KNOB_STEPS):
            _, stats = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        run_counts = counts()
        # Every model runs its 18 BatchNorms on BN1-BN4.
        expected = expect_launches(**train_launches(KNOB_STEPS))
        check(run_counts == expected, f"knob {name}: launches {run_counts}, expected {expected}")
        check(math.isfinite(metrics_from_stats(stats)["loss"]), f"knob {name}: loss {stats}")
        results.setdefault(name, {}).update(
            ms=start.elapsed_time(end) / KNOB_STEPS,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, counts=run_counts)
        del model, state, step
        torch.cuda.empty_cache()
    base = results["default"]
    print(f"knobs: the default model {base['ms']:.2f} ms/step first and "
          f"{results['default again']['ms']:.2f} last, peak {base['peak_gib']:.2f} GiB")
    for name, (_, stats_tol, grad_tol) in KNOBS.items():
        r = results[name]
        print(f"knobs: {name}: vs the default model (base 32 bf16, batch {BATCH}, "
              f"{HW[0]}x{HW[1]}, one augmented batch): LossStats within {r['stats_gap']:.3g} "
              f"(tol {stats_tol:g}), gradients within {r['grad_gap']:.3g} of their norm "
              f"(largest in {r['leaf']}; tol {grad_tol:g}); {KNOB_STEPS} augmented steps "
              f"{r['ms']:.2f} ms/step ({base['ms'] / r['ms']:.3f}x the default's "
              f"{base['ms']:.2f}), peak {r['peak_gib']:.2f} GiB (default "
              f"{base['peak_gib']:.2f}); launches {r['counts']}")
    print(f"knobs: the default model against a copy of itself (the comparisons' floor, "
          f"cuDNN's deterministic algorithms): LossStats within {floor[0]:.3g}, gradients "
          f"within {floor[1]:.3g} of their norm (largest in {floor[2]})")
    for name, (_, stats_tol, grad_tol) in KNOBS.items():
        r = results[name]
        check(r["stats_gap"] <= stats_tol and r["grad_gap"] <= grad_tol,
              f"knob {name}: LossStats {r['stats_gap']:.3g} (tol {stats_tol:g}), gradient of "
              f"{r['leaf']} {r['grad_gap']:.3g} of its norm (tol {grad_tol:g})")
    print("knobs: every knob within its limits ok")
    return results


def multi_rank_steps(mesh: Mesh, batch: dict[str, torch.Tensor], steps: int,
                     save_to: Path | None = None, augment: AugmentConfig | None = None,
                     height: int | None = None) -> dict:
    """``steps`` float32 train steps of the full-width model from seed-0
    weights on ``mesh`` (with ``augment``, augmented; on a spatial mesh the
    images are ``height`` rows high): each step's summed LossStats and
    gradients (on the host), the weights and buffers after them, seconds
    (all steps and each one), and each step's peak memory and the memory
    held at the end of its forward (the tensors saved for the backward),
    both above what was held before it (``step_peak_bytes``,
    ``step_forward_bytes``). With ``save_to``, the train state before each
    step and after the last is saved there as ``state<k>.pt``."""
    model = seeded_model(base_channels=32, device=mesh.device,
                       bn_group=mesh.group if mesh.distributed else None,
                       spatial_group=mesh.spatial_group)
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), 0, mesh)
    step = make_train_step(augment, mesh, height)
    out = {"stats": [], "grads": [], "seconds": 0.0, "step_seconds": [],
           "step_peak_bytes": [], "step_forward_bytes": []}
    held = 0
    model.register_forward_hook(lambda *_: out["step_forward_bytes"].append(
        torch.cuda.memory_allocated() - held))
    for k in range(steps + 1):
        if save_to is not None:
            checkpoint.save_checkpoint(save_to, f"state{k}", state, epoch=k, config={},
                                       metrics={})
        if k == steps:
            break
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        out["stats"].append([float(s) for s in stats])
        out["step_seconds"].append(time.perf_counter() - t0)
        out["step_peak_bytes"].append(torch.cuda.max_memory_allocated() - held)
        out["seconds"] += out["step_seconds"][-1]
        out["grads"].append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    out["weights"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return out


def one_rank_steps_from(states: Path, batch: dict[str, torch.Tensor], steps: int,
                        augment: AugmentConfig | None = None) -> list:
    """For each k < ``steps``, one float32 step on one rank over ``batch``
    from the train state saved as ``states/state<k>.pt`` (its generator
    too): its LossStats, gradients, the weights after it, its seconds, and
    its peak memory and the memory held at the end of its forward, both
    above what was held before it. One model, built once, loads each
    state."""
    model = StereoUNet(base_channels=32, device="cuda")
    held, forward_bytes = 0, []
    model.register_forward_hook(lambda *_: forward_bytes.append(
        torch.cuda.memory_allocated() - held))
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), 0)
    step = make_train_step(augment)
    out = []
    for k in range(steps):
        state, _ = checkpoint.load_train_state(states / f"state{k}.pt", state)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        stats = [float(s) for s in stats]
        out.append({"stats": stats, "seconds": time.perf_counter() - t0,
                    "peak_bytes": torch.cuda.max_memory_allocated() - held,
                    "forward_bytes": forward_bytes[-1],
                    "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                    "weights": {n: v.detach().to("cpu", copy=True)
                                for n, v in model.state_dict().items()}})
    return out


def largest_leaf_gap(want: dict, got: dict) -> tuple[float, str]:
    """The largest gap between two sets of gradients, leaf by leaf, relative
    to the leaf's norm in ``want`` (floored at GRAD_FLOOR of the largest
    norm), and that leaf's name."""
    top = max(float(g.norm()) for g in want.values())
    return max((float((got[n] - g).norm()) / max(float(g.norm()), GRAD_FLOOR * top), n)
               for n, g in want.items())


def held_against_one_rank(two: dict, ones: list, states: Path, what: str, stats_rtol: float,
                          grad_rtol: float, bn_rtol: float) -> str:
    """Check each of several ranks' steps (``two``, from ``multi_rank_steps``)
    against one rank's step from the same state (``ones``, from
    ``one_rank_steps_from``; the states after each step are in ``states``):
    the summed LossStats within ``stats_rtol`` relative, each gradient leaf
    within ``grad_rtol`` of its norm, the BatchNorm running statistics within
    ``bn_rtol`` of theirs, and weights over lr/2 apart only where the two
    gradients are float noise across zero (AdamW's first update there lands
    anywhere in [-lr, lr]). Returns the readings as text."""
    stats_gap = grad_gap = bn_gap = 0.0
    grad_leaf = bn_buffer = ""
    apart = total = 0
    for k, one in enumerate(ones):
        after = torch.load(states / f"state{k + 1}.pt", weights_only=False)["model_state_dict"]
        stats_gap = max(stats_gap, *(abs(a - b) / max(abs(b), 1e-12)
                                     for a, b in zip(two["stats"][k], one["stats"])))
        g1, g2 = one["grads"], two["grads"][k]
        gap, leaf = largest_leaf_gap(g1, g2)
        if gap > grad_gap:
            grad_gap, grad_leaf = gap, f"{leaf} at step {k + 1}"
        for n, w in one["weights"].items():
            w2 = after[n].cpu()
            if n in g1:
                far = (w2 - w).abs() > 5e-4
                noise = 2 * (g2[n] - g1[n]).abs() >= torch.minimum(
                    g1[n].abs(), g2[n].abs()) + 1e-8
                wrong = int((far & ~noise).sum())
                check(wrong == 0, f"{what} at step {k + 1}: {wrong} weights of {n} "
                      "over lr/2 apart where their gradients agree")
                apart += int(far.sum())
                total += w.numel()
            elif n.endswith(("running_mean", "running_var")):
                rel = float((w2 - w).norm()) / max(float(w.norm()), 1e-12)
                if rel > bn_gap:
                    bn_gap, bn_buffer = rel, f"{n} at step {k + 1}"
            else:
                check(torch.equal(w2, w), f"{what} at step {k + 1}: {n}")
    check(stats_gap <= stats_rtol, f"{what}: LossStats gap {stats_gap:.3g}")
    check(grad_gap <= grad_rtol, f"{what}: gradient of {grad_leaf} differs by "
          f"{grad_gap:.3g} of its norm")
    check(bn_gap <= bn_rtol, f"{what}: {bn_buffer} differs by {bn_gap:.3g}")
    return (f"LossStats within {stats_gap:.3g} (tol {stats_rtol:g}); gradients within "
            f"{grad_gap:.3g} of their norm (largest in {grad_leaf}; tol {grad_rtol:g}); "
            f"{apart} of {total} weight updates over lr/2 apart, each where its gradient is "
            f"float noise across zero; BN running statistics within {bn_gap:.3g} (largest "
            f"{bn_buffer}; tol {bn_rtol:g})")


def mr_batch() -> dict[str, np.ndarray]:
    """The multi-rank check's global batch: random uint8 pairs, targets with
    8 invalid rows everywhere and half of every image of the second stripe
    invalid, so the two ranks' valid counts differ. The second stripe's
    pixels are darker (below 128), so a rank's own BatchNorm statistics are
    far from the global ones and a step that used them would be off."""
    rng = np.random.default_rng(9)
    target = rng.uniform(0.5, 64.0, (MR_BATCH, *HW)).astype(np.float32)
    target[:, :8] = 0.0
    target[MR_BATCH // 2:, :, : HW[1] // 2] = 0.0
    inputs = rng.integers(0, 256, (MR_BATCH, *HW, 6), dtype=np.uint8)
    inputs[MR_BATCH // 2:] //= 2
    return {"input": inputs, "target": target}


def trainer_argv(tmp: Path, *extra: str) -> list[str]:
    return [
        "--dataset-root", str(tmp / "data"), "--packed-cache-root", str(tmp / "packed"),
        "--height", str(HW[0]), "--width", str(HW[1]), "--base-channels", "32",
        "--compute-dtype", "bfloat16", "--batch-size", str(TRAIN_BATCH),
        "--device-resident", "auto", "--preview-samples", "4", "--log-every-batches", "2",
        *extra,
    ]


def timed_train_epochs() -> list[float]:
    """Seconds of each call of the trainer's epoch loop (training only, not
    validation or saves), recorded into the returned list."""
    seconds: list[float] = []
    inner = trainer.run_train_epoch

    def run_train_epoch(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = inner(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return result

    trainer.run_train_epoch = run_train_epoch
    return seconds


def rank_child(rank: int, tmp_dir: str) -> None:
    """One of the two ranks of the multi-rank phase, in a process of its
    own on cuda:0 (``python -c``, from the repository root): the steps, then
    the trainer CLI; prints one RESULT line."""
    marks = {"imported": time.time()}
    tmp = Path(tmp_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    address = f"file://{tmp / 'rendezvous'}"
    initialize_multihost(address, 2, rank, device=device, backend="gloo")
    mesh = make_mesh(device)
    marks["joined"] = time.time()
    batch = shard_batch_to_mesh(mr_batch(), mesh)
    steps = multi_rank_steps(mesh, batch, MR_STEPS, tmp / "mr_states" if rank == 0 else None)
    torch.save(steps if rank == 0 else {"weights": steps["weights"]}, tmp / f"mr_rank{rank}.pt")
    del batch, steps
    torch.cuda.empty_cache()
    marks["stepped"] = time.time()
    collective_ms = time_collectives(device)
    marks["collectives"] = time.time()

    epoch_seconds = timed_train_epochs()
    summary, run_counts, seconds = counted(trainer.main, trainer_argv(
        tmp, "--epochs", str(MR_EPOCHS), "--mlflow-tracking-uri", str(tmp / "mr_mlruns"),
        "--output-dir", str(tmp / "mr_outputs"), "--multihost", "--coordinator-address",
        address, "--num-processes", "2", "--process-id", str(rank)))
    summary.pop("state")
    torch.distributed.destroy_process_group()
    marks["trained"] = time.time()
    print("RESULT " + json.dumps({"rank": rank, "summary": summary, "counts": run_counts,
                                  "seconds": seconds, "epoch_train_seconds": epoch_seconds,
                                  "collective_ms": collective_ms, "marks": marks}),
          flush=True)


def time_collectives(device: torch.device) -> dict[str, float]:
    """The step's collectives alone on the group, each timed to completion
    on the host (gloo on CUDA waits for the stream and goes through host
    memory): the gradient all-reduce (every parameter, float32) and the 36
    BatchNorm all-reduces of one step (18 forward, 18 backward; 2C + 1
    floats each at base 32)."""
    grads = torch.zeros(7_763_938, device=device)
    widths = [2 * c + 1 for c in (32, 64, 128, 256, 512, 256, 128, 64, 32) for _ in (0, 1)]
    small = [torch.zeros(n, device=device) for n in widths * 2]
    times = {}
    for name, tensors, reps in (("gradients", [grads], 5), ("batchnorm", small, 5)):
        torch.distributed.all_reduce(tensors[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for t in tensors:
                torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0) / reps
    return times


def check_nccl_rank(tmp: Path) -> dict:
    """One rank in a group of one, in this process, on the backend the CLI
    picks for CUDA: NCCL initialises on the card and runs its collectives; a
    train step on this one-rank mesh equals the step without a group,
    bitwise; then the trainer CLI with ``--multihost --num-processes 1`` for
    one epoch, in that group. The group is destroyed after."""
    device = torch.device("cuda", 0)
    address = f"127.0.0.1:{next_farm_port(29500)}"
    initialize_multihost(address, 1, 0, device=device)
    try:
        backend = torch.distributed.get_backend()
        probe = torch.arange(4.0, device=device)
        torch.distributed.all_reduce(probe)
        torch.distributed.broadcast(probe, 0)
        mesh = make_mesh(device)
        batch = {k: torch.from_numpy(v[:4]).to(device) for k, v in mr_batch().items()}
        torch.backends.cudnn.deterministic = True  # the two steps compare bitwise
        try:
            grouped = multi_rank_steps(mesh, batch, 1)
            alone = multi_rank_steps(Mesh(device), batch, 1)
        finally:
            torch.backends.cudnn.deterministic = False
        summary, run_counts, _ = counted(trainer.main, trainer_argv(
            tmp, "--epochs", "1", "--mlflow-tracking-uri", str(tmp / "nccl_mlruns"),
            "--output-dir", str(tmp / "nccl_outputs"), "--multihost", "--coordinator-address",
            address, "--num-processes", "1", "--process-id", "0"))
    finally:
        torch.distributed.destroy_process_group()
    equal = grouped["stats"] == alone["stats"] and all(
        torch.equal(grouped["weights"][k], v) for k, v in alone["weights"].items())
    return {"backend": backend, "world": mesh.world_size, "probe": probe.tolist(),
            "step_equal": equal, "global_step": summary["global_step"], "counts": run_counts}


def phase_multi_rank(tmp: Path) -> dict[str, list[int]]:
    """Two gloo ranks on the card against one rank, the trainer CLI on two
    ranks, and one NCCL rank (see the module docstring). Returns each
    kernel's launches on each rank in the two-rank trainer run."""
    repo = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    started = time.time()
    farm = run_process_farm(
        "import sys, chip_smoke; chip_smoke.rank_child(int(sys.argv[1]), sys.argv[2])",
        lambda i: [str(i), str(tmp)], num_processes=2, timeout=600, cwd=repo)
    results = [json.loads(line) for line, _ in farm]
    farm_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"mr_rank{r}.pt", weights_only=False) for r in range(2)]
    two = ranks[0]
    bitwise = all(torch.equal(v, ranks[1]["weights"][k]) for k, v in two["weights"].items())
    check(bitwise, "the two ranks' weights differ")

    data = mr_batch()
    counts_valid = [int((data["target"][s] > 0).sum())
                    for s in (slice(0, MR_BATCH // 2), slice(MR_BATCH // 2, None))]
    check(two["stats"][0][4] == float(sum(counts_valid)), "valid count is not the global one")
    whole = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    ones = one_rank_steps_from(tmp / "mr_states", whole, MR_STEPS)
    del whole
    gaps = held_against_one_rank(two, ones, tmp / "mr_states", "two ranks vs one",
                                 MR_STATS_RTOL, MR_GRAD_RTOL, MR_BN_RTOL)
    print(f"multi-rank: 2 gloo ranks on cuda:0, base 32 f32 (TF32 off) {HW[0]}x{HW[1]}, "
          f"global batch {MR_BATCH} as 2 x {MR_BATCH // 2} (valid pixels {counts_valid[0]} "
          f"and {counts_valid[1]}; the second stripe's pixels below 128), {MR_STEPS} steps in "
          f"a row, each held against one rank taking it over the whole batch from the two "
          f"ranks' state before it: {gaps}; the ranks' weights bitwise equal after the steps "
          f"ok; two ranks {1e3 * two['seconds'] / MR_STEPS:.1f} ms/step, one rank "
          f"{', '.join(f'{1e3 * o["seconds"]:.1f}' for o in ones)} ms (one model loading "
          f"each state: cuDNN's first choices in the first)")

    # The trainer CLI on the two ranks.
    summaries = [r["summary"] for r in results]
    train_n = len(split_samples(discover_samples(tmp / "data"), 0.1, 42)[0])
    steps_per_epoch = train_n // TRAIN_BATCH  # pinned, padded to the world size
    steps = MR_EPOCHS * steps_per_epoch
    val_batches = 1
    check([s["global_step"] for s in summaries] == [steps, steps],
          f"two-rank trainer global steps {[s['global_step'] for s in summaries]}")
    check(summaries[1]["run_id"] == "multihost-follower" != summaries[0]["run_id"]
          and all(s["device_resident"] == "pinned" for s in summaries),
          f"two-rank trainer summaries {summaries}")
    for a, b in zip(*(s["epochs"] for s in summaries)):
        check(a["val_mae"] == b["val_mae"] and math.isfinite(a["val_mae"]),
              f"ranks' val_mae {a['val_mae']} vs {b['val_mae']}")
    runs = sorted((tmp / "mr_outputs").iterdir())
    check([r.name for r in runs] == [summaries[0]["run_id"]], f"run directories {runs}")
    last = runs[0] / "checkpoints" / "last.pt"
    check(last.is_file(), "no last.pt from the two-rank trainer")
    tracked = {p.parent.parent for p in (tmp / "mr_mlruns").glob("*/*/metrics/*")}
    check(len(tracked) == 1, f"tracking runs {tracked}")
    launches: dict[str, list[int]] = {}
    for r, result in enumerate(results):
        previews = MR_EPOCHS if r == 0 else 0
        # Two ranks: the 18 BatchNorms of each training step on BN1-BN4 and
        # the epilogue after each all-reduce.
        expected = {"GM": steps, "K1": steps, "K3": 4 * steps,
                    "K2": 4 * (steps + MR_EPOCHS * val_batches + previews),
                    **bn_launches(18 * steps, group=True), **gate_launches(steps)}
        got = {k: result["counts"][k] for k in expected}
        check(got == expected, f"rank {r} trainer launches {got}, expected {expected}")
        for k, v in got.items():
            launches.setdefault(k, []).append(v)
    evaluated = evaluate.main(["--dataset-root", str(tmp / "data"), "--checkpoint", str(last),
                               "--height", str(HW[0]), "--width", str(HW[1]),
                               "--batch-size", str(SERVE_BATCH)])
    check(evaluated["checkpoint_epoch"] == MR_EPOCHS and math.isfinite(evaluated["mae"]),
          f"evaluate of the two-rank last.pt: {evaluated}")
    step_ms = [1e3 * r["epoch_train_seconds"][-1] / steps_per_epoch for r in results]
    marks = results[0]["marks"]
    split = {"start and imports": marks["imported"] - started,
             "rendezvous": marks["joined"] - marks["imported"],
             f"{MR_STEPS} steps with model build and saved states":
                 marks["stepped"] - marks["joined"],
             "collectives timing": marks["collectives"] - marks["stepped"],
             "trainer CLI": marks["trained"] - marks["collectives"]}
    print(f"multi-rank: trainer CLI --multihost --num-processes 2 (gloo, both ranks on "
          f"cuda:0), base 32 bf16, global batch {TRAIN_BATCH} as 2 x {TRAIN_BATCH // 2}, "
          f"pinned, {MR_EPOCHS} epoch of {steps_per_epoch} steps: rank 0 alone wrote "
          f"last.pt and the tracking run, evaluate reads its last.pt (val mae "
          f"{evaluated['mae']:.4f}); launches per rank {[r['counts'] for r in results]} ok; "
          f"training {step_ms[0]:.1f} / {step_ms[1]:.1f} ms per step on ranks 0 / 1 "
          f"(cuDNN's first choices included; two ranks share one card and gloo goes "
          f"through the host: not a scaling figure); the step's collectives alone on rank 0: gradient all-reduce "
          f"{results[0]['collective_ms']['gradients']:.1f} ms, the 36 BatchNorm all-reduces "
          f"{results[0]['collective_ms']['batchnorm']:.1f} ms; {farm_s:.1f} s with both "
          f"processes' start (rank 0: "
          f"{', '.join(f'{name} {t:.1f} s' for name, t in split.items())})")

    nccl = check_nccl_rank(tmp)
    check(nccl["backend"] == "nccl" and nccl["world"] == 1 and nccl["probe"] == [0, 1, 2, 3],
          f"NCCL rank: {nccl}")
    check(nccl["step_equal"], "a step on the one-rank NCCL mesh differs from the step "
          "without a group")
    check(nccl["global_step"] == steps_per_epoch and nccl["counts"]["K1"] == steps_per_epoch,
          f"NCCL trainer run: {nccl}")
    print(f"multi-rank: one rank on NCCL (the CLI's default backend for CUDA), in this "
          f"process: initialised, all_reduce and broadcast ran; a step on its one-rank mesh "
          f"equals the step without a group bitwise; trainer CLI --multihost "
          f"--num-processes 1 ran {nccl['global_step']} steps with launches "
          f"{nccl['counts']} ok ({time.perf_counter() - t0:.1f} s for the whole phase)")
    return launches


def sp_batch() -> dict[str, np.ndarray]:
    """The spatial check's global batch: random uint8 pairs, targets with 8
    invalid rows at the top and every row from 160 down invalid, so most
    invalid pixels lie in the lower stripe (rows 128-239): the stripes'
    valid counts differ. The lower stripe's pixels are darker (below 128),
    so a stripe's own gray means or BatchNorm statistics would be far from
    the whole image's."""
    rng = np.random.default_rng(13)
    target = rng.uniform(0.5, 64.0, (SP_BATCH, *HW)).astype(np.float32)
    target[:, :8] = 0.0
    target[:, 160:] = 0.0
    inputs = rng.integers(0, 256, (SP_BATCH, *HW, 6), dtype=np.uint8)
    inputs[:, 128:] //= 2
    return {"input": inputs, "target": target}


# The input (channels, pool level) of each of the StereoUNet's 18 3x3
# convolutions at base 32, encoder first: each exchanges one halo row of
# that many channels at width W >> level.
CONV_INPUTS = [(6, 0), (32, 0), (32, 1), (64, 1), (64, 2), (128, 2), (128, 3), (256, 3),
               (256, 4), (512, 4), (512, 3), (256, 3), (256, 2), (128, 2), (128, 1), (64, 1),
               (64, 0), (32, 0)]


def halo_exchanges(mesh: Mesh, n: int) -> tuple[float, float]:
    """The halo all-reduces of one float32 step at batch ``n`` alone, on the
    spatial group, each timed to completion on the host: per convolution one
    exchange forward and one backward, of a zero buffer (S, 2, n, 1, W >>
    level, channels). Returns (ms, MB all-reduced) per step."""
    bufs = [torch.zeros((mesh.spatial, 2, n, 1, HW[1] >> level, c), device=mesh.device)
            for c, level in CONV_INPUTS] * 2
    group = mesh.spatial_group.group
    torch.distributed.all_reduce(bufs[0], group=group)  # warm-up
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in bufs:
            torch.distributed.all_reduce(b, group=group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps, sum(b.numel() * 4 for b in bufs) / 1e6


def halo_copies_ms(mesh: Mesh, n: int, h: int) -> float:
    """Device milliseconds of the halo exchanges' copies in one float32 step
    at batch ``n`` on a stripe of ``h`` rows, without their all-reduces: per
    convolution, forward the edge rows written into a zero buffer and the
    concatenation; backward another zero buffer, the copy of the stripe's
    gradient and the two halo rows added into it. The timed calls are queued
    behind a spin of the card (~20 ms) that outlasts their enqueue."""
    s = mesh.spatial
    cases = [(torch.zeros((n, h >> level, HW[1] >> level, c), device=mesh.device),
              torch.zeros((n, (h >> level) + 2, HW[1] >> level, c), device=mesh.device))
             for c, level in CONV_INPUTS]

    def copies() -> None:
        for x, g in cases:
            buf = x.new_zeros((s, 2, n, 1, *x.shape[2:]))
            buf[0, 0], buf[0, 1] = x[:, :1], x[:, -1:]
            torch.cat([buf[1, 1], x, buf[1, 0]], dim=1)
            back = g.new_zeros((s, 2, n, 1, *g.shape[2:]))
            back[0, 0], back[0, 1] = g[:, :1], g[:, -1:]
            dx = g[:, 1:-1].clone()
            dx[:, :1] += back[1, 1]
            dx[:, -1:] += back[1, 0]

    reps = 5
    copies()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        copies()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spatial_child(rank: int, tmp_dir: str) -> None:
    """One of the two ranks of the spatial phase, in a process of its own on
    cuda:0 (``python -c``, from the repository root): the augmented steps on
    its height stripes, then the trainer CLI on the 1 x 2 mesh; prints one
    RESULT line."""
    tmp = Path(tmp_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    address = f"file://{tmp / 'sp_rendezvous'}"
    initialize_multihost(address, 2, rank, device=device, backend="gloo")
    mesh = make_mesh(device, spatial=2)
    batch = shard_batch_to_mesh(sp_batch(), mesh)
    torch.cuda.synchronize()
    reset_counts()
    steps = multi_rank_steps(mesh, batch, SP_STEPS, tmp / "sp_states" if rank == 0 else None,
                             SP_AUGMENT, HW[0])
    torch.cuda.synchronize()
    step_counts = counts()
    peak_gib = steps["step_peak_bytes"][-1] / 2**30
    forward_gib = steps["step_forward_bytes"][-1] / 2**30
    step_ms = [1e3 * t for t in steps["step_seconds"]]
    block = list(batch["input"].shape[:2])
    torch.save(steps if rank == 0 else {"weights": steps["weights"]}, tmp / f"sp_rank{rank}.pt")
    del batch, steps
    torch.cuda.empty_cache()
    halo_ms, halo_mb = halo_exchanges(mesh, SP_BATCH)
    copies_ms = halo_copies_ms(mesh, SP_BATCH, block[1])

    epoch_seconds = timed_train_epochs()
    summary, run_counts, seconds = counted(trainer.main, trainer_argv(
        tmp, "--epochs", str(SP_EPOCHS), "--mlflow-tracking-uri", str(tmp / "sp_mlruns"),
        "--output-dir", str(tmp / "sp_outputs"), "--multihost", "--coordinator-address",
        address, "--num-processes", "2", "--process-id", str(rank), "--spatial-devices", "2"))
    summary.pop("state")
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps({
        "rank": rank, "block": block, "step_counts": step_counts, "step_ms": step_ms,
        "peak_gib": peak_gib, "forward_gib": forward_gib, "halo_ms": halo_ms,
        "halo_mb": halo_mb,
        "copies_ms": copies_ms, "summary": summary,
        "counts": run_counts, "seconds": seconds, "epoch_train_seconds": epoch_seconds}),
        flush=True)


def phase_spatial(tmp: Path) -> dict[str, dict[str, list[int]]]:
    """Two gloo ranks on the card as a 1 x 2 spatial mesh against one rank,
    then the trainer CLI on that mesh (see the module docstring). Returns
    each kernel's launches on each rank in the steps and in the trainer
    run."""
    repo = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    farm = run_process_farm(
        "import sys, chip_smoke; chip_smoke.spatial_child(int(sys.argv[1]), sys.argv[2])",
        lambda i: [str(i), str(tmp)], num_processes=2, timeout=600, cwd=repo)
    results = [json.loads(line) for line, _ in farm]
    farm_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"sp_rank{r}.pt", weights_only=False) for r in range(2)]
    two = ranks[0]
    check(all(torch.equal(v, ranks[1]["weights"][k]) for k, v in two["weights"].items()),
          "the two stripes' ranks' weights differ")
    blocks = height_blocks(HW[0], 2)
    check([r["block"] for r in results] == [[SP_BATCH, b - a] for a, b in blocks],
          f"stripes {[r['block'] for r in results]}, expected the rows of {blocks}")

    data = sp_batch()
    valid = [int((data["target"][:, a:b] > 0).sum()) for a, b in blocks]
    check(two["stats"][0][4] == float(sum(valid)), "valid count is not the global one")
    whole = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    ones = one_rank_steps_from(tmp / "sp_states", whole, SP_STEPS, SP_AUGMENT)
    del whole
    gaps = held_against_one_rank(two, ones, tmp / "sp_states", "1 x 2 spatial vs one rank",
                                 SP_STATS_RTOL, SP_GRAD_RTOL, SP_BN_RTOL)
    expected = expect_launches(GM=SP_STEPS, K1=SP_STEPS, K2=4 * SP_STEPS, K3=4 * SP_STEPS,
                               **bn_launches(18 * SP_STEPS, group=True),
                               **gate_launches(SP_STEPS))
    for r, result in enumerate(results):
        check(result["step_counts"] == expected,
              f"rank {r} step launches {result['step_counts']}, expected {expected}")
    print(f"spatial: 2 gloo ranks on cuda:0 as a 1 (data) x 2 (spatial) mesh, base 32 f32 "
          f"(TF32 off) {HW[0]}x{HW[1]}, stripes of {blocks[0][1] - blocks[0][0]} and "
          f"{blocks[1][1] - blocks[1][0]} rows, global batch {SP_BATCH} (valid pixels "
          f"{valid[0]} and {valid[1]} in the two stripes; the lower stripe's pixels below "
          f"128), {SP_STEPS} augmented steps in a row (blur_prob {SP_AUGMENT.blur_prob}), "
          f"each held against one rank taking it over the whole images from the two ranks' "
          f"state before it: {gaps}; the ranks' weights bitwise equal after the steps; "
          f"launches per rank {[r['step_counts'] for r in results]} ok ({card()})")
    print(f"spatial: step ms on rank 0 "
          f"{', '.join(f'{t:.1f}' for t in results[0]['step_ms'])}, rank 1 "
          f"{', '.join(f'{t:.1f}' for t in results[1]['step_ms'])} (the first with cuDNN's "
          f"first choices; two ranks share one card and gloo goes through the host: not a "
          f"scaling figure); one rank over the whole images "
          f"{', '.join(f'{1e3 * o["seconds"]:.1f}' for o in ones)} ms; the last step's "
          f"memory above what was held before it, at the end of the forward / at its peak: "
          f"{results[0]['forward_gib']:.3f} / {results[0]['peak_gib']:.3f} GiB on rank 0, "
          f"{results[1]['forward_gib']:.3f} / {results[1]['peak_gib']:.3f} GiB on rank 1, "
          f"{ones[-1]['forward_bytes'] / 2**30:.3f} / {ones[-1]['peak_bytes'] / 2**30:.3f} GiB "
          f"on one rank; the 36 halo all-reduces of a step "
          f"alone ({results[0]['halo_mb']:.1f} MB) {results[0]['halo_ms']:.1f} / "
          f"{results[1]['halo_ms']:.1f} ms on ranks 0 / 1, their copies on the card "
          f"(packing and concatenation, forward and backward) {results[0]['copies_ms']:.3f} / "
          f"{results[1]['copies_ms']:.3f} ms ({card()})")

    summaries = [r["summary"] for r in results]
    train_n = len(split_samples(discover_samples(tmp / "data"), 0.1, 42)[0])
    steps_per_epoch = train_n // TRAIN_BATCH
    steps = SP_EPOCHS * steps_per_epoch
    check([s["global_step"] for s in summaries] == [steps, steps],
          f"spatial trainer global steps {[s['global_step'] for s in summaries]}")
    check(summaries[1]["run_id"] == "multihost-follower" != summaries[0]["run_id"]
          and all(s["device_resident"] == "pinned" for s in summaries),
          f"spatial trainer summaries {summaries}")
    for a, b in zip(*(s["epochs"] for s in summaries)):
        check(a["val_mae"] == b["val_mae"] and math.isfinite(a["val_mae"]),
              f"stripes' val_mae {a['val_mae']} vs {b['val_mae']}")
    runs = sorted((tmp / "sp_outputs").iterdir())
    check([r.name for r in runs] == [summaries[0]["run_id"]], f"run directories {runs}")
    check((runs[0] / "checkpoints" / "last.pt").is_file(), "no last.pt from the spatial trainer")
    previews = sorted((runs[0] / "mlflow_previews").rglob("*.png"))
    check(len(previews) == 4 * SP_EPOCHS
          and all(Image.open(p).size == (4 * HW[1], HW[0]) for p in previews),
          f"spatial trainer previews {previews}")
    launches: dict[str, dict[str, list[int]]] = {"steps": {}, "trainer": {}}
    for r, result in enumerate(results):
        # Both ranks of data row 0 predict the previews, each its stripe.
        want = {"GM": steps, "K1": steps, "K3": 4 * steps,
                "K2": 4 * (steps + SP_EPOCHS * 2),  # a validation batch, the previews
                **bn_launches(18 * steps, group=True), **gate_launches(steps)}
        got = {k: result["counts"][k] for k in want}
        check(got == want, f"rank {r} spatial trainer launches {got}, expected {want}")
        for k in want:
            launches["steps"].setdefault(k, []).append(result["step_counts"][k])
            launches["trainer"].setdefault(k, []).append(got[k])
    step_ms = [1e3 * r["epoch_train_seconds"][-1] / steps_per_epoch for r in results]
    print(f"spatial: trainer CLI --multihost --num-processes 2 --spatial-devices 2 (gloo, "
          f"both ranks on cuda:0), base 32 bf16, global batch {TRAIN_BATCH} on 2 stripes, "
          f"pinned, {SP_EPOCHS} epoch of {steps_per_epoch} steps: rank 0 alone wrote "
          f"last.pt and {len(previews)} whole-image previews; launches per rank "
          f"{[r['counts'] for r in results]} ok; training {step_ms[0]:.1f} / "
          f"{step_ms[1]:.1f} ms per step on ranks 0 / 1 (cuDNN's first choices included); "
          f"{farm_s:.1f} s with both processes' start ({card()})")
    return launches


def phase_reference_step() -> None:
    """One train step on a small input, on the card (kernel augmentation)
    and on the CPU (plain augmentation), from the same weights and batch."""
    still = dict(brightness_jitter=0.0, contrast_jitter=0.0, saturation_jitter=0.0,
                 hue_jitter=0.0, gamma_jitter=0.0, noise_std_max=0.0, blur_prob=0.0)
    rng = np.random.default_rng(0)
    batch = {
        "input": torch.from_numpy(rng.integers(0, 256, (4, 32, 48, 6), dtype=np.uint8)),
        "target": torch.from_numpy(rng.uniform(0.5, 8.0, (4, 32, 48)).astype(np.float32)),
    }
    results = {}
    for device, impl in (("cpu", "auto"), ("cuda", "kernel")):
        model = seeded_model(base_channels=8, device=device)
        state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), 0)
        step = make_train_step(AugmentConfig(impl=impl, **still))
        state, stats = step(state, {k: v.to(device) for k, v in batch.items()})
        # The step leaves its gradients on the parameters.
        grads = {n: p.grad.detach().flatten().cpu() for n, p in model.named_parameters()}
        weights = {n: p.detach().flatten().cpu() for n, p in model.named_parameters()}
        results[device] = ([float(s) for s in stats], grads, weights)
    (cpu_stats, cpu_g, cpu_w), (gpu_stats, gpu_g, gpu_w) = results["cpu"], results["cuda"]
    for name, a, b in zip(LossStats._fields, gpu_stats, cpu_stats):
        check(math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-4), f"reference step {name}: {a} vs {b}")
    # The whole backward, K3 and the channels_last views included, against
    # the CPU's plain pool: every parameter's gradient relative to its norm.
    top = max(float(g.norm()) for g in cpu_g.values())
    rel = {n: float((gpu_g[n] - cpu_g[n]).norm()) / max(float(cpu_g[n].norm()), GRAD_FLOOR * top)
           for n in cpu_g}
    worst_g = max(rel, key=rel.get)
    check(rel[worst_g] <= GRAD_RTOL,
          f"reference step gradient of {worst_g} differs by {rel[worst_g]:.3g} of its norm")
    # AdamW's first update is lr * g / (|g| + eps) plus the same decay on
    # both devices, so two updates of a weight differ by more than lr/2 only
    # where its two gradients differ by more than half the smaller one plus
    # eps (float noise across zero).
    total = apart_count = 0
    for n in cpu_w:
        apart = (gpu_w[n] - cpu_w[n]).abs() > 5e-4
        noise = 2 * (gpu_g[n] - cpu_g[n]).abs() >= torch.minimum(
            cpu_g[n].abs(), gpu_g[n].abs()) + 1e-8
        wrong = int((apart & ~noise).sum())
        check(wrong == 0, f"reference step: {wrong} weights of {n} over lr/2 apart after "
              "the update where their gradients agree")
        total += cpu_w[n].numel()
        apart_count += int(apart.sum())
    print(f"reference step (base 8, 4x32x48, f32): card vs CPU nll_sum "
          f"{gpu_stats[0]:.6g} vs {cpu_stats[0]:.6g}; gradients within {rel[worst_g]:.3g} of "
          f"their norm (largest in {worst_g}; tol {GRAD_RTOL:g}); after the update "
          f"{apart_count} of {total} weights over lr/2 apart, each where its gradient is "
          "float noise across zero ok")

    # A batch with no valid pixel leaves weights, BN stats and the (on-card,
    # capturable) AdamW state as they were.
    before = [t.clone() for t in train_step._gated_tensors(state)]
    empty = {"input": batch["input"].cuda(), "target": torch.zeros_like(batch["target"]).cuda()}
    state, stats = step(state, empty)
    after = train_step._gated_tensors(state)
    check(float(stats.valid_count) == 0.0, "zero-valid batch counted pixels")
    check(all(torch.equal(a, b) for a, b in zip(after, before)), "zero-valid batch changed state")

    # The learning-rate schedule read from AdamW's on-card step count equals
    # the same schedule on the CPU, step by step, to 1e-5: the two devices'
    # float32 cos differ by an ulp, which 1 + cos(x) near x = pi enlarges.
    lrs = {}
    for device in ("cpu", "cuda"):
        w = torch.nn.Parameter(torch.ones(3, device=device))
        opt = make_adamw([w], 1e-3, 0.0, schedule="cosine", total_steps=10, warmup_steps=3)
        lrs[device] = []
        for _ in range(12):
            w.grad = torch.ones_like(w)
            train_step._set_learning_rate(opt)
            lrs[device].append(float(opt.param_groups[0]["lr"]))
            opt.step()
    check(all(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-12)
              for a, b in zip(lrs["cuda"], lrs["cpu"])), f"lr schedules differ: {lrs}")
    print("zero-valid batch on the card: a no-op ok; warmup-cosine lr on the card "
          "equals the CPU's over 12 steps ok")


def counters() -> dict[str, tuple]:
    """Every kernel's launchers by the kernel's name; each counts its
    launches in ``.launches``. BN1 and BN2 also launch from one call of
    ``bn_relu_forward`` (BN1 with the epilogue in its second pass), BN3 and
    BN4 from one of ``bn_relu_backward``; BNE is that second pass alone, the
    epilogue after a group's all-reduce; CV and CVB are PSMNet's cost volume,
    forward and backward; G and GR the zero-valid gate's snapshot and
    restore, once each a train step."""
    return {"GM": (gray_means_cuda,), "K1": (pointwise_chain_cuda,),
            "K2": (pool.maxpool2x2_fwd_cuda,), "K3": (pool.maxpool2x2_bwd_cuda,),
            "BN1": (batchnorm.bn_stats_cuda, batchnorm.bn_relu_forward_cuda),
            "BN2": (batchnorm.bn_relu_fwd_cuda, batchnorm.bn_relu_forward_cuda),
            "BN3": (batchnorm.bn_relu_bwd_sums_cuda, batchnorm.bn_relu_backward_cuda),
            "BN4": (batchnorm.bn_relu_bwd_dx_cuda, batchnorm.bn_relu_backward_cuda),
            "BNE": (batchnorm.bn_moments_cuda, batchnorm.bn_bwd_coefficients_cuda),
            "CV": (cost_volume.cost_volume_fwd_cuda,),
            "CVB": (cost_volume.cost_volume_bwd_cuda,),
            "G": (gate.gate_snapshot_cuda,), "GR": (gate.gate_restore_cuda,)}


def sync_source(stack: traceback.StackSummary) -> str:
    """Where a host synchronisation came from: the innermost frame in this
    repository (relative path, line, function), then the innermost frame
    of the stack (the library call that synchronised)."""
    root = Path(__file__).resolve().parent
    frames = [f for f in stack if Path(f.filename).is_file()
              and Path(f.filename).name != "warnings.py"]
    ours = [f for f in frames if Path(f.filename).resolve().is_relative_to(root)
            and Path(f.filename).name != "chip_smoke.py"]
    where = ours[-1] if ours else frames[-1]
    inner = frames[-1]
    return (f"{Path(where.filename).resolve().relative_to(root) if ours else where.filename}:"
            f"{where.lineno} {where.name} (in {Path(inner.filename).name}:{inner.lineno} "
            f"{inner.name})")


def phase_train_loop(images: torch.Tensor, targets: torch.Tensor) -> dict:
    """The K-step loop (``make_device_data_train_loop``) at the main path's
    setting: one call of LOOP_STEPS steps under
    ``torch.cuda.set_sync_debug_mode("warn")``, after one step of warm-up
    (first allocations). Counts the host synchronisations it warns of and
    names each one's source line; checks the launches and the stacked
    LossStats."""
    model = seeded_model(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    loop = make_device_data_train_loop(images, targets, BATCH, AugmentConfig(),
                                       steps_per_call=LOOP_STEPS)
    loop.step(state)
    torch.cuda.synchronize()
    reset_counts()
    syncs: list[str] = []
    notices: list[str] = []

    def record(message, category, filename, lineno, file=None, line=None) -> None:
        # The mode's own one-time notice (that it is a prototype that does
        # not see every sync), given by set_sync_debug_mode itself, also
        # speaks of synchronizing operations: it is printed, not counted.
        if "synchroniz" in str(message).lower():
            stack = traceback.extract_stack()[:-1]
            notice = any(f.name == "set_sync_debug_mode" for f in stack)
            (notices if notice else syncs).append(sync_source(stack))

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, stats = loop(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    run_counts = counts()
    k = LOOP_STEPS
    check(run_counts == expect_launches(**train_launches(k)),
          f"K-step loop launches {run_counts}")
    check(all(tuple(s.shape) == (k,) for s in stats), "K-step loop stats are not (K,)")
    losses = [metrics_from_stats(LossStats(*(f[i] for f in stats)))["loss"] for i in range(k)]
    check(all(math.isfinite(x) for x in losses), f"K-step loop losses {losses}")
    sources = sorted(set(syncs))
    print(f"train loop: make_device_data_train_loop, {k} steps in one call (base 32 bf16, "
          f"batch {BATCH}, {HW[0]}x{HW[1]}, augmented): host synchronisations under "
          f"set_sync_debug_mode('warn') {len(syncs)}"
          + (f" at {'; '.join(sources)}" if sources else "")
          + f" (the mode's own one-time notice: {len(notices)})"
          + f"; the call enqueued in {enqueue_s:.3f} s and ran in {call_s:.3f} s "
          f"({1e3 * call_s / k:.2f} ms/step); stats (K,) on the device, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches {run_counts} ok ({card()})")
    return {"syncs": len(syncs), "sources": sources, "ms_step": 1e3 * call_s / k,
            "counts": run_counts}


def phase_codec_check() -> None:
    """The tensor codec on the card against the numpy one: every uint8 RGB
    triple decoded, and disparities (uniform, and the decoded codes) encoded,
    bitwise."""
    codes = np.arange(1 << 24, dtype=np.int64)  # every (R, G, B) of uint8
    rgb = np.stack([codes >> 16, (codes >> 8) & 255, codes & 255], -1).astype(np.uint8)
    got = codec.disparity_decode(torch.from_numpy(rgb).cuda()).cpu().numpy()
    want = codec.disparity_decode_np(rgb)
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
          f"decode differs from numpy at {int((got != want).sum())} codes")
    disparity = np.concatenate([
        np.random.default_rng(13).uniform(0.0, 400.0, 1_000_000).astype(np.float32), want])
    got = codec.disparity_encode(torch.from_numpy(disparity).cuda()).cpu().numpy()
    check(np.array_equal(got, codec.disparity_encode_np(disparity)),
          "encode differs from numpy")
    print(f"codec: disparity_decode on the card bitwise equal to disparity_decode_np on all "
          f"{len(codes)} RGB triples, disparity_encode to disparity_encode_np on "
          f"{len(disparity)} disparities ok")


def seeded_model(**kwargs) -> StereoUNet:
    """A ``StereoUNet(**kwargs)`` with every conv and transposed-conv weight
    and bias drawn as PyTorch's own layers draw them, U(+-1/sqrt(fan_in))
    with fan_in = ``weight.shape[1] * kh * kw``, from seed 0 on the CPU: the
    weights every limit of the phases that build their own model was
    measured on. A fresh model of the port draws the JAX package's init
    (``phase_init``; the trainer's phases run on it)."""
    model = StereoUNet(**kwargs)
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(module.weight[0].numel())
                for p in (module.weight, module.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model


# The fresh-init check: a weight's std * sqrt(fan_in) within INIT_STD_TOL of
# 1.0 where it has at least INIT_LARGE elements (up1 at base 32), within
# INIT_SMALL_TOL for enc1's first conv (1,728 elements); |w| * sqrt(fan_in) at
# most INIT_TRUNCATION (2 / 0.87962566, flax's lecun_normal truncation).
INIT_LARGE = 8192
INIT_STD_TOL = 0.03
INIT_SMALL_TOL = 0.10
INIT_TRUNCATION = 2.2737


def phase_init() -> None:
    """A fresh model built as the trainer builds it (base 32, bf16, seed 42,
    on the card) holds the JAX package's initialisers: truncated LeCun-normal
    kernels, zero biases, fresh BatchNorm; and equals, bitwise, the model
    built on the CPU from the same seed."""
    def build(device: str) -> dict[str, torch.Tensor]:
        model = StereoUNet(base_channels=32, compute_dtype=torch.bfloat16, device=device,
                           generator=torch.Generator().manual_seed(42))
        return model.state_dict()

    on_card, on_cpu = build("cuda"), build("cpu")
    check(all(v.device.type == "cuda" for v in on_card.values()), "fresh model not on the card")
    check(on_card.keys() == on_cpu.keys(), "fresh model keys differ from the CPU model's")
    unequal = [k for k in on_cpu if not torch.equal(on_card[k].cpu(), on_cpu[k])]
    check(not unequal, f"fresh model on the card differs from the CPU model at {unequal}")
    stds, peaks, small = [], [], []
    for key, value in on_card.items():
        w = value.double()
        if w.ndim == 4:
            transposed = key.split(".")[0].startswith("up")
            fan_in = w.shape[0 if transposed else 1] * w.shape[2] * w.shape[3]
            std = float(w.std()) * math.sqrt(fan_in)
            peak = float(w.abs().max()) * math.sqrt(fan_in)
            peaks.append(peak)
            check(peak <= INIT_TRUNCATION, f"{key}: max |w| * sqrt(fan_in) {peak:.5f}")
            if w.numel() >= INIT_LARGE:
                stds.append(std)
                check(abs(std - 1.0) <= INIT_STD_TOL, f"{key}: std * sqrt(fan_in) {std:.5f}")
            elif key == "enc1.block.0.weight":
                small.append(std)
                check(abs(std - 1.0) <= INIT_SMALL_TOL, f"{key}: std * sqrt(fan_in) {std:.5f}")
        elif key.endswith((".bias", "running_mean")):
            check(not w.any(), f"{key} is not 0")
        elif key.endswith(("running_var", ".weight")):
            check(bool((w == 1).all()), f"{key} is not 1")
    check(len(stds) == 21 and len(small) == 1, f"{len(stds)} large weights, {len(small)} small")
    biases = [k for k in on_card if k.endswith(".bias")]
    print(f"init: StereoUNet base 32 bf16 seed 42 on the card: {len(peaks)} weights, std * "
          f"sqrt(fan_in) {min(stds):.4f}-{max(stds):.4f} over the {len(stds)} of at least "
          f"{INIT_LARGE} elements (limit 1 +- {INIT_STD_TOL}), enc1's first conv "
          f"{small[0]:.4f} (1 +- {INIT_SMALL_TOL}); max |w| * sqrt(fan_in) "
          f"{min(peaks):.4f}-{max(peaks):.4f} (at most {INIT_TRUNCATION}); {len(biases)} "
          f"biases all 0; BatchNorm weight 1, running mean 0, var 1; bitwise equal to the "
          f"model built on the CPU from the same seed ok")


def launcher_counts() -> dict[object, int]:
    """Each launcher's count, for ``restore_counts``."""
    return {k: k.launches for kernels in counters().values() for k in kernels}


def reset_counts() -> None:
    restore_counts(dict.fromkeys(launcher_counts(), 0))


def restore_counts(saved: dict[object, int]) -> None:
    for kernel, launches in saved.items():
        kernel.launches = launches


def counts() -> dict[str, int]:
    return {name: sum(k.launches for k in kernels) for name, kernels in counters().items()}


def expect_launches(**nonzero: int) -> dict[str, int]:
    """Expected counts: ``nonzero`` and 0 for every other kernel."""
    return {**dict.fromkeys(counters(), 0), **nonzero}


def bn_launches(per_step: int, group: bool = False) -> dict[str, int]:
    """BN1-BN4 each ``per_step`` times; with a group of several ranks also
    the epilogue twice as often (after the forward's and the backward's
    all-reduce)."""
    return {**dict.fromkeys(BN_NAMES, per_step), **({"BNE": 2 * per_step} if group else {})}


def gate_launches(steps: int) -> dict[str, int]:
    """The zero-valid gate's snapshot and restore, once each a train step."""
    return {"G": steps, "GR": steps}


def train_launches(steps: int) -> dict[str, int]:
    """One rank's training steps: the gray means, K1, 4 K2 and 4 K3, the
    18 BatchNorms' BN1-BN4 and the gate's two launches, a step."""
    return {"GM": steps, "K1": steps, "K2": 4 * steps, "K3": 4 * steps,
            **bn_launches(18 * steps), **gate_launches(steps)}


def phase_train(state, runner) -> tuple[float, list[LossStats]]:
    for _ in range(WARMUP):
        runner(state)
    torch.cuda.synchronize()
    reset_counts()  # counts from here are the main path's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    stats = []
    start.record()
    for _ in range(STEPS):
        state, s = runner(state)
        stats.append(s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / STEPS, stats


KERNEL_GROUPS = (  # first match names a device kernel's group
    ("augment gray means", ("gray_means_kernel",)),
    ("K1 augment", ("augment_kernel",)),
    ("K2 max pool fwd", ("maxpool2x2_fwd",)),
    ("K3 max pool bwd", ("maxpool2x2_bwd",)),
    ("BN1-BN4", ("bn_stats_partial", "bn_bwd_sums_partial", "bn_sums_final", "bn_relu_")),
    # Inductor's generated kernels (the compiled step): BatchNorm, ReLU and
    # the elementwise passes fused; before "batchnorm", which their names hold.
    ("inductor triton", ("triton_",)),
    ("batchnorm", ("batch_norm",)),
    ("conv", ("conv", "gemm", "xmma", "dgrad", "wgrad", "cudnn", "cutlass", "sm90_")),
    ("max pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("relu", ("threshold", "clamp_min")),
)


def profile_kernels(run, reps: int) -> tuple[list[tuple[float, int, str]], float]:
    """(device us, launches, name) of every kernel that ``reps`` calls of
    ``run`` launch (torch.profiler), largest first, and the profiled
    window's wall time in us. One more call of ``run`` goes first, in the
    profiler's warm-up step, whose records are dropped: a window that
    starts the tracing itself may lose the first kernels it launches (on
    an H100 once a K2 of five live frames: 19 of 20)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    rows = []
    for e in prof.key_averages():
        # The schedule's step is also an annotation on the device's timeline.
        if e.device_type != DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    return rows, window_us


def phase_profile(runner, state, label: str = "profile") -> None:
    """Device time by kernel over one step (torch.profiler, after one in its
    warm-up), grouped, and the device's busy share of the profiled window;
    lines start with ``label``."""
    rows, window_us = profile_kernels(lambda: runner(state), 1)
    total = sum(r[0] for r in rows)
    if total <= 0:
        print(f"{label}: torch.profiler recorded no device kernel time")
        return
    print(f"{label} (1 step after 1 in the profiler's warm-up): kernels {total / 1e3:.2f} "
          f"ms/step of a {window_us / 1e3:.2f} ms/step window, device busy "
          f"{100 * total / window_us:.1f}%; {sum(r[1] for r in rows)} device operations a "
          f"step (kernels, copies and sets)")
    groups: dict[str, float] = {}
    for dev, _, key in rows:
        name = next((g for g, subs in KERNEL_GROUPS if any(s in key for s in subs)), "other")
        groups[name] = groups.get(name, 0.0) + dev
    print(f"{label}: by group " + ", ".join(
        f"{g} {t / 1e3:.2f} ms ({100 * t / total:.1f}%)"
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    for dev, count, key in rows[:10]:
        print(f"{label}:   {dev / 1e3:8.3f} ms/step  {100 * dev / total:5.1f}%  "
              f"x{count:<4d} {key[:80]}")


def graph_count() -> int:
    """Dynamo's count of the graphs this process compiled."""
    from torch._dynamo.utils import counters

    return int(counters["stats"]["unique_graphs"])


def compiled_main_path(images: torch.Tensor, targets: torch.Tensor):
    """The main path's state and runner with the model compiled as the
    trainer's ``--compile`` compiles it (Inductor, mode default, fullgraph),
    after its first step: that step's seconds (the compile) and the graphs it
    made."""
    model = seeded_model(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0,
                               compile=CompileOptions())
    runner = make_device_data_train_step(images, targets, BATCH, AugmentConfig())
    graphs = graph_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(state)
    torch.cuda.synchronize()
    return state, runner, time.perf_counter() - t0, graph_count() - graphs


def compiled_vs_eager_step(state: TrainState, runner) -> dict:
    """One step's LossStats and gradients through the compiled model and
    through an eager model with its weights, on one augmented batch of the
    main path (bf16, so the compiled graph is the one already made): the
    largest relative LossStats gap, the largest leaf gap (largest_leaf_gap)
    and its leaf."""
    batch = runner.gather(state)
    inputs = augment_stereo_batch_fused(state.generator, batch["input"], AugmentConfig(),
                                        out_dtype=torch.bfloat16)
    target, mask = train_step._targets_and_mask(batch)
    eager = StereoUNet(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    eager.load_state_dict(state.model.state_dict())
    out = {}
    for name, forward, model in (("compiled", state.compiled, state.model),
                                 ("eager", eager, eager)):
        model.train()
        model.zero_grad(set_to_none=True)
        disp, logvar = forward(inputs, return_uncertainty=True)
        loss, stats = heteroscedastic_laplace_nll(disp[..., 0], logvar[..., 0], target, mask)
        loss.backward()
        out[name] = ([float(s) for s in stats],
                     {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
    (stats_c, grads_c), (stats_e, grads_e) = out["compiled"], out["eager"]
    gap, leaf = largest_leaf_gap(grads_e, grads_c)
    stats_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(stats_c, stats_e))
    return {"stats_gap": stats_gap, "grad_gap": gap, "leaf": leaf, "nll_sum": stats_c[0],
            "eager_nll_sum": stats_e[0]}


def phase_compiled(images: torch.Tensor, targets: torch.Tensor, eager_ms: float) -> dict:
    """The compiled main path at full width: the cold compile, 5 steps after
    warm-up beside the eager figure, the kernels' launches inside the graph,
    graphs and recompiles, the profile, and one step against eager."""
    torch.cuda.reset_peak_memory_stats()
    state, runner, cold_s, graphs = compiled_main_path(images, targets)
    check(graphs == 1, f"the compiled model made {graphs} graphs, expected 1 (fullgraph)")
    before = graph_count()
    ms_step, stats = phase_train(state, runner)
    launches = counts()
    recompiles = graph_count() - before
    expected = expect_launches(**train_launches(STEPS))
    check(launches == expected, f"compiled step launches {launches} in {STEPS} steps, "
          f"expected {expected}: a kernel ran outside the graph or was decomposed")
    check(recompiles == 0, f"the compiled step recompiled {recompiles} times")
    losses = [metrics_from_stats(s)["loss"] for s in stats]
    check(all(math.isfinite(x) for x in losses), f"compiled step: non-finite losses {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train compiled: StereoUNet base 32 bf16, batch {BATCH}, {HW[0]}x{HW[1]}, torch."
          f"compile (Inductor, mode default, fullgraph): first call {cold_s:.1f} s (the cold "
          f"compile, fresh Inductor and Triton caches); {STEPS} steps after {1 + WARMUP} "
          f"warm-up: {ms_step:.2f} ms/step, {BATCH * 1e3 / ms_step:.1f} pairs/s (eager "
          f"\"train:\" {eager_ms:.2f} ms/step in this call: {eager_ms / ms_step:.3f}x); graphs "
          f"{graphs}, recompiles {recompiles}; kernel launches gray means {launches['GM']} K1 "
          f"{launches['K1']} K2 {launches['K2']} K3 {launches['K3']} BN1-BN4 "
          f"{'/'.join(str(launches[n]) for n in BN_NAMES)} (custom ops inside the "
          f"graph); losses {', '.join(f'{x:.4f}' for x in losses)}; peak memory "
          f"{peak_gib:.2f} GiB")
    phase_profile(runner, state, "profile compiled")
    gaps = compiled_vs_eager_step(state, runner)
    check(graph_count() == before, "the compiled-vs-eager step compiled another graph")
    check(gaps["stats_gap"] <= COMPILED_STATS_RTOL,
          f"compiled vs eager: LossStats differ by {gaps['stats_gap']:.3g}")
    check(gaps["grad_gap"] <= COMPILED_GRAD_RTOL,
          f"compiled vs eager: gradient of {gaps['leaf']} differs by {gaps['grad_gap']:.3g} "
          "of its norm")
    print(f"train compiled: one step from the same weights on the same augmented batch, "
          f"compiled vs eager: LossStats within {gaps['stats_gap']:.3g} (tol "
          f"{COMPILED_STATS_RTOL:g}; nll_sum {gaps['nll_sum']:.6g} vs "
          f"{gaps['eager_nll_sum']:.6g}); gradients within {gaps['grad_gap']:.3g} of their "
          f"norm (largest in {gaps['leaf']}; tol {COMPILED_GRAD_RTOL:g}) ok")
    return {"cold_s": cold_s, "ms_step": ms_step, "launches": launches, "peak_gib": peak_gib,
            **gaps}


def compile_cache_argv(tmp: Path, name: str) -> list[str]:
    """The trainer CLI with --compile and the compile cache at the main
    path's shape (base 32, bf16, batch 128, 240x320) on the trainer phase's
    dataset: one step an epoch (pinned), one validation batch, previews."""
    return trainer_argv(tmp, "--epochs", "1", "--batch-size", str(BATCH), "--compile",
                        "--aot-cache", str(tmp / "aot"),
                        "--mlflow-tracking-uri", str(tmp / f"{name}_mlruns"),
                        "--output-dir", str(tmp / f"{name}_outputs"))


def compile_cache_child(tmp_dir: str) -> None:
    """The second process of the compile-cache check (``python -c``, from
    the repository root, with empty Inductor and Triton caches of its own):
    the trainer CLI as the first ran it; prints one RESULT line."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() runs the first
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary, run_counts, seconds = counted(trainer.main,
                                           compile_cache_argv(Path(tmp_dir), "second"))
    print("RESULT " + json.dumps({"cache": summary["compile_cache"], "counts": run_counts,
                                  "seconds": seconds, "wall": time.perf_counter() - t0,
                                  "epochs": summary["epochs"]}), flush=True)


def phase_compile_cache(tmp: Path, caches: Path) -> dict:
    """The trainer CLI with ``--compile --aot-cache <dir>`` in this process
    (Inductor's caches warm from the compiled main path: it fills the blob),
    then in a child process whose Inductor and Triton caches are empty: it
    must load every graph from the blob (source ``aot-cache``, FX-graph cache
    hits, no miss)."""
    torch._dynamo.reset()  # the trainer traces and looks its graphs up itself
    first, first_counts, first_s = counted(trainer.main, compile_cache_argv(tmp, "first"))
    steps = 1  # 144 train samples pinned at batch 128
    expected = expect_launches(GM=steps, K1=steps, K2=4 * (steps + 1 + 1), K3=4 * steps,
                               **bn_launches(18 * steps), **gate_launches(steps))
    check(first_counts == expected, f"compiled trainer launches {first_counts}, expected "
          f"{expected}")
    check(all(first["compile_cache"][k]["source"] == "compiled"
              for k in ("train step", "eval step")),
          f"first process compile cache {first['compile_cache']}")
    check(len(list((tmp / "aot").glob("aot_*.bin"))) == 1, "no compile-cache blob written")
    env = dict(os.environ)
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor_child"),
                     ("TRITON_CACHE_DIR", "triton_child")):
        (caches / sub).mkdir()
        env[var] = str(caches / sub)
    t0 = time.perf_counter()
    [(line, _)] = run_process_farm(
        "import sys, chip_smoke; chip_smoke.compile_cache_child(sys.argv[1])",
        lambda i: [str(tmp)], num_processes=1, timeout=900,
        cwd=str(Path(__file__).resolve().parent), env=env)
    child_s = time.perf_counter() - t0
    second = json.loads(line)
    check(second["counts"] == expected, f"second process launches {second['counts']}")
    for label, report in second["cache"].items():
        check(report["source"] == "aot-cache" and report["fxgraph_cache_hit"] > 0
              and report["fxgraph_cache_miss"] == 0,
              f"second process {label}: {report} (expected every graph from the blob)")
    check(set(second["cache"]) == {"train step", "eval step"}, f"{second['cache']}")
    mae = [run["epochs"][0]["train_mae"] for run in (first, second)]
    check(all(math.isfinite(m) for m in mae), f"compiled trainer train_mae {mae}")
    blob = next((tmp / "aot").glob("aot_*.bin"))

    def report(cache: dict) -> str:
        return "; ".join(f"{label} {r['seconds']:.1f} s ({r['source']}, FX-graph cache hits "
                         f"{r['fxgraph_cache_hit']}, misses {r['fxgraph_cache_miss']})"
                         for label, r in cache.items())

    print(f"compile cache: trainer CLI --compile --aot-cache <dir>, base 32 bf16, batch "
          f"{BATCH}, {HW[0]}x{HW[1]}, 1 epoch: this process (Inductor's caches warm from the "
          f"compiled main path; Dynamo reset) {report(first['compile_cache'])}, {first_s:.1f} "
          f"s in all, "
          f"wrote {blob.stat().st_size / 1e6:.1f} MB; a second process with empty Inductor "
          f"and Triton caches {report(second['cache'])}, its trainer {second['seconds']:.1f} s, "
          f"{child_s:.1f} s with its start; launches {second['counts']} in each ok")
    return {"first": first["compile_cache"], "second": second["cache"], "child_s": child_s}


def fresh_compile_caches() -> Path:
    """Inductor's and Triton's caches in a new directory under build/ for
    this run (a cold compile is cold); the caller removes it."""
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="compile_caches_", dir=_build.BUILD_DIR.parent))
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        (root / sub).mkdir()
        os.environ[var] = str(root / sub)
    return root


# PSMNet (models/psmnet.py) at its published size: batch 12 of 256x512 crops,
# max disparity 192, so the cost volume is (12, 64, 48, 64, 128) from (12, 32,
# 64, 128) features a view.
PSM_BATCH = 12
PSM_HW = (256, 512)
PSM_DISPARITY = 192
PSM_STEPS = 5
# The cost-volume kernel against its plain version: (N, H/4, W/4, C), D, dtype.
# The published shape in bf16; W/4 < D; C = 4 in bf16 (one channel a thread);
# C = 12 in float32 (three 16-byte groups).
CV_CASES = [((12, 64, 128, 32), 48, torch.bfloat16), ((2, 16, 40, 32), 48, torch.float32),
            ((3, 8, 20, 4), 7, torch.bfloat16), ((2, 8, 24, 12), 5, torch.float32)]
# The forward copies: bitwise its plain version. The backward's sums over d
# (at most 48 terms, f32) run in another order than the plain version's and
# round to bf16 once: within one bf16 spacing (2^-8 of the value) in bf16,
# float32 round-off in float32, as shares of the largest |dleft|, |dright|.
CV_BWD_RTOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
# One full-width float32 forward and backward of the port against the
# published model in float32 on the card (TF32 off), from the same weights and
# batch: outputs and loss agree to float32 round-off through 2 x 60 2D and 25
# 3D BatchNorms (measured 1e-6-1e-5 of the scale on the CPU at channels 4);
# a leaf's gradient norm to 2e-2: cuDNN's algorithms sum in other orders
# than the published model's, and the batch-statistic backward through the
# deep stack magnifies that noise in a BatchNorm weight's gradient (measured
# 0.4% on an H100), as in the StereoUNet's 'Card vs CPU in f32'.
PSM_OUT_RTOL = 1e-4
PSM_GRAD_RTOL = 2e-2
# The bf16 train step's first outputs against the published model in float32
# (TF32 off) on the batch the step augmented, from the same weights, in
# disparities: the largest mean |gap| of the three outputs, and the largest
# |mean gap|. The limits of the benchmark's PSMNet cell, set from its readings
# on an H100: bf16 reads 4.3-5.9 and 0.013-0.18, the reference's own fp8
# convolutions 26.6-29.1 and 0.65-2.15.
PSM_BF16_MAE = 12.5
PSM_BF16_BIAS = 0.6


def published_cost_volume(left: torch.Tensor, right: torch.Tensor, depth: int) -> torch.Tensor:
    """The published loop of slice copies (models/stackhourglass.py) on (N, C,
    H, W) features: PyTorch's own way to build the volume, the yardstick."""
    n, c, h, w = left.shape
    cost = left.new_zeros((n, 2 * c, depth, h, w))
    for i in range(depth):
        cost[:, :c, i, :, i:] = left[:, :, :, i:]
        cost[:, c:, i, :, i:] = right[:, :, :, :w - i]
    return cost


def phase_cost_volume() -> dict:
    """The cost-volume kernel (csrc/cost_volume.cu) against its plain version
    at CV_CASES, then timed at the published shape against its byte bound,
    its plain version and the published slice loop."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for (n, h, w, c), depth, dtype in CV_CASES:
        left = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
        right = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
        got = cost_volume.cost_volume_fwd_cuda(left, right, depth)
        want = cost_volume.cost_volume_fwd_plain(left, right, depth)
        check(torch.equal(got, want), f"cost volume forward {(n, h, w, c)} D={depth} {dtype}")
        dv = torch.randn(want.shape, generator=gen, device="cuda").to(dtype)
        for got_g, want_g in zip(cost_volume.cost_volume_bwd_cuda(dv, c),
                                 cost_volume.cost_volume_bwd_plain(dv, c)):
            gap = float((got_g.float() - want_g.float()).abs().max()
                        / want_g.float().abs().max().clamp(min=1e-30))
            check(gap <= CV_BWD_RTOL[dtype],
                  f"cost volume backward {(n, h, w, c)} D={depth} {dtype}: {gap:.3g}")
            worst["bwd"] = max(worst["bwd"], gap)
        again = cost_volume.cost_volume_bwd_cuda(dv, c)
        check(all(torch.equal(a, b) for a, b in zip(again, cost_volume.cost_volume_bwd_cuda(
            dv, c))), "cost volume backward repeatable")
    print(f"cost volume check: forward bitwise its plain version in {len(CV_CASES)} cases "
          f"(published bf16 shape, W/4 < D, C = 4 bf16, C = 12 f32); backward within "
          f"{worst['bwd']:.3g} of the largest gradient (limits {CV_BWD_RTOL[torch.bfloat16]} "
          f"bf16, {CV_BWD_RTOL[torch.float32]} f32), repeatable bitwise")

    (n, h, w, c), depth, dtype = CV_CASES[0]
    left = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    right = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    dv = torch.randn((n, depth, h, w, 2 * c), generator=gen, device="cuda").to(dtype)
    nbytes = n * 2 * (2 * c * depth * h * w + 2 * c * h * w)  # one way, bf16
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    nchw = [t.permute(0, 3, 1, 2).requires_grad_() for t in (left.clone(), right.clone())]
    loop_out = published_cost_volume(*nchw, depth)
    loop_grad = dv.permute(0, 4, 1, 2, 3)
    times = {
        "fwd": (time_ms(lambda: cost_volume.cost_volume_fwd_cuda(left, right, depth), 20),
                time_ms(lambda: cost_volume.cost_volume_fwd_plain(left, right, depth), 3),
                time_ms(lambda: published_cost_volume(*nchw, depth), 5)),
        "bwd": (time_ms(lambda: cost_volume.cost_volume_bwd_cuda(dv, c), 20),
                time_ms(lambda: cost_volume.cost_volume_bwd_plain(dv, c), 3),
                time_ms(lambda: torch.autograd.grad(loop_out, nchw, loop_grad,
                                                    retain_graph=True), 5)),
    }
    out = {}
    for way, (ms, plain_ms, library_ms) in times.items():
        out[way] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "max_abs_err": worst[way]}
        print(f"cost volume timing {way}: (12, 64, 128, 32) bf16 features, D {depth}: kernel "
              f"{ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB), "
              f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms * 1e3:.1f} us; the "
              f"published slice loop {library_ms * 1e3:.1f} us")
    return out


def psmnet_reference_module():
    """``tests/psmnet_reference.py``, the published model in plain torch.nn."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "psmnet_reference.py"
    spec = importlib.util.spec_from_file_location("psmnet_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_psmnet() -> dict:
    """PSMNet at full width: one float32 forward and backward of batch 2
    against the published model (float32 on the card, TF32 off); then the
    bf16 train step at its published size (batch 12, 256x512, D 192) over a
    device-resident payload: ms a step, launches, peak memory, and the
    kernels by device time."""
    reference = psmnet_reference_module()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    h, w = PSM_HW
    torch.manual_seed(0)
    published = reference.PSMNet(PSM_DISPARITY, 32).cuda()
    port = PSMNet(max_disparity=PSM_DISPARITY, device="cuda")
    port.load_state_dict(published.state_dict())
    x = torch.rand((2, h, w, 6), generator=gen, device="cuda")
    target = torch.rand((2, h, w), generator=gen, device="cuda") * PSM_DISPARITY
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = published(x)
        want_loss = reference.loss(want, target, PSM_DISPARITY)
        want_loss.backward()
        got = port(x)
        got_loss, _ = port.step_loss(got, target, target > 0)
        got_loss.backward()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    out_gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
    loss_gap = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    ref_grads = dict(published.named_parameters())
    grad_gap, leaf = max(
        (abs(float(p.grad.norm()) - float(ref_grads[n].grad.norm()))
         / max(float(ref_grads[n].grad.norm()), 1e-30), n)
        for n, p in port.named_parameters())
    check(out_gap <= PSM_OUT_RTOL and loss_gap <= PSM_OUT_RTOL,
          f"PSMNet f32 outputs {out_gap:.3g}, loss {loss_gap:.3g} against the published model")
    check(grad_gap <= PSM_GRAD_RTOL, f"PSMNet f32 leaf gradient {leaf} {grad_gap:.3g}")
    print(f"psmnet check: full width (channels 32, 5,224,768 parameters) float32 batch 2 at "
          f"{h}x{w}, D {PSM_DISPARITY}, against the published model on the card (TF32 off): "
          f"outputs {out_gap:.3g}, loss {loss_gap:.3g} (limit {PSM_OUT_RTOL}), worst leaf "
          f"gradient norm {grad_gap:.3g} at {leaf} (limit {PSM_GRAD_RTOL})")
    del published, port, want, got, want_loss, got_loss

    payload = 4 * PSM_BATCH
    images = torch.randint(0, 256, (payload, h, w, 6), dtype=torch.uint8, device="cuda",
                           generator=gen)
    targets = torch.rand((payload, h, w), device="cuda", generator=gen) * PSM_DISPARITY
    model = PSMNet(max_disparity=PSM_DISPARITY, compute_dtype=torch.bfloat16, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 0.0), seed=0)
    runner = make_device_data_train_step(images, targets, PSM_BATCH, AugmentConfig())
    published = reference.PSMNet(PSM_DISPARITY, 32).cuda()
    published.load_state_dict(model.state_dict())
    seen = {}

    def keep(module, args, outputs) -> None:
        if not seen:
            seen.update(x=args[0].detach().clone(), preds=[o.detach() for o in outputs])

    hook = model.register_forward_hook(keep)
    runner(state)
    hook.remove()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = published(seen["x"].float())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    gaps = [g.float() - w for g, w in zip(seen["preds"], want)]
    mae = max(float(d.abs().mean()) for d in gaps)
    bias = max(abs(float(d.mean())) for d in gaps)
    check(mae <= PSM_BF16_MAE and bias <= PSM_BF16_BIAS,
          f"PSMNet bf16 step's outputs against the float32 model: mean |gap| {mae:.3g}, "
          f"|mean gap| {bias:.3g}")
    print(f"psmnet bf16 check: the train step's first outputs (batch {PSM_BATCH}, {h}x{w}, "
          f"augmented) against the published model in float32 (TF32 off) on its batch: "
          f"largest mean |gap| {mae:.3f} disparities (limit {PSM_BF16_MAE}), largest "
          f"|mean gap| {bias:.4f} (limit {PSM_BF16_BIAS})")
    del published, seen, want, gaps
    runner(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stats = [runner(state)[1] for _ in range(PSM_STEPS)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / PSM_STEPS
    got_counts = counts()
    bn2d = sum(type(m).__name__ == "MeshBatchNorm2d" for m in model.modules())
    bn3d = sum(type(m).__name__ == "MeshBatchNorm3d" for m in model.modules())
    per_step = 2 * bn2d + bn3d  # the feature extractor runs once a view
    expected = expect_launches(GM=PSM_STEPS, K1=PSM_STEPS, CV=PSM_STEPS, CVB=PSM_STEPS,
                               **bn_launches(per_step * PSM_STEPS),
                               **gate_launches(PSM_STEPS))
    check(got_counts == expected, f"PSMNet launches {got_counts}, expected {expected}")
    losses = [metrics_from_stats(s)["loss"] for s in stats]
    check(all(math.isfinite(v) for v in losses), f"PSMNet losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    print(f"psmnet train: bf16, batch {PSM_BATCH}, {h}x{w}, D {PSM_DISPARITY}: {ms_step:.2f} "
          f"ms/step, {PSM_BATCH * 1e3 / ms_step:.1f} pairs/s, launches a step: cost volume 1 "
          f"+ 1, BN1-BN4 {per_step} each ({bn2d} 2D BatchNorms x 2 views + {bn3d} 3D), K1 1; "
          f"losses {', '.join(f'{v:.4f}' for v in losses)}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    rows, window_us = profile_kernels(lambda: runner(state), 2)
    total = sum(r[0] for r in rows)
    print(f"psmnet profile: 2 steps, device busy {total / 1e3:.1f} of {window_us / 1e3:.1f} ms; "
          f"the 40 largest kernels:")
    for dev_us, n_calls, name in rows[:40]:
        print(f"psmnet profile:   {dev_us / 2e3:8.3f} ms/step {n_calls // 2:5d}x  {name[:150]}")
    return {"ms_step": ms_step, "launches": got_counts, "peak_bytes": peak}


# The zero-valid gate (csrc/gate.cu) over the full-width gated sets: its
# snapshot and restore against the plain versions, bitwise; timed over
# GATE_REPS launches, the per-tensor loop it replaced and the library's
# multi-tensor copy over fewer.
GATE_REPS = 50
GATE_LOOP_REPS = 5


def gate_sets() -> dict[str, TrainState]:
    """Train states whose gated tensors are a training run's: the StereoUNet
    (base 32, bf16) with AdamW, and PSMNet (channels 32, D 192) with Adam."""
    model = seeded_model(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    states = {"StereoUNet": create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4),
                                               seed=0)}
    model = PSMNet(max_disparity=PSM_DISPARITY, compute_dtype=torch.bfloat16, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    states["PSMNet"] = create_train_state(model, make_adamw(model.parameters(), 1e-3, 0.0),
                                          seed=0)
    return states


def per_tensor_gate(tensors: list[torch.Tensor], valid_count: torch.Tensor) -> None:
    """The gate as the step ran it before the kernels: a clone a tensor,
    then a where and a copy_ a tensor."""
    tensors = [t.detach() for t in tensors]
    snapshot = [t.clone() for t in tensors]
    with torch.no_grad():
        keep = valid_count > 0
        for live, old in zip(tensors, snapshot):
            live.copy_(torch.where(keep, live, old))


def phase_gate() -> dict[str, dict]:
    """The gate's two kernels against the plain versions on the card, over
    each of ``gate_sets``: the snapshot's slots, and the restore at a valid
    count of 1, 0 and NaN from the same scrambled bytes, bitwise, with the
    ``restores`` counter; their times beside the byte bound (the set read
    and written once at 3.35 TB/s), the per-tensor loop's (host clock, a
    synchronise at the end) and ``torch._foreach_copy_``'s, which the port
    never calls. Then five train steps of the StereoUNet, the third on a
    batch with no valid pixel: one snapshot and one restore launch a step,
    one restore counted, one table, and that step a no-op."""
    results = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    for name, state in gate_sets().items():
        tensors = train_step._gated_tensors(state)
        table, twin = gate.build_table(tensors), gate.build_table(tensors)
        nbytes = sum(v.numel() for v in table.live)
        reset_counts()
        gate.gate_snapshot_cuda(table)
        gate.gate_snapshot_plain(twin)
        check(all(torch.equal(a, b) for a, b in zip(table.saved, twin.saved)),
              f"gate {name}: the snapshot kernel's slots differ from the plain version's")
        original = [v.clone() for v in table.live]
        restores = torch.zeros((), dtype=torch.int64, device="cuda")
        plain_restores = torch.zeros_like(restores)
        for count, restored in ((1.0, False), (0.0, True), (math.nan, True)):
            valid = torch.tensor(count, device="cuda")
            for v in table.live:  # what a step might leave: any bytes
                v.copy_(torch.randint(0, 256, v.shape, dtype=torch.uint8, device="cuda",
                                      generator=gen))
            stepped = [v.clone() for v in table.live]
            gate.gate_restore_cuda(table, valid, restores)
            got = [v.clone() for v in table.live]
            for v, b in zip(table.live, stepped):
                v.copy_(b)
            gate.gate_restore_plain(twin, valid, plain_restores)
            want = original if restored else stepped
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"gate {name}: restore at valid count {count} is not the "
                  f"{'snapshot' if restored else 'step'}'s bytes")
            check(all(torch.equal(a, b) for a, b in zip(got, twin.live)),
                  f"gate {name}: restore at valid count {count} differs from the plain version")
            for v, b in zip(table.live, original):
                v.copy_(b)
        check(int(restores) == int(plain_restores) == 2,
              f"gate {name}: restores {int(restores)}, plain {int(plain_restores)}, expected 2")
        check(counts()["G"] == 1 and counts()["GR"] == 3, f"gate {name}: launches {counts()}")
        one = torch.ones((), device="cuda")
        zero = torch.zeros((), device="cuda")
        snapshot_ms = time_ms(lambda: gate.gate_snapshot_cuda(table), GATE_REPS)
        restore_valid_ms = time_ms(lambda: gate.gate_restore_cuda(table, one, restores),
                                   GATE_REPS)
        restore_zero_ms = time_ms(lambda: gate.gate_restore_cuda(table, zero, restores),
                                  GATE_REPS)
        plain_ms = time_ms(lambda: gate.gate_snapshot_plain(table), GATE_LOOP_REPS)
        sources = [t.detach() for t in tensors]
        copies = [t.clone() for t in sources]
        library_ms = time_ms(lambda: torch._foreach_copy_(copies, sources), GATE_REPS)
        del sources, copies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GATE_LOOP_REPS):
            per_tensor_gate(tensors, one)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3 / GATE_LOOP_REPS
        bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        check(all(torch.equal(a, b) for a, b in zip(table.live, original)),
              f"gate {name}: the timing runs changed the state")
        print(f"gate: {name}, {len(tensors)} gated tensors in {table.ranges} ranges, "
              f"{nbytes:,} bytes, {table.chunks} chunks of {gate.CHUNK} on {table.grid} "
              f"blocks: snapshot {1e3 * snapshot_ms:.1f} us (bound {1e3 * bound_ms:.1f} us, "
              f"{100 * bound_ms / snapshot_ms:.1f}%), restore at a valid batch "
              f"{1e3 * restore_valid_ms:.1f} us, restoring {1e3 * restore_zero_ms:.1f} us; "
              f"plain snapshot {plain_ms:.3f} ms; per-tensor clone + where + copy_ "
              f"{loop_ms:.3f} ms a step (host clock); torch._foreach_copy_ "
              f"{1e3 * library_ms:.1f} us; bitwise the plain version at valid count 1, 0 "
              f"and NaN, restores counted 2 ok ({card()})")
        results[name] = {"tensors": len(tensors), "ranges": table.ranges, "bytes": nbytes,
                         "ms": snapshot_ms, "restore_valid_ms": restore_valid_ms,
                         "restore_ms": restore_zero_ms, "plain_ms": plain_ms,
                         "loop_ms": loop_ms, "library_ms": library_ms, "bound_ms": bound_ms}
        del state, tensors, table, twin, original
    torch.cuda.empty_cache()

    model = seeded_model(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    step = make_train_step(AugmentConfig())
    batch = {"input": torch.randint(0, 256, (4, *HW, 6), dtype=torch.uint8, device="cuda",
                                    generator=gen),
             "target": torch.rand((4, *HW), device="cuda", generator=gen) * 63.5 + 0.5}
    empty = {"input": batch["input"], "target": torch.zeros_like(batch["target"])}
    reset_counts()
    for i in range(5):
        if i == 2:
            before = [t.clone() for t in train_step._gated_tensors(state)]
        state, stats = step(state, empty if i == 2 else batch)
        if i == 2:
            check(all(torch.equal(a, b) for a, b in
                      zip(train_step._gated_tensors(state), before)),
                  "gate: the zero-valid step changed the state")
    torch.cuda.synchronize()
    got = {k: counts()[k] for k in ("G", "GR")}
    check(got == {"G": 5, "GR": 5}, f"gate: launches in 5 steps {got}")
    check(int(state.gate.restores) == 1 and state.gate.builds == 1,
          f"gate: {int(state.gate.restores)} restores and {state.gate.builds} tables in 5 "
          "steps with one zero-valid batch")
    print("gate steps: StereoUNet base 32 bf16, batch 4, 5 augmented steps, the third with "
          "no valid pixel: snapshot 5 and restore 5 launches, restores 1, one table, the "
          "zero-valid step a no-op ok")
    return results


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}; cudnn.benchmark on for the main path only")

    caches = fresh_compile_caches()
    try:
        return run_all(caches)
    finally:
        shutil.rmtree(caches, ignore_errors=True)


def run_all(caches: Path) -> int:
    """Every phase (``main`` has checked for CUDA and set the flags)."""
    marks = [("start", time.perf_counter())]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    libs = _build.build_all()
    for lib in libs.values():
        print(f"build: {lib.path.name} in {lib.seconds:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build:   {line.strip()}")
    mark("build")
    print(f"build: total {marks[-1][1] - marks[0][1]:.1f} s")

    errors = phase_kernel_checks()
    gray_mean_err = phase_gray_mean_checks()
    mark("K1 and gray-mean checks")
    phase_pool_checks()
    mark("K2/K3 checks")
    bn_errors = phase_bn_checks()
    mark("BN1-BN4 checks")
    phase_codec_check()
    mark("codec check")
    phase_init()
    mark("fresh-init check")
    phase_reference_step()
    mark("reference step")

    # The main path at full width, as bench.py runs the JAX package, with
    # cuDNN's autotuning on (it times every convolution algorithm at the
    # step's shapes, once, in the warm-up steps).
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    images = torch.randint(0, 256, (PAYLOAD, *HW, 6), dtype=torch.uint8, device="cuda",
                           generator=gen)
    targets = torch.rand((PAYLOAD, *HW), device="cuda", generator=gen) * 63.5 + 0.5
    targets[:, :8] = 0.0  # a band of invalid pixels
    model = seeded_model(base_channels=32, compute_dtype=torch.bfloat16, device="cuda")
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    runner = make_device_data_train_step(images, targets, BATCH, AugmentConfig())
    torch.cuda.reset_peak_memory_stats()
    ms_step, stats = phase_train(state, runner)
    main_counts = counts()
    expected = expect_launches(**train_launches(STEPS))
    check(main_counts == expected,
          f"kernel launches {main_counts} in {STEPS} steps, expected {expected}")
    launches = main_counts["K1"]
    losses = [metrics_from_stats(s)["loss"] for s in stats]
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    print(f"train: StereoUNet base 32 bf16, batch {BATCH}, {HW[0]}x{HW[1]}, payload "
          f"{PAYLOAD} on device, {STEPS} steps after {WARMUP} warm-up: {ms_step:.2f} ms/step, "
          f"{BATCH * 1e3 / ms_step:.1f} pairs/s, kernel launches gray means "
          f"{main_counts['GM']} K1 {main_counts['K1']} K2 "
          f"{main_counts['K2']} K3 {main_counts['K3']} BN1-BN4 "
          f"{'/'.join(str(main_counts[n]) for n in BN_NAMES)}, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (before the pools ran on "
          f"K2/K3: {BEFORE_POOL_KERNELS})")
    mark("main path")
    phase_profile(runner, state)
    mark("profile")

    predict = make_predict_fn(model)
    batch = images[:BATCH]
    ms_predict = time_ms(lambda: predict(batch), 3)
    reset_counts()
    disp, logvar = predict(batch)
    torch.cuda.synchronize()
    predict_counts = counts()
    check(predict_counts == expect_launches(K2=4),
          f"predict launches {predict_counts}, expected K2 4")
    check(tuple(disp.shape) == tuple(logvar.shape) == (BATCH, *HW), "predict shapes")
    check(bool(torch.isfinite(disp).all() and torch.isfinite(logvar).all()), "predict not finite")
    check(float(disp.min()) >= 0.0, "negative disparity")
    check(-6.0 <= float(logvar.min()) and float(logvar.max()) <= 3.0, "logvar out of [-6, 3]")
    print(f"predict: batch {BATCH} {HW[0]}x{HW[1]} bf16 -> disparity/logvar "
          f"{tuple(disp.shape)}, {ms_predict:.2f} ms, disparity in "
          f"[{float(disp.min()):.4f}, {float(disp.max()):.4f}], K2 launches 4 ok")
    del state, runner, model, predict, batch, disp, logvar
    mark("predict")
    loop = phase_train_loop(images, targets)
    mark("K-step loop")
    # The same path compiled, as the trainer's --compile runs it.
    compiled = phase_compiled(images, targets, ms_step)
    mark(f"compiled main path ({compiled['cold_s']:.1f} s the cold compile)")
    knobs = phase_knobs(images, targets)
    del images, targets
    torch.backends.cudnn.benchmark = False
    mark("knobs")

    # The kernel alone at the main path's shape and config (bf16 out).
    cfg = AugmentConfig()
    timing_gen = torch.Generator(device="cuda")
    timing_gen.manual_seed(2)
    x, packed, blur_k = kernel_case(timing_gen, BATCH, *HW, cfg.blur_prob, cfg)
    ms_kernel = time_ms(lambda: pointwise_chain_cuda(x, packed, blur_k, torch.bfloat16), 20)
    ms_plain = time_ms(lambda: pointwise_chain_plain(x, packed, blur_k, torch.bfloat16), 3)
    ms_kernel_f32 = time_ms(lambda: pointwise_chain_cuda(x, packed, blur_k, torch.float32), 20)
    # The same kernel one pixel a thread (2-byte loads, 4-byte stores): the
    # new arithmetic without the 16-byte I/O.
    x_off = misaligned_copy(x)
    ms_one_pixel = time_ms(
        lambda: pointwise_chain_cuda(x_off, packed, blur_k, torch.bfloat16), 20)
    # Without the blur's tiled path (blur_k = 0): the flat path alone; and
    # with every view blurred: the tiled path alone.
    ms_no_blur = time_ms(lambda: pointwise_chain_cuda(x, packed, 0, torch.bfloat16), 20)
    all_blurred = packed.clone()
    all_blurred[:, [6, 14]] = 1.0
    ms_all_blur = time_ms(
        lambda: pointwise_chain_cuda(x, all_blurred, blur_k, torch.bfloat16), 5)
    n, (h, w) = BATCH, HW
    blurred_views = int((packed[:, [6, 14]] > 0).sum())
    nbytes = n * h * w * 6 * (1 + 2) + packed.numel() * 4
    ops = n * h * w * 2 * CHAIN_OPS_PER_PIXEL_VIEW + blurred_views * h * w * 3 * 4 * blur_k
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    f32_bound_ms = (n * h * w * 6 * (1 + 4) + packed.numel() * 4) / HBM_BYTES_PER_S * 1e3
    print(f"kernel timing: {n}x{h}x{w} bf16 out, blur_k={blur_k}, {blurred_views} of {2 * n} "
          f"views blurred: kernel {ms_kernel * 1e3:.1f} us, plain {ms_plain * 1e3:.1f} us, "
          f"bound {bound_ms * 1e3:.1f} us by {bound_by} ({nbytes / 1e6:.1f} MB -> "
          f"{bytes_ms * 1e3:.1f} us; {ops / 1e9:.2f} G ops -> {ops_ms * 1e3:.1f} us), "
          f"{100 * bound_ms / ms_kernel:.1f}% of bound; f32 out {ms_kernel_f32 * 1e3:.1f} us "
          f"(bytes bound {f32_bound_ms * 1e3:.1f} us); one pixel a thread (input off "
          f"16-byte alignment) {ms_one_pixel * 1e3:.1f} us; blur off {ms_no_blur * 1e3:.1f} "
          f"us; every view blurred {ms_all_blur * 1e3:.1f} us; launches per step "
          f"{launches / STEPS:g}")

    kernels = [{
        "name": "augment_pointwise_chain",
        "route": "cuda",
        "source": "stereo_depth_estimation_tpu_torch/csrc/augment.cu",
        "replaces": "stereo_depth_estimation_tpu/ops/augment_pallas.py:177",
        "launches": launches,
        "max_abs_err": errors[(BATCH, *HW, 0.03, torch.bfloat16)],
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this chain
    }]
    del x, x_off, packed, all_blurred

    # The augmentation layer part by part, the gray-mean kernel against its
    # bound: its input read once (and 2N factors in, 2N means out).
    aug = time_augmentation()
    print(f"{describe_augmentation(aug)} (before K1's redesign and the gray-mean "
          f"kernel: {BEFORE_AUGMENT_REDESIGN})")
    gm_bytes = n * h * w * 6 + 4 * n * 4
    gm_bytes_ms = gm_bytes / HBM_BYTES_PER_S * 1e3
    gm_ops_ms = n * h * w * 6 * GRAY_MEAN_OPS_PER_BYTE / F32_FLOPS * 1e3
    gm_bound_ms = max(gm_bytes_ms, gm_ops_ms)
    print(f"gray-mean timing: {n}x{h}x{w}: kernel {aug['pre_pass_kernel'] * 1e3:.1f} us, "
          f"plain {aug['pre_pass_plain'] * 1e3:.1f} us, bound {gm_bound_ms * 1e3:.1f} us "
          f"({gm_bytes / 1e6:.1f} MB -> {gm_bytes_ms * 1e3:.1f} us; ops -> "
          f"{gm_ops_ms * 1e3:.1f} us), {100 * gm_bound_ms / aug['pre_pass_kernel']:.1f}% of "
          f"bound; launches per step {main_counts['GM'] / STEPS:g}")
    kernels.append({
        "name": "augment_gray_means",
        "route": "cuda",
        "source": "stereo_depth_estimation_tpu_torch/csrc/augment.cu",
        "replaces": "stereo_depth_estimation_tpu/ops/augment_pallas.py:213 _pack_factors "
                    "(XLA reduce)",
        "launches": main_counts["GM"],
        "max_abs_err": gray_mean_err,
        "ms": aug["pre_pass_kernel"],
        "plain_ms": aug["pre_pass_plain"],
        "bound_ms": gm_bound_ms,
        "bound_by": "bytes" if gm_bytes_ms >= gm_ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes these means
    })

    mark("augmentation timing")
    pool_times = phase_pool_timing()
    mark("K2/K3 timing")
    bn_times = phase_bn_timing()
    mark("BN1-BN4 timing")
    cv_times = phase_cost_volume()
    mark("cost volume check and timing")
    psm = phase_psmnet()
    mark("PSMNet")
    gate_times = phase_gate()
    mark("gate")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        # The trainer and the serving CLIs as a user runs them, without
        # cuDNN's autotuning (none of them turns it on).
        last_pt = phase_trainer(Path(tmp))
        mark("trainer")
        convergence = phase_convergence(Path(tmp))
        mark("convergence")
        serving_k2 = phase_serving(Path(tmp), last_pt)
        mark("serving")
        multi_rank = phase_multi_rank(Path(tmp))
        mark("multi-rank")
        spatial = phase_spatial(Path(tmp))
        mark("spatial")
        cache = phase_compile_cache(Path(tmp), caches)
        mark("compile cache")
        # After the trainer's compile cache: a process saves, at each save,
        # only the artifacts recorded since its last one (parallel/
        # aot_cache.py), so the serving blobs come after the trainer's.
        compiled_serving = phase_compiled_serving(Path(tmp), last_pt, caches)
        mark("compiled serving")
    # K2 in float32, as serving runs it, at batch 30 and batch 1.
    serving_pool = {f"batch{n}": phase_pool_timing(SERVE_POOL_SHAPES[n], torch.float32,
                                                   backward=False)["K2"]
                    for n in SERVE_POOL_SHAPES}
    mark("K2 f32 timing")
    print("phases: " + ", ".join(
        f"{name} {t - before:.1f} s" for (_, before), (name, t) in zip(marks, marks[1:]))
        + f"; total {marks[-1][1] - marks[0][1]:.1f} s after the imports; compile: cold "
        f"{compiled['cold_s']:.1f} s, trainer CLI in this process "
        + ", ".join(f"{k} {r['seconds']:.1f} s" for k, r in cache["first"].items())
        + ", in a second process from the blob "
        + ", ".join(f"{k} {r['seconds']:.1f} s" for k, r in cache["second"].items())
        + "; serving compiles cold " + ", ".join(
            f"{k} {v:.1f} s" for k, v in compiled_serving["cold"].items())
        + ", from the blob in a second process " + ", ".join(
            f"{k} {v:.1f} s" for k, v in compiled_serving["from_blob"].items()))

    # K2/K3: sums over the main path's four pool shapes (per-shape figures
    # on the "pool timing:" lines); the library call is F.max_pool2d with
    # indices and its backward, which the port never calls.
    kernels[0]["multi_rank_launches"] = multi_rank["K1"]
    kernels[1]["multi_rank_launches"] = multi_rank["GM"]
    for kernel, name in ((kernels[0], "K1"), (kernels[1], "GM")):
        kernel["spatial_launches"] = {part: spatial[part][name] for part in spatial}
    for name, fn, line in (("K2", "maxpool2x2_fwd", 91), ("K3", "maxpool2x2_bwd", 112)):
        kernels.append({
            "name": fn,
            "route": "cuda",
            "source": "stereo_depth_estimation_tpu_torch/csrc/maxpool.cu",
            "replaces": f"scripts/pool_lab.py:{line}",
            "launches": main_counts[name],
            "bound_by": "bytes",
            **pool_times[name],
            "multi_rank_launches": multi_rank[name],
            "spatial_launches": {part: spatial[part][name] for part in spatial},
        })
    # BN1-BN4: every training BatchNorm (the main path's 18 a step). Times are
    # sums over the main path's 18 BatchNorm inputs (bf16, ReLU on; per-level
    # figures on the "bn timing:" lines); the library call is the PyTorch
    # primitive for the same function (batch_norm_stats, _elemt,
    # _backward_reduce, _backward_elemt), which the port never calls, and
    # cudnn_ms PyTorch's BatchNorm + ReLU forward (BN1, BN2) or backward (BN3,
    # BN4) at the same inputs.
    for name, fn, replaces in BN_KERNELS:
        kernels.append({
            "name": fn,
            "route": "cuda",
            "source": "stereo_depth_estimation_tpu_torch/csrc/batchnorm.cu",
            "replaces": replaces,
            "launches": main_counts[name],
            "max_abs_err": bn_errors[name],
            "bound_by": "bytes",
            **bn_times[name],
            "multi_rank_launches": multi_rank[name],
            "spatial_launches": {part: spatial[part][name] for part in spatial},
        })
    for kernel, name in zip(kernels, ("K1", "GM", "K2", "K3", *BN_NAMES)):
        kernel["convergence_launches"] = {run: c[name] for run, c in convergence.items()}
        kernel["compiled_launches"] = compiled["launches"][name]
        kernel["knob_launches"] = {knob: r["counts"][name] for knob, r in knobs.items()}
        kernel["train_loop_launches"] = loop["counts"][name]
    # The cost volume (PSMNet only): its forward and backward at the
    # published shape, launched once each a PSMNet step; the library call is
    # the published loop of slice copies (and its autograd backward).
    for way, name in (("fwd", "CV"), ("bwd", "CVB")):
        kernels.append({
            "name": f"cost_volume_{way}",
            "route": "cuda",
            "source": "stereo_depth_estimation_tpu_torch/csrc/cost_volume.cu",
            "replaces": "none (PSMNet's published slice loop, models/stackhourglass.py)",
            "launches": psm["launches"][name],
            "bound_by": "bytes",
            **cv_times[way],
        })
    # The zero-valid gate: the snapshot and the restore over each full-width
    # gated set, launched once each a train step of every training path; the
    # library call is torch._foreach_copy_ of the set, which the port never
    # calls, and loop_ms the per-tensor clone, where and copy_ they replaced.
    for fn, name in (("gate_snapshot", "G"), ("gate_restore", "GR")):
        kernels.append({
            "name": fn,
            "route": "cuda",
            "source": "stereo_depth_estimation_tpu_torch/csrc/gate.cu",
            "replaces": "none (the JAX train step's jax.tree.map(keep_if_valid, ...), "
                        "stereo_depth_estimation_tpu/parallel/train_step.py:205-216, "
                        "an XLA fusion)",
            "launches": main_counts[name],
            "psmnet_launches": psm["launches"][name],
            "compiled_launches": compiled["launches"][name],
            "train_loop_launches": loop["counts"][name],
            "bound_by": "bytes",
            "sets": gate_times,
        })
    # K2 also runs every serving forward (float32): its launches there and
    # its times at the serving shapes, summed over the four levels.
    k2 = kernels[2]
    k2["serving_launches"] = serving_k2
    # The compiled serving forwards: the kernel's launch counter and, for the
    # live engine, the profiler's count (CUDA graph replays run no counter).
    k2["serving_compiled_launches"] = compiled_serving["k2"]
    k2["serving_f32"] = serving_pool
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
