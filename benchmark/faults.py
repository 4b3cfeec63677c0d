"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_bench_faults.py`` on the CPU; ``tools/readings.py`` on the
card, where a fault's reading can set a training number's upper limit).

- ``unchanged``: AdamW's step does nothing, so the state stays as it was.
- ``half_batch``: the step (or the prediction) sees half of its batch; a
  train step takes the mean over the rest, a prediction repeats it.
- ``altered``: the model's disparity comes out 1 pixel high, where it is
  produced.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"train_device_resident": ("unchanged", "half_batch", "altered"),
          "predict_batches": ("half_batch", "altered"),
          "live_frames": ("altered",)}


@contextlib.contextmanager
def planted(name: str):
    from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet
    from stereo_depth_estimation_tpu_torch.parallel import train_step

    patches = []
    if name == "unchanged":
        patches.append((torch.optim.AdamW, "step", lambda self, closure=None: None))
    elif name == "half_batch":
        gather = train_step.DeviceDataTrainStep.gather

        def half_gather(self, state):
            batch = gather(self, state)
            return {k: v[: v.shape[0] // 2] for k, v in batch.items()}

        make = train_step.make_predict_fn

        def half_predict_fn(model, *args, **kwargs):
            fn = make(model, *args, **kwargs)

            def predict(inputs):
                n = inputs.shape[0]
                disp, logvar = fn(inputs[: (n + 1) // 2])
                rows = torch.arange(n, device=disp.device) % disp.shape[0]
                return disp[rows], logvar[rows]

            return predict

        patches += [(train_step.DeviceDataTrainStep, "gather", half_gather),
                    (train_step, "make_predict_fn", half_predict_fn)]
    elif name == "altered":
        forward = StereoUNet.forward

        def altered(self, x, return_uncertainty=False):
            out = forward(self, x, return_uncertainty)
            if return_uncertainty:
                return out[0] + 1.0, out[1]
            return out + 1.0

        patches.append((StereoUNet, "forward", altered))
    else:
        raise ValueError(f"unknown fault {name!r}")
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, value in patches:
            setattr(owner, attr, value)
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
