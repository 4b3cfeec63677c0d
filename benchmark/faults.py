"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_bench_faults.py`` on the CPU; ``tools/readings.py`` on the
card, where a fault's reading can set a training number's upper limit).

A traffic kind lists the faults its cells can have (``FAULTS``) and names
the model class whose forward ``altered`` patches (``MODEL_CLASS``).

- ``unchanged``: AdamW's step does nothing, so the state stays as it was.
- ``half_batch``: the step (or the prediction) sees half of its batch; a
  train step takes the mean over the rest, a prediction repeats it.
- ``altered``: the model's output (its first, where it returns several)
  comes out 1 higher, where it is produced.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

NAMES = ("unchanged", "half_batch", "altered")


def _model_class(path: str) -> type:
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


@contextlib.contextmanager
def planted(name: str, kind):
    """``name`` planted for a cell of ``kind``, a traffic kind's module."""
    patches = []
    if name == "unchanged":
        patches.append((torch.optim.AdamW, "step", lambda self, closure=None: None))
    elif name == "half_batch":
        from stereo_depth_estimation_tpu_torch.parallel import train_step

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
        model = _model_class(kind.MODEL_CLASS)
        forward = model.forward

        def altered(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            if isinstance(out, tuple):
                return (out[0] + 1.0, *out[1:])
            return out + 1.0

        patches.append((model, "forward", altered))
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
