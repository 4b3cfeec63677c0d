"""The frozen reference against the port's plain CPU path at a tiny size, from
the same weights, inputs and random draws."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare, inputs, spec
from benchmark.reference import augment, frame, unet

from .conftest import BENCH, CELLS, tiny_config, tiny_parts

CFG = tiny_config(next(cfg for cfg in (spec.config(BENCH, c["name"]) for c in BENCH["configs"])
                       if cfg["reference"] == "unet"))
AUG = next(m["augment"] for m in (spec.mix(w["traffic"]) for w in BENCH["workloads"])
           if "augment" in m)


def _trains_a_unet(cell: str) -> bool:
    """Set-up runs checked train steps of a StereoUNet."""
    _, cfg, mix, _ = tiny_parts(cell)
    return cfg["reference"] == "unet" and "checked_steps" in mix


TRAIN_CELLS = [c for c in CELLS if _trains_a_unet(c)]


def _port_model(sd, train_dtype=torch.float32):
    from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet

    model = StereoUNet(base_channels=CFG["base_channels"], compute_dtype=train_dtype,
                       device="cpu")
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("train", [True, False])
def test_the_reference_forward_is_the_ports(train) -> None:
    sd = inputs.serving_weights(CFG, {"bn_calibration_images": 2}, 5, "cpu")
    p = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    x = torch.rand(3, 32, 48, 6, generator=inputs.generator("cpu", 6))
    model = _port_model(sd).train(train)
    with torch.no_grad():
        want = model(x, return_uncertainty=True)
        got = unet.forward(p, x, train=train)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b[..., 0], rtol=1e-5, atol=1e-5)


def test_the_reference_augmentation_draws_the_ports_stream() -> None:
    from stereo_depth_estimation_tpu_torch.ops.augment import AugmentConfig
    from stereo_depth_estimation_tpu_torch.ops.augment_cuda import augment_stereo_batch_fused

    x = inputs.stereo_u8(inputs.generator("cpu", 7), 8, 32, 48)
    cfg = dict(AUG, blur_prob=0.5)  # blur some views
    want = augment_stereo_batch_fused(inputs.generator("cpu", 8), x, AugmentConfig(**cfg),
                                      out_dtype=torch.float32)
    got = augment.augment(inputs.generator("cpu", 8), x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


def test_the_reference_live_frame_is_the_engines() -> None:
    from stereo_depth_estimation_tpu_torch.live.depth_live_dl import LiveDepthEngine
    from stereo_depth_estimation_tpu_torch.ops.remap import Rectifier

    from benchmark.spec import HERE

    with np.load(HERE / "data" / "stereo_calib.npz") as f:
        calib = {k: f[k] for k in f.files}
    sd = inputs.serving_weights(CFG, {"bn_calibration_images": 2}, 9, "cpu")
    engine = LiveDepthEngine((48, 32), Rectifier.from_calibration(calib, "cpu"), "cpu", 4)
    engine.model.load_state_dict(sd)
    rng = np.random.default_rng(3)
    left, right = (rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(2))
    want = engine.process(left, right)
    with torch.no_grad():
        got = frame.live_frame(sd, frame.maps(calib, "cpu"), left, right, (32, 48))
    # The reference resizes with F.interpolate's float32 weights, up to 8e-6
    # away from the engine's float64 products.
    for a, b in zip(got[:2], want[:2]):
        assert compare.output_gap(a, b) < 1e-3
    for a, b in zip(got[2:], want[2:]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert np.mean(a != b) < 1e-3


def test_the_reference_prediction_is_make_predict_fns() -> None:
    from stereo_depth_estimation_tpu_torch.parallel.train_step import make_predict_fn

    sd = inputs.serving_weights(CFG, {"bn_calibration_images": 2}, 10, "cpu")
    batch = inputs.stereo_u8(inputs.generator("cpu", 11), 3, 32, 48)
    want = [t.numpy() for t in make_predict_fn(_port_model(sd).eval())(batch)]
    with torch.no_grad():
        got = frame.predict(sd, batch)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell_name", TRAIN_CELLS)
def test_the_reference_train_steps_follow_the_ports_in_float32(cell_name) -> None:
    _, cfg, mix, _ = tiny_parts(cell_name)
    cell = spec.kind(mix["kind"]).Cell(cfg, mix, 2**32 + 3, torch.device("cpu"))
    cell.release()
    numbers = cell.numbers()
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 1e-3
    assert numbers["change_gap"] < 2e-2  # AdamW's sign of near-zero gradients


def test_a_control_precision_departs_from_float32() -> None:
    p = unet.leaf_shapes(4)
    w = inputs.weights(CFG, 12, "cpu")
    assert set(w) == set(p)
    x = torch.rand(2, 32, 48, 6, generator=inputs.generator("cpu", 13))
    with torch.no_grad():
        ref = unet.forward(w, x, train=True)[0]
        for precision in ("bf16", "fp8"):
            low = unet.forward(w, x, train=True, precision=precision)[0]
            assert 1e-4 < float((low - ref).abs().max() / ref.abs().max()) < 0.5
