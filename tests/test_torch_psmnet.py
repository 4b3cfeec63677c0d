"""PSMNet (``models/psmnet.py``) on the CPU at a tiny cut (channels 4, 32x64,
max disparity 16, pools 8, 4, 2, 1), held against the published model in
plain ``torch.nn`` (``psmnet_reference.py``) and the benchmark's functional
reference (``benchmark/reference/psmnet.py``), float32 and seeded weights;
the cost-volume op against the published slice loop; BN1-BN4's plain paths
on channels_last_3d volumes against ``nn.BatchNorm3d``; the train step's loss
seam and zero-valid gate; and the trainer CLI's ``--model psmnet``.

PyTorch's CPU oneDNN convolutions corrupt the heap now and then on this
network when they run multi-threaded (torch 2.13: a crash at exit, or a
wrong gradient), so every test here runs with oneDNN off (``_native_cpu``);
the native kernels compute the same functions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import psmnet_reference as published
import pytest
import torch
import torch.nn.functional as F
from test_torch_data import make_dataset
from torch import nn

from benchmark import inputs
from benchmark.reference import psmnet as bench_ref
from benchmark.traffic import train_psmnet_resident
from stereo_depth_estimation_tpu_torch.models.psmnet import PSMNet
from stereo_depth_estimation_tpu_torch.models.unet import MeshBatchNorm3d
from stereo_depth_estimation_tpu_torch.ops import cost_volume as cv
from stereo_depth_estimation_tpu_torch.ops.loss import weighted_smooth_l1
from stereo_depth_estimation_tpu_torch.parallel.train_step import (
    create_train_state, make_adamw, make_device_data_train_step, make_train_step)
from stereo_depth_estimation_tpu_torch.training import checkpoint, trainer

DISP, C, POOLS, HW = 16, 4, (8, 4, 2, 1), (32, 64)
CFG = {"channels": C, "max_disparity": DISP, "height": HW[0], "width": HW[1],
       "spp_pools": list(POOLS)}
# The port's float32 forward against the published model's: the same
# operations with BatchNorm's sums in another order (BN1-BN4's plain versions
# form E[x^2] - E[x]^2 from float32 sums), through 60 2D and 25 3D BatchNorms;
# measured ~7e-6 of the outputs' scale.
OUT_RTOL = 1e-4
# Eval normalises by the running statistics, whose variance comes out of
# those sums: a channel of small variance magnifies their round-off
# (measured 2.5e-4 of the scale).
EVAL_RTOL = 2e-3
# Gradients leaf by leaf, as a share of the leaf's norm (floored at the median
# leaf's): the batch-statistic backward through the deep stack magnifies the
# sum order's noise (measured below 2e-5).
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _native_cpu():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _models(seed: int = 0):
    torch.manual_seed(seed)
    ref = published.PSMNet(DISP, C, POOLS)
    port = PSMNet(max_disparity=DISP, channels=C, spp_pools=POOLS, device="cpu")
    port.load_state_dict(ref.state_dict())
    return ref, port


def _batch(seed: int = 1, n: int = 3):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, *HW, 6), generator=g)
    target = torch.rand((n, *HW), generator=g) * (DISP + 2)  # some at or above DISP
    target[:, :2] = 0.0  # invalid rows
    return x, target


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def test_forward_loss_and_gradients_match_the_published_model() -> None:
    ref, port = _models()
    x, target = _batch()
    want = ref(x)
    got = port(x)
    assert len(got) == 3 and all(g.shape == (3, *HW) and g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        assert _rel(g, w) <= OUT_RTOL
    want_loss = published.loss(want, target, DISP)
    got_loss, stats = port.step_loss(got, target, target > 0)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=OUT_RTOL)
    want_loss.backward()
    got_loss.backward()
    ref_params = dict(ref.named_parameters())
    floor = float(np.median([float(p.grad.norm()) for p in ref_params.values()]))
    for name, p in port.named_parameters():
        w = ref_params[name].grad
        gap = float((p.grad - w).norm()) / max(float(w.norm()), floor)
        assert gap <= GRAD_RTOL, (name, gap)
    # Running statistics after one training forward each, then eval.
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert torch.allclose(buf, dict(ref.named_buffers())[name], rtol=OUT_RTOL,
                                  atol=1e-6), name
    ref.eval()
    port.eval()
    assert _rel(port(x), ref(x)) <= EVAL_RTOL


def test_the_benchmark_reference_is_the_published_model() -> None:
    ref, _ = _models(3)
    x, target = _batch(4)
    p = {k: v.detach() for k, v in ref.named_parameters()}
    for a, b in zip(bench_ref.forward(p, x, CFG, train=True), ref(x)):
        assert _rel(a, b) <= OUT_RTOL
    ref.eval()
    sd = {k: v.detach() for k, v in ref.state_dict().items()}
    assert _rel(bench_ref.forward(sd, x, CFG, train=False), ref(x)) <= EVAL_RTOL
    preds = tuple(torch.rand((3, *HW)) * DISP for _ in range(3))
    assert float(bench_ref.loss(preds, target, DISP)) == pytest.approx(
        float(published.loss(preds, target, DISP)), rel=1e-6)


def test_published_width_parameters_and_names() -> None:
    with torch.device("meta"):
        port = PSMNet(device="meta")
        ref = published.PSMNet()
    assert sum(p.numel() for p in port.parameters()) == 5_224_768
    assert list(port.state_dict()) == list(ref.state_dict())
    shapes = {k: tuple(v.shape) for k, v in port.named_parameters()}
    assert shapes == bench_ref.parameter_shapes(
        {"channels": 32, "max_disparity": 192, "height": 256, "width": 512,
         "spp_pools": [64, 32, 16, 8]})


def test_published_init_and_layouts() -> None:
    model = PSMNet(channels=8, max_disparity=DISP, spp_pools=POOLS, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    for name, module in model.named_modules():
        if isinstance(module, (nn.Conv2d, nn.Conv3d)):
            w = module.weight
            std = math.sqrt(2.0 / (math.prod(module.kernel_size) * module.out_channels))
            assert float(w.std()) == pytest.approx(std, rel=0.25), name
            layout = torch.channels_last if w.ndim == 4 else torch.channels_last_3d
            assert w.is_contiguous(memory_format=layout), name
        elif isinstance(module, nn.ConvTranspose3d):
            bound = 1.0 / math.sqrt(module.weight.shape[1] * 27)
            assert float(module.weight.abs().max()) <= bound
        elif isinstance(module, nn.BatchNorm2d):
            assert torch.equal(module.weight, torch.ones_like(module.weight))
    again = PSMNet(channels=8, max_disparity=DISP, spp_pools=POOLS, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def _slice_loop(left, right, depth):
    """The published construction: D slice copies into a zero volume."""
    n, c, h, w = left.shape
    cost = left.new_zeros(n, 2 * c, depth, h, w)
    for i in range(depth):
        if i > 0:
            cost[:, :c, i, :, i:] = left[:, :, :, i:]
            cost[:, c:, i, :, i:] = right[:, :, :, :-i]
        else:
            cost[:, :c, i] = left
            cost[:, c:, i] = right
    return cost


@pytest.mark.parametrize("depth,width", [(1, 7), (4, 7), (9, 7)], ids=["d0-only", "d4", "w<d"])
def test_cost_volume_matches_the_slice_loop(depth, width) -> None:
    g = torch.Generator().manual_seed(depth)
    left = torch.randn((2, 3, 4, width), generator=g).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    right = torch.randn((2, 3, 4, width), generator=g).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    got = cv.cost_volume(left, right, depth)
    want = _slice_loop(left, right, depth)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    if depth > width:  # the zero band w < d
        assert not got[:, :, width:].any()
    dv = torch.randn(want.shape, generator=g)
    for a, b in zip(torch.autograd.grad(got, (left, right), dv),
                    torch.autograd.grad(want, (left, right), dv)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)


def test_cost_volume_ops_pass_opcheck_and_fake_shapes() -> None:
    left, right = torch.randn(2, 4, 6, 3), torch.randn(2, 4, 6, 3)
    torch.library.opcheck(cv.cost_volume_fwd, (left, right, 4))
    torch.library.opcheck(cv.cost_volume_bwd, (torch.randn(2, 4, 4, 6, 6), 3))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fl = torch.empty(2, 3, 4, 6).contiguous(memory_format=torch.channels_last)
        out = cv.cost_volume(fl, torch.empty_like(fl), 5)
        assert out.shape == (2, 6, 5, 4, 6)
        assert out.is_contiguous(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError, match="CUDA"):
        cv.cost_volume_fwd_cuda(left, right, 4)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no-relu"])
def test_bn_plain_paths_on_volumes_match_batchnorm3d(relu) -> None:
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 5, 4, 6, 7), generator=g) * 2 + 0.5
    dy = torch.randn(x.shape, generator=g)
    ours, theirs = MeshBatchNorm3d(5), nn.BatchNorm3d(5)
    with torch.no_grad():
        for bn in (ours, theirs):
            bn.weight.copy_(torch.rand(5, generator=torch.Generator().manual_seed(1)) + 0.5)
            bn.bias.copy_(torch.randn(5, generator=torch.Generator().manual_seed(2)))
    xa = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    xb = x.clone().requires_grad_()
    ya = ours.forward_relu(xa) if relu else ours(xa)
    yb = F.relu(theirs(xb)) if relu else theirs(xb)
    assert ya.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.allclose(ya, yb, rtol=1e-5, atol=1e-5)
    ga = torch.autograd.grad(ya, (xa, ours.weight, ours.bias), dy)
    gb = torch.autograd.grad(yb, (xb, theirs.weight, theirs.bias), dy)
    for a, b in zip(ga, gb):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.allclose(getattr(ours, name).float(), getattr(theirs, name).float(),
                              rtol=1e-5, atol=1e-6), name
    ours.eval()
    theirs.eval()
    assert torch.allclose(ours(x), theirs(x), rtol=1e-5, atol=1e-5)


def test_loss_stats_by_hand() -> None:
    g = torch.Generator().manual_seed(9)
    preds = tuple(torch.rand((2, 4, 5), generator=g) * 20 for _ in range(3))
    target = torch.rand((2, 4, 5), generator=g) * 20
    target[0, 0] = 0.0
    target[0, 1, 0] = float("nan")
    valid = target > 0
    loss, stats = weighted_smooth_l1(preds, target, valid, DISP)
    mask = (target > 0) & (target < DISP)
    t = target[mask]

    def sl1(e):
        return torch.where(e.abs() < 1, 0.5 * e * e, e.abs() - 0.5)

    terms = [w * sl1(p[mask] - t).sum() for w, p in zip((0.5, 0.7, 1.0), preds)]
    e = preds[2][mask] - t
    assert float(stats.valid_count) == mask.sum()
    assert float(stats.nll_sum) == pytest.approx(float(sum(terms)), rel=1e-6)
    assert float(loss) == pytest.approx(float(sum(terms)) / int(mask.sum()), rel=1e-6)
    assert float(stats.abs_err_sum) == pytest.approx(float(e.abs().sum()), rel=1e-6)
    assert float(stats.sq_err_sum) == pytest.approx(float((e * e).sum()), rel=1e-6)
    assert float(stats.sigma_sum) == 0.0
    _, one = weighted_smooth_l1(preds[2], target, valid, DISP)  # eval: one output
    assert float(one.nll_sum) == pytest.approx(float(terms[2]), rel=1e-6)


def test_zero_valid_batch_leaves_psmnet_unchanged() -> None:
    _, model = _models()
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 0.0), seed=0)
    step = make_train_step()
    x, target = _batch(n=2)
    state, stats = step(state, {"input": x, "target": target})
    before = [t.clone() for t in (*model.parameters(), *model.buffers(),
                                  *(v for s in state.optimizer.state.values()
                                    for v in s.values()))]
    state, stats = step(state, {"input": x, "target": torch.zeros_like(target)})
    assert float(stats.valid_count) == 0.0
    after = [*model.parameters(), *model.buffers(),
             *(v for s in state.optimizer.state.values() for v in s.values())]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_device_data_steps_match_the_benchmark_reference() -> None:
    """Two unaugmented steps of the port's device-resident step against the
    benchmark reference's ``run`` from the same weights, batches and
    permutation."""
    device = torch.device("cpu")
    g = inputs.generator(device, 11)
    images = inputs.stereo_u8(g, 8, *HW)
    targets = inputs.disparity(g, 8, *HW, float(DISP), 0.05)
    p0 = train_psmnet_resident.weights(CFG, 12, device)
    model = PSMNet(max_disparity=DISP, channels=C, spp_pools=POOLS, device="cpu")
    model.load_state_dict(train_psmnet_resident.state_dict(p0, CFG))
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 0.0), seed=13)
    step = make_device_data_train_step(images, targets, 3)
    losses = []
    for _ in range(2):
        state, stats = step(state)
        losses.append(float(stats.nll_sum / stats.valid_count))
    want = bench_ref.run(p0, images, targets, CFG, 3, inputs.generator(device, 13), None,
                         1e-3, 0.0, steps=2)
    assert losses == pytest.approx(want["loss"], rel=1e-4)
    for name, p in model.named_parameters():
        change = float((p.detach() - p0[name]).norm())
        assert change == pytest.approx(want["change"][name], rel=2e-2, abs=1e-6), name


def test_trainer_trains_psmnet_and_its_checkpoint_loads_back(tmp_path, monkeypatch) -> None:
    make_dataset(tmp_path / "data", scenes=(("scene_a", 6),), shape=(40, 72))
    # The trainer builds the published pools (64 needs a 256-row crop): the
    # tiny crop takes the tiny cut's.
    monkeypatch.setattr(trainer, "PSMNet", functools.partial(PSMNet, spp_pools=POOLS))
    summary = trainer.main([
        "--dataset-root", str(tmp_path / "data"), "--model", "psmnet", "--height", "32",
        "--width", "64", "--max-disparity", str(DISP),
        "--base-channels", str(C), "--epochs", "1", "--batch-size", "2",
        "--val-fraction", "0.34", "--device", "cpu", "--compute-dtype", "float32",
        "--aot-cache", "off", "--num-workers", "0", "--mlflow-tracking-uri",
        str(tmp_path / "runs"), "--output-dir", str(tmp_path / "out")])
    assert summary["global_step"] == 2
    epoch = summary["epochs"][0]
    assert all(np.isfinite(epoch[k]) for k in ("train_loss", "val_mae"))
    last = tmp_path / "out" / summary["run_id"] / "checkpoints" / "last.pt"
    model = PSMNet(max_disparity=DISP, channels=C, spp_pools=POOLS, device="cpu")
    loaded = checkpoint.load_model_variables(last, model)
    assert loaded["missing_keys"] == [] and loaded["unexpected_keys"] == []
    saved = torch.load(last, map_location="cpu", weights_only=False)["model_state_dict"]
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in saved.items())
    from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet

    with pytest.raises(ValueError, match="PSMNet checkpoint"):
        checkpoint.load_model_variables(last, StereoUNet(base_channels=4, device="cpu"))
