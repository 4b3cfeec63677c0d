"""The StereoUNet's 16-bit convolutions on zero-padded channels (enc1's
6-channel input, the fused 1x1 heads), held on the CPU against the same
weights run unpadded: the plain ``F.conv2d`` and each ``_Head`` alone
(``_CHANNEL_ALIGN`` set to 1 turns the padding off).

The padded products are exact zeros, so only the convolutions' sum order
may differ. Tolerance: 2e-2, five bf16 spacings at 1 (2^-8 each), on
outputs of order 1 and on each gradient relative to its largest entry; the
bf16 convolutions round every activation, and a different sum order moves
a rounding by one spacing, which later layers carry. float32 takes the
unpadded path and equals it exactly.
"""

import io

import pytest
import torch
import torch.nn.functional as F

from stereo_depth_estimation_tpu_torch.models import unet
from stereo_depth_estimation_tpu_torch.models.compat import load_torch_state_dict, torch_key_map
from stereo_depth_estimation_tpu_torch.models.unet import (
    HaloConv2d,
    StereoUNet,
    _conv,
    _run_heads,
    padded_convs,
)
from stereo_depth_estimation_tpu_torch.ops.halo import SpatialGroup

TOL = 2e-2
SHAPE = (2, 32, 48, 6)
CASES = {f"base{b}-{k}": (b, u) for b in (4, 32)
         for k, u in (("uncertainty", True), ("disparity", False))}
# The parameters whose convolutions the padding changes.
PADDED = ("enc1.block.0.weight", "disparity_head.weight", "disparity_head.bias",
          "logvar_head.weight", "logvar_head.bias")


def _model(base: int, dtype: torch.dtype = torch.bfloat16) -> StereoUNet:
    return StereoUNet(base_channels=base, compute_dtype=dtype, device="cpu",
                      generator=torch.Generator().manual_seed(base))


def _input(seed: int = 1, shape: tuple[int, ...] = SHAPE) -> torch.Tensor:
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _run(model: StereoUNet, x: torch.Tensor, uncertainty: bool):
    """Train-mode outputs, the padded convolutions they counted, and the
    gradients of a fixed weighted sum of the outputs."""
    model.zero_grad(set_to_none=True)
    before = padded_convs.launches
    outs = model(x, return_uncertainty=uncertainty)
    count = padded_convs.launches - before
    outs = outs if uncertainty else (outs,)
    w = torch.linspace(-1.0, 1.0, outs[0].numel()).reshape(outs[0].shape)
    sum((o * w).sum() for o in outs).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return [o.detach() for o in outs], count, grads


def _assert_close(got, want) -> None:
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL * float(want.detach().abs().max()))


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_padded_model_equals_unpadded(case, monkeypatch) -> None:
    """bf16 forward outputs and the padded convolutions' gradients against
    the same model run unpadded; 2 padded convolutions a forward (enc1's
    first and the heads), 0 unpadded."""
    base, uncertainty = case
    model, x = _model(base), _input()
    outs, count, grads = _run(model, x, uncertainty)
    assert count == 2
    for name in PADDED[:3 + 2 * uncertainty]:
        assert grads[name].shape == model.get_parameter(name).shape, name
    with monkeypatch.context() as m:
        m.setattr(unet, "_CHANNEL_ALIGN", 1)
        w_outs, w_count, w_grads = _run(model, x, uncertainty)
    assert w_count == 0
    assert all(o.dtype == torch.float32 for o in outs)
    for got, want in zip(outs, w_outs, strict=True):
        _assert_close(got, want)
    assert set(grads) == set(w_grads)
    for name in PADDED[:3 + 2 * uncertainty]:
        _assert_close(grads[name], w_grads[name])


@pytest.mark.parametrize("base", [4, 32])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_float32_takes_the_unpadded_path(base, train, monkeypatch) -> None:
    model, x = _model(base, torch.float32), _input(2)
    model.train(train)
    before = padded_convs.launches
    with torch.no_grad():
        disp, logvar = model(x, return_uncertainty=True)
        assert padded_convs.launches == before
        monkeypatch.setattr(unet, "_CHANNEL_ALIGN", 1)
        w_disp, w_logvar = model(x, return_uncertainty=True)
    torch.testing.assert_close(disp, w_disp, rtol=0, atol=0)
    torch.testing.assert_close(logvar, w_logvar, rtol=0, atol=0)


def test_state_dict_is_unchanged_and_a_reference_state_dict_loads(tmp_path) -> None:
    """Names and shapes of a bf16 model's state dict are the float32
    model's; a reference ``.pt`` (the plain keys) loads into it with no key
    missing or left over, and its checkpoint loads back into float32."""
    reference = _model(32, torch.float32)
    model = StereoUNet(compute_dtype=torch.bfloat16, device="cpu")
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    assert shapes == {k: v.shape for k, v in reference.state_dict().items()}
    assert set(torch_key_map()) <= set(shapes)
    path = tmp_path / "reference.pt"
    torch.save(reference.state_dict(), path)
    missing, unexpected = load_torch_state_dict(model, torch.load(path))
    assert not missing and not unexpected
    for key, value in reference.state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)
    buffer = io.BytesIO()
    torch.save(model.state_dict(), buffer)
    buffer.seek(0)
    StereoUNet(device="cpu").load_state_dict(torch.load(buffer), strict=True)


class _LoneStripe(SpatialGroup):
    """A stripe that is the whole image: its halo rows are zeros."""

    def pad(self, x: torch.Tensor, rows: int = 1) -> torch.Tensor:
        return F.pad(x, (0, 0, 0, 0, rows, rows))


@pytest.mark.parametrize("halo", [False, True], ids=["conv2d", "halo-conv2d"])
def test_first_conv_on_padded_channels_equals_the_plain_conv(halo) -> None:
    """enc1's first conv on the 8-channel input (a ``HaloConv2d`` on height
    stripes pads the same way) against ``F.conv2d`` on the 6 channels, in
    bf16 autocast: forward, input and weight gradients; the weight gradient
    keeps the weight's shape."""
    torch.manual_seed(0)
    conv = (HaloConv2d(6, 32, _LoneStripe(None, 0, 2)) if halo
            else torch.nn.Conv2d(6, 32, 3, padding=1, bias=False))
    x = _input(3, (2, 16, 24, 6)).requires_grad_()
    dy = torch.randn(2, 32, 16, 24)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        before = padded_convs.launches
        y = _conv(conv, F.pad(x.bfloat16(), (0, 2)).permute(0, 3, 1, 2))
        assert padded_convs.launches == before + 1
        want = F.conv2d(x.bfloat16().permute(0, 3, 1, 2), conv.weight, padding=1)
    got_grads = torch.autograd.grad(y, (x, conv.weight), dy.to(y.dtype))
    want_grads = torch.autograd.grad(want, (x, conv.weight), dy.to(want.dtype))
    assert got_grads[1].shape == (32, 6, 3, 3)
    _assert_close(y.float(), want.float())
    for got, w in zip(got_grads, want_grads, strict=True):
        _assert_close(got, w)


@pytest.mark.parametrize("uncertainty", [True, False], ids=["both-heads", "disparity-head"])
def test_fused_heads_equal_each_head(uncertainty) -> None:
    """The heads' one padded 1x1 conv against each ``_Head`` alone, in bf16
    autocast: float32 outputs (each bias added in float32), and the
    gradients of ``x`` and of each head's weight and bias."""
    model = _model(32)
    heads = ((model.disparity_head, model.logvar_head) if uncertainty
             else (model.disparity_head,))
    with torch.no_grad():
        for head in heads:
            head.bias.uniform_(-1.0, 1.0)
    x = torch.randn(2, 32, 16, 24).requires_grad_()
    leaves = (x, *(p for head in heads for p in (head.weight, head.bias)))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = _run_heads(heads, x.bfloat16(), torch.bfloat16)
        want = [head(x.bfloat16()) for head in heads]
    assert [g.dtype for g in got] == [torch.float32] * len(heads)
    dys = [torch.randn(2, 1, 16, 24) for _ in heads]
    got_grads = torch.autograd.grad(got, leaves, dys)
    want_grads = torch.autograd.grad(want, leaves, dys)
    for g, w in zip(got, want, strict=True):
        _assert_close(g, w)
    for g, w in zip(got_grads, want_grads, strict=True):
        _assert_close(g, w)
