"""The zero-valid gate (``ops/gate.py``) on the CPU, through its plain
versions: the table of byte ranges (aliases taken once, slots aligned, every
byte in exactly one chunk, as ``csrc/gate.cu`` walks them), a snapshot and
restore over a state of every kind of tensor the step gates, the rebuild
after ``optimizer.load_state_dict`` replaces the state's tensors, the
wrapper's refusals, and the ``restores`` counter over train steps. The
round trip runs over a module holding every kind of tensor the step gates
and over the train states of a tiny StereoUNet and a tiny PSMNet. The
kernels themselves run only on the card (``chip_smoke.py``'s gate phase).
"""

from __future__ import annotations

import copy
import math

import pytest
import torch
from torch import nn

from stereo_depth_estimation_tpu_torch.models.psmnet import PSMNet
from stereo_depth_estimation_tpu_torch.models.unet import StereoUNet
from stereo_depth_estimation_tpu_torch.ops import gate
from stereo_depth_estimation_tpu_torch.parallel.train_step import (
    TrainState, _gated_tensors, create_train_state, make_adamw, make_train_step)


class _Mixed(nn.Module):
    """Every kind of tensor a step gates: a channels_last conv weight, a
    bf16 parameter, BatchNorm's float32 running statistics and its int64
    0-dim ``num_batches_tracked``."""

    def __init__(self) -> None:
        super().__init__()
        self.conv = nn.Conv2d(3, 5, 3).to(memory_format=torch.channels_last)
        self.bn = nn.BatchNorm2d(5)
        self.scale = nn.Parameter(torch.randn(7, 3).to(torch.bfloat16))


# name -> a module whose train state (under AdamW) the step gates: "adamw"
# the mixed module, and a tiny StereoUNet and PSMNet.
MODELS = {
    "adamw": _Mixed,
    "stereo_unet": lambda: StereoUNet(base_channels=4, device="cpu"),
    "psmnet": lambda: PSMNet(max_disparity=16, channels=4, spp_pools=(8, 4, 2, 1),
                             device="cpu"),
}


def _state(name: str = "adamw") -> TrainState:
    """The model's train state, each gated tensor set to other values, the
    moments among them."""
    torch.manual_seed(0)
    model = MODELS[name]()
    state = TrainState(model=model, optimizer=make_adamw(model.parameters(), 1e-3, 1e-4),
                       generator=torch.Generator())
    with torch.no_grad():
        for t in _gated_tensors(state):
            t.copy_((torch.rand(t.shape) * 100).to(t.dtype))
    return state


def _step(tensors: list[torch.Tensor]) -> None:
    """What a step does to the gated state: every tensor changes in place
    (a tensor listed twice, twice)."""
    with torch.no_grad():
        for t in tensors:
            t.add_(1)


@pytest.mark.parametrize("model", MODELS)
def test_snapshot_and_restore_round_trip(model) -> None:
    state = _state(model)
    tensors = _gated_tensors(state)
    params = list(state.model.parameters())
    assert all(any(t is p for t in tensors) for p in params)
    assert len(tensors) == len(params) * 4 + len(list(state.model.buffers()))
    assert any(t.dim() == 0 and t.dtype == torch.int64 for t in tensors)
    if model == "adamw":
        weight = state.model.conv.weight
        assert not weight.is_contiguous()
        assert {t.dtype for t in tensors} == {torch.float32, torch.bfloat16, torch.int64}
    before = [t.clone() for t in tensors]
    g = gate.ZeroValidGate()
    for valid_count, restored in ((1.0, False), (0.0, True), (math.nan, True),
                                  (-1.0, True), (5.0, False)):
        g.snapshot(_gated_tensors(state))
        _step(tensors)
        stepped = [t.clone() for t in tensors]
        g.restore(torch.tensor(valid_count))
        want = before if restored else stepped
        for t, w in zip(tensors, want):
            assert t.dtype == w.dtype and torch.equal(t, w), valid_count
        before = [t.clone() for t in tensors]
    assert g.builds == 1
    assert g.restores.dtype == torch.int64 and int(g.restores) == 3


def test_flat_adamw_aliases_are_taken_once() -> None:
    """An optimizer state that aliases, as an AdamW over flat moment buffers
    keeps it: the moments views of two flat buffers, in order and touching,
    and one count listed under every parameter. Each buffer is one range,
    the count one more, the snapshot holds each byte once, and a restore
    undoes a step that changed the count once for each parameter."""
    state = _state()
    params = list(state.model.parameters())
    n = sum(p.numel() for p in params)
    mu, nu = torch.rand(n), torch.rand(n)
    count = torch.zeros(())
    offset = 0
    for p in params:
        view = slice(offset, offset + p.numel())
        state.optimizer.state[p] = {"step": count, "exp_avg": mu[view].view(p.shape),
                                    "exp_avg_sq": nu[view].view(p.shape)}
        offset += p.numel()
    tensors = _gated_tensors(state)
    assert sum(t is count for t in tensors) == len(params)
    table = gate.build_table(tensors)
    live = {(v.data_ptr(), v.numel()) for v in table.live}
    for flat in (mu, nu, count):
        assert (flat.data_ptr(), flat.nbytes) in live
    model_bytes = sum(t.nbytes for t in state.model.parameters())
    model_bytes += sum(t.nbytes for t in state.model.buffers())
    assert sum(v.numel() for v in table.live) == model_bytes + 2 * mu.nbytes + 4
    before = [t.clone() for t in tensors]
    g = gate.ZeroValidGate()
    g.snapshot(tensors)
    _step(tensors)
    assert float(count) == len(params)
    g.restore(torch.tensor(0.0))
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)


def _walk(table: gate.GateTable, chunk: int) -> dict[int, int]:
    """The kernel's walk over the host table, in Python: for each chunk the
    range it copies, its slot bytes [lo, hi), split into a head and a tail of
    bytes and a body of 16-byte words whose two ends are both aligned.
    Returns how often each live byte's address is copied."""
    r_, c_ = table.ranges, table.chunks
    cols = table.host_table.tolist()
    live, nbytes, slot, first, owner = (cols[:r_], cols[r_:2 * r_], cols[2 * r_:3 * r_],
                                        cols[3 * r_:4 * r_], cols[4 * r_:])
    assert len(owner) == c_
    seen: dict[int, int] = {}
    base = table.buffer.data_ptr()
    for c in range(c_):
        r = owner[c]
        mis = live[r] % 16
        k = c - first[r]
        lo, hi = max(k * chunk, mis), min((k + 1) * chunk, mis + nbytes[r])
        assert lo < hi
        body_lo = min(-(-lo // 16) * 16, hi)
        body_hi = max(hi // 16 * 16, body_lo)
        assert body_lo - lo < 16 and hi - body_hi < 16
        for j in range(body_lo, body_hi, 16):
            assert (live[r] - mis + j) % 16 == 0 and (base + slot[r] + j) % 16 == 0
        for j in range(lo, hi):
            address = live[r] - mis + j
            seen[address] = seen.get(address, 0) + 1
    return seen


def test_table_chunks_cover_every_byte_once(monkeypatch) -> None:
    """Unaligned views of several dtypes, overlapping and touching ranges of
    one storage, and ranges of many chunks: every gated byte lies in one
    chunk once, each slot starts 16-byte aligned and keeps its range's
    address mod 16, and the saved views are the slots' bytes."""
    monkeypatch.setattr(gate, "CHUNK", 64)
    flat = torch.arange(1000, dtype=torch.float32)
    half = torch.arange(301, dtype=torch.bfloat16)
    tensors = [flat[3:40], flat[30:90], flat[90:95], flat[96:98], flat[500:999], half[1:300],
               torch.tensor(7, dtype=torch.int64), torch.zeros(0), half[1:2]]
    table = gate.build_table(tensors)
    # flat[3:95], flat[96:98] (4 bytes apart), flat[500:999], half[1:300], the count
    assert table.ranges == 5
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel()) for v in table.live)
    assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
    cols = table.host_table.tolist()
    for r, (v, s) in enumerate(zip(table.live, table.saved)):
        assert cols[2 * table.ranges + r] % 16 == 0
        assert s.data_ptr() % 16 == v.data_ptr() % 16
    seen = _walk(table, 64)
    want = set()
    for t in tensors:
        want.update(range(t.data_ptr(), t.data_ptr() + t.nbytes))
    assert set(seen) == want and set(seen.values()) == {1}
    before = [t.clone() for t in tensors]
    gate.gate_snapshot_plain(table)
    for v, s in zip(table.live, table.saved):
        assert torch.equal(v, s)
    _step(tensors)
    gate.gate_restore_plain(table, torch.tensor(0.0), torch.zeros((), dtype=torch.int64))
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)


def test_table_is_rebuilt_after_optimizer_load_state_dict() -> None:
    state = _state()
    g = gate.ZeroValidGate()
    g.snapshot(_gated_tensors(state))
    g.snapshot(_gated_tensors(state))
    assert g.builds == 1
    old_key = g.table.key
    # A checkpoint's state dict (new tensors), as a resume loads it.
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    tensors = _gated_tensors(state)
    assert gate.gate_key(tensors) != old_key
    before = [t.clone() for t in tensors]
    g.snapshot(tensors)
    assert g.builds == 2
    _step(tensors)
    g.restore(torch.tensor(0.0))
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)
    g.snapshot(_gated_tensors(state))
    assert g.builds == 2


def test_wrapper_refuses_what_it_cannot_copy() -> None:
    dense = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="dense"):
        gate.build_table([dense, dense[:, ::2]])
    with pytest.raises(ValueError, match="dense"):
        gate.build_table([torch.zeros(3).expand(4, 3)])
    with pytest.raises(ValueError, match="one device"):
        gate.build_table([dense, torch.zeros(3, device="meta")])
    with pytest.raises(ValueError):
        gate.build_table([])
    table = gate.build_table([dense, dense.t(), torch.zeros(2, 3, 4, 5).permute(0, 2, 3, 1)])
    assert table.ranges == 2
    # The kernels take CUDA tables only; CPU tables go to the plain versions.
    with pytest.raises(ValueError, match="CUDA"):
        gate.gate_snapshot_cuda(table)
    with pytest.raises(ValueError, match="CUDA"):
        gate.gate_restore_cuda(table, torch.tensor(0.0), torch.zeros((), dtype=torch.int64))
    assert gate.gate_snapshot_cuda.launches == gate.gate_restore_cuda.launches == 0


def test_train_steps_count_one_restore_for_one_zero_valid_batch() -> None:
    """Five steps of a tiny StereoUNet, the third on a batch with no valid
    pixel: one table, one restore, and that step leaves the gated state
    bitwise as it was."""
    torch.manual_seed(0)
    model = StereoUNet(base_channels=4, device="cpu")
    state = create_train_state(model, make_adamw(model.parameters(), 1e-3, 1e-4), seed=0)
    step = make_train_step(None)
    gen = torch.Generator().manual_seed(3)
    for i in range(5):
        batch = {"input": torch.randint(0, 256, (2, 32, 48, 6), dtype=torch.uint8,
                                        generator=gen),
                 "target": torch.rand((2, 32, 48), generator=gen) * 8}
        if i == 2:
            batch["target"].zero_()
            before = [t.clone() for t in _gated_tensors(state)]
        state, stats = step(state, batch)
        if i == 2:
            assert float(stats.valid_count) == 0.0
            for t, b in zip(_gated_tensors(state), before):
                assert torch.equal(t, b)
    assert state.step == 5
    assert state.gate.builds == 1 and int(state.gate.restores) == 1
