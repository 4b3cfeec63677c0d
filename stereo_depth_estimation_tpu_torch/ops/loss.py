"""Masked heteroscedastic Laplace NLL and pixel-weighted metrics.

Counterpart of ``stereo_depth_estimation_tpu/ops/loss.py``:

- mask = valid_mask & isfinite(target)
- nll  = |pred - target| * exp(-logvar) + logvar       (per valid pixel)
- loss = sum(nll) / max(valid_count, 1)
- metric sums (nll, |e|, e^2, sigma=exp(logvar/2)) per valid pixel, so epoch
  means are pixel-weighted.

Reductions are ``where``-masked with static shapes (no boolean indexing), so
the step never synchronises with the host to learn how many pixels are
valid. A batch with zero valid pixels gives loss 0 and zero gradients; the
train step additionally turns such a batch into a no-op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossStats(NamedTuple):
    """Per-batch sums for pixel-weighted epoch aggregation (0-dim tensors)."""

    nll_sum: torch.Tensor
    abs_err_sum: torch.Tensor
    sq_err_sum: torch.Tensor
    sigma_sum: torch.Tensor
    valid_count: torch.Tensor


def heteroscedastic_laplace_nll(
    pred: torch.Tensor,
    logvar: torch.Tensor,
    target: torch.Tensor,
    valid_mask: torch.Tensor,
) -> tuple[torch.Tensor, LossStats]:
    """Return (scalar loss, LossStats). All inputs broadcastable to (N, H, W)."""
    mask = valid_mask & torch.isfinite(target)
    maskf = mask.to(torch.float32)
    safe_target = torch.where(mask, target, 0.0)

    diff = pred.to(torch.float32) - safe_target.to(torch.float32)
    abs_diff = diff.abs() * maskf
    lv = logvar.to(torch.float32)
    nll = (abs_diff * torch.exp(-lv) + lv) * maskf

    valid_count = maskf.sum()
    denom = valid_count.clamp(min=1.0)
    nll_sum = nll.sum()
    loss = nll_sum / denom

    sigma = torch.exp(0.5 * lv) * maskf
    stats = LossStats(
        nll_sum=nll_sum,
        abs_err_sum=abs_diff.sum(),
        sq_err_sum=((diff * maskf) ** 2).sum(),
        sigma_sum=sigma.sum(),
        valid_count=valid_count,
    )
    return loss, stats


def metrics_from_stats(stats: LossStats) -> dict[str, float]:
    """Host-side epoch means from accumulated sums."""
    count = float(stats.valid_count)
    if count <= 0:
        raise RuntimeError("No valid target pixels found for this epoch.")
    nll_mean = float(stats.nll_sum) / count
    return {
        "loss": nll_mean,
        "nll": nll_mean,
        "mae": float(stats.abs_err_sum) / count,
        "rmse": (float(stats.sq_err_sum) / count) ** 0.5,
        "sigma": float(stats.sigma_sum) / count,
    }


def accumulate_stats(total: LossStats | None, batch: LossStats) -> LossStats:
    if total is None:
        return batch
    return LossStats(*(t + b for t, b in zip(total, batch)))
