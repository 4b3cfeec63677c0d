"""AdamW over one flat float32 moment buffer.

Counterpart of ``stereo_depth_estimation_tpu/parallel/flat_adamw.py``: where
``torch.optim.AdamW`` (``make_adamw``) updates parameter by parameter, this
optimizer keeps AdamW's first and second moments as two flat float32
buffers over every parameter, gathers the gradients and parameters into
flat vectors, and runs the update as one elementwise pass in optax's form,

    mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,  count += 1
    p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)

(``optax.adamw``, decay on every parameter, as the reference trains).
``make_flat_adamw`` takes ``make_adamw``'s arguments and stands where it
does: the learning rate follows the same schedule of the update count, the
train step's zero-valid-batch gate restores the moments and the count, and
nothing reads a value on the host, so the step stays capturable on CUDA.

Its per-parameter state is the reference's layout, ``exp_avg``,
``exp_avg_sq`` and ``step`` for each parameter, where the moments are views
of the flat buffers and ``step`` is the one shared count: ``state_dict()``
saves it as ``torch.optim.AdamW`` does, and a checkpoint's load copies into
the views, that is into the flat buffers.
"""

from __future__ import annotations

import torch

from .train_step import make_lr_schedule


class FlatAdamW(torch.optim.Optimizer):
    """AdamW (betas 0.9/0.999, eps 1e-8) over flat moment buffers; the
    learning rate is a 0-dim tensor on the parameters' device that the
    train step refreshes from the count (``make_flat_adamw``)."""

    def __init__(self, params, lr: torch.Tensor, weight_decay: float,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8) -> None:
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})
        self.params = [p for group in self.param_groups for p in group["params"]]
        if len(self.param_groups) != 1:
            raise ValueError("FlatAdamW takes one parameter group")
        device = self.params[0].device
        n = sum(p.numel() for p in self.params)
        self.mu = torch.zeros(n, dtype=torch.float32, device=device)
        self.nu = torch.zeros(n, dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device)
        offset = 0
        for p in self.params:
            view = slice(offset, offset + p.numel())
            self.state[p] = {"step": self.count,
                             "exp_avg": self.mu[view].view(p.shape),
                             "exp_avg_sq": self.nu[view].view(p.shape)}
            offset += p.numel()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FlatAdamW takes no closure")
        group = self.param_groups[0]
        (b1, b2), eps, wd, lr = group["betas"], group["eps"], group["weight_decay"], group["lr"]
        g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                       for p in self.params]).float()
        p_flat = torch.cat([p.reshape(-1) for p in self.params]).float()
        self.mu.mul_(b1).add_(g, alpha=1.0 - b1)
        self.nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        self.count.add_(1.0)
        mu_hat = self.mu / (1.0 - torch.pow(b1, self.count))
        nu_hat = self.nu / (1.0 - torch.pow(b2, self.count))
        update = -lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p_flat)
        torch._foreach_add_(self.params, [u.view(p.shape) for u, p in zip(
            update.split([p.numel() for p in self.params]), self.params)])


def make_flat_adamw(
    params,
    lr: float,
    weight_decay: float,
    schedule: str = "constant",
    total_steps: int = 0,
    warmup_steps: int = 0,
) -> FlatAdamW:
    """``FlatAdamW`` with ``make_adamw``'s arguments and learning-rate
    schedule (``optimizer.lr_schedule``)."""
    params = list(params)
    lr_tensor = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    opt = FlatAdamW(params, lr_tensor, weight_decay)
    opt.lr_schedule = make_lr_schedule(lr, schedule, total_steps, warmup_steps)  # type: ignore[attr-defined]
    return opt
