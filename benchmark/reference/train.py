"""The reference's train step in plain PyTorch: gather, augment, forward,
masked Laplace NLL, backward, AdamW.

The batch of step k is rows ``perm[k B:(k + 1) B]`` of the payload, where
``perm`` is one ``randperm`` of the payload drawn first from the step's
generator; each step then draws its augmentation (``augment.augment``).
Loss: over pixels with a finite target > 0, mean of |d - t| exp(-s) + s
(d the disparity, s the log-variance). AdamW: betas (0.9, 0.999), eps 1e-8,
decoupled weight decay on every parameter, constant learning rate.
"""

from __future__ import annotations

import torch

from . import augment, unet


def nll(disp: torch.Tensor, logvar: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mask = (target > 0) & torch.isfinite(target)
    t = torch.where(mask, target, torch.zeros_like(target))
    per_pixel = (disp - t).abs() * torch.exp(-logvar) + logvar
    return torch.where(mask, per_pixel, torch.zeros_like(per_pixel)).sum() / mask.sum().clamp(min=1)


def run(p0: dict[str, torch.Tensor], images_u8: torch.Tensor, targets: torch.Tensor,
        batch: int, generator: torch.Generator, aug: dict, lr: float, weight_decay: float,
        steps: int = 3, precision: str = "f32") -> dict:
    """``steps`` train steps from the parameters ``p0``: each step's loss, each
    leaf's norm of the first step's gradient, and each leaf's norm of the
    change of the parameters over the steps (dicts by name, on the host),
    and the first step's gradients themselves (``first_grad``)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    perm = torch.randperm(images_u8.shape[0], generator=generator, device=images_u8.device)
    losses, first_grad = [], {}
    for k in range(steps):
        rows = perm[k * batch:(k + 1) * batch]
        x = augment.augment(generator, images_u8.index_select(0, rows), aug)
        disp, logvar = unet.forward(params, x, train=True, precision=precision)
        loss = nll(disp, logvar, targets.index_select(0, rows).float())
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        del x, disp, logvar, loss
        with torch.no_grad():
            t = k + 1
            for (name, p), g in zip(params.items(), grads):
                if k == 0:
                    first_grad[name] = g.detach().clone()
                m[name].lerp_(g, 1 - b1)
                v2[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.mul_(1 - lr * weight_decay)
                denom = (v2[name].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[name], denom, value=-lr / (1 - b1 ** t))
        del grads
    change = {k: float((params[k].detach() - p0[k]).norm()) for k in params}
    return {"loss": losses, "grad": {k: float(g.norm()) for k, g in first_grad.items()},
            "change": change, "first_grad": first_grad}
