"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for but absent.

    Entry points default to ``"cuda"``. A host without CUDA never quietly
    runs them on the CPU: the caller has to ask for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
