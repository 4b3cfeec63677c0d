"""Device selection shared by the port's entry points, and the refusal of
command-line flags whose mechanism the port does not have yet."""

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


def resolve_cli_device(device_arg: str) -> torch.device:
    """A CLI's ``--device``: ``auto`` and ``cuda`` are the card (raising
    without CUDA); only ``cpu`` runs on the CPU."""
    if device_arg == "auto":
        device_arg = "cuda"
    if device_arg != "cpu" and not device_arg.startswith("cuda"):
        raise ValueError(f'--device must be "auto", "cuda" or "cpu", got {device_arg!r}')
    return resolve_device(device_arg)


def single_device_refusals(
    device: torch.device, *, mesh_devices: int = 1, spatial_devices: int = 1,
    aot_cache: str = "off",
) -> list[tuple[bool, str]]:
    """(refused, what) for the JAX CLIs' multi-device, spatial and
    executable-cache flags: the port runs on one device, eagerly."""
    several_gpus = device.type == "cuda" and torch.cuda.device_count() > 1
    return [
        (mesh_devices > 1 or (mesh_devices == 0 and several_gpus),
         f"--mesh-devices {mesh_devices}: several GPUs (ROADMAP Queue 1 item 8); "
         "the port runs on one, so pass --mesh-devices 1"),
        (spatial_devices != 1,
         f"--spatial-devices {spatial_devices}: height sharding (ROADMAP Queue 1 item 8)"),
        (aot_cache not in ("auto", "off"),
         f"--aot-cache {aot_cache}: the executable cache (ROADMAP Queue 1 item 9); "
         "an eager port has none, so only 'auto' and 'off' are accepted"),
    ]


def raise_refused(refusals: list[tuple[bool, str]]) -> None:
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"not ported yet: {what}")
