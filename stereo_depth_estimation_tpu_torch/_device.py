"""Device selection shared by the port's entry points, and the number of
ranks a process starts."""

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


def local_rank_count(
    device: torch.device, mesh_devices: int, *, env_rendezvous: bool = False
) -> int:
    """The ranks one process starts for ``--mesh-devices``: that many, or
    with 0 every visible GPU (one on the CPU). A CUDA run that asks for more
    ranks than there are visible GPUs raises: ranks never share a card.

    With ``env_rendezvous`` (``--multihost`` without address flags) a
    launcher starts one process a rank, so each process runs one, on its
    ``LOCAL_RANK``'s GPU; ``--mesh-devices`` above 1 raises."""
    if env_rendezvous:
        if mesh_devices > 1:
            raise ValueError(
                f"--mesh-devices {mesh_devices} with --multihost and no address flags: "
                "the environment's WORLD_SIZE counts the ranks, one a process; start one "
                "process per GPU and leave --mesh-devices at 0 or 1"
            )
        return 1
    if device.type != "cuda":
        return max(mesh_devices, 1)
    visible = torch.cuda.device_count()
    wanted = mesh_devices or visible
    if wanted > visible:
        raise ValueError(
            f"--mesh-devices {mesh_devices}: {visible} GPU(s) visible, and each "
            "rank needs a card of its own"
        )
    return wanted
