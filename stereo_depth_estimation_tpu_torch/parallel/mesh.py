"""Static-shape batch padding with rank-1 row flags.

Counterpart of ``pad_batch_to`` in ``stereo_depth_estimation_tpu/parallel/
mesh.py`` on one GPU. The epoch's tail batch is padded up to the static batch
size with wrap-around rows whose ``valid_mask`` flag is False: BatchNorm sees
plausible images, and the loss and every metric sum ignore those rows
(``train_step._targets_and_mask`` ANDs the flags with ``target > 0``). Every
batch carries the flags, so every batch has one structure, as in the JAX
package. Meshes and sharding are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _pad_batch_rows(batch: dict[str, Any], pad: int) -> dict[str, Any]:
    """Append ``pad`` wrap-around rows with ``valid_mask`` forced False. A
    batch without a mask gets rank-1 per-row flags; an incoming mask of any
    rank is index-padded with the new rows False."""
    n = int(next(iter(batch.values())).shape[0])
    idx = np.concatenate([np.arange(n), np.arange(pad) % n])
    mask = batch.get("valid_mask")
    if mask is None:
        mask = np.ones(len(idx), bool)
    else:
        mask = np.asarray(mask)[idx].copy()
    mask[n:] = False
    out = {k: np.asarray(v)[idx] for k, v in batch.items() if k != "valid_mask"}
    out["valid_mask"] = mask
    return out


def pad_batch_to(batch: dict[str, Any], batch_size: int) -> dict[str, Any]:
    """Pad a batch's leading axis up to exactly ``batch_size`` and give every
    batch (padded or not) an explicit ``valid_mask``; a full batch gets
    all-True rank-1 row flags. An oversize batch raises."""
    n = int(next(iter(batch.values())).shape[0])
    if n > batch_size:
        raise ValueError(
            f"batch of {n} rows exceeds the static batch_size={batch_size}"
        )
    if n < batch_size:
        return _pad_batch_rows(batch, batch_size - n)
    if "valid_mask" not in batch:
        batch = dict(batch)
        batch["valid_mask"] = np.ones(n, bool)
    return batch
