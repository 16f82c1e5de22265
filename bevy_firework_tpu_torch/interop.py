"""State exchange with the JAX package through numpy.

A caller that holds the JAX package's `SpawnerParams` / `PoolState` passes
their leaves as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
vars(state).items()}`); this module never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiled import SpawnerParams
from .pool import POOL_FIELDS, PoolState

_DTYPES = {"ptype": torch.int32, "alive": torch.bool, "enabled": torch.bool, "manual_queued": torch.int32,
           "finished_notified": torch.bool, "ring_cursor": torch.int32}


def params_from_numpy(leaves: dict, device="cpu") -> SpawnerParams:
    """The JAX package's SpawnerParams leaves (numpy) -> port params."""
    return SpawnerParams.from_numpy(leaves, device)


def pool_from_numpy(leaves: dict, device="cpu") -> PoolState:
    """The JAX package's PoolState leaves (numpy) -> port PoolState."""
    kw = {}
    for k in POOL_FIELDS:
        a = np.asarray(leaves[k])
        if k == "rng_key":
            kw[k] = torch.as_tensor(a.astype(np.uint32).astype(np.int64))
            continue
        t = torch.as_tensor(np.array(a, copy=True), device=device)
        kw[k] = t.to(_DTYPES.get(k, torch.float32))
    return PoolState(**kw)


def pool_to_numpy(state: PoolState) -> dict:
    """Port PoolState -> numpy leaves in the JAX package's dtypes."""
    out = {k: getattr(state, k).cpu().numpy() for k in POOL_FIELDS}
    out["rng_key"] = out["rng_key"].astype(np.uint32)
    return out
