"""State exchange with the JAX package through numpy.

A caller that holds the JAX package's `SpawnerParams` / `PoolState` /
`ColliderTable` / `FieldTable` passes their leaves as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
vars(state).items()}`); this module never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .colliders import ColliderTable
from .compiled import SpawnerParams
from .force_fields import FieldTable, field_table_from_rows
from .pool import POOL_FIELDS, PoolState
from .utils.device import DEFAULT_DEVICE, resolve_device

_DTYPES = {"ptype": torch.int32, "alive": torch.bool, "enabled": torch.bool, "manual_queued": torch.int32,
           "finished_notified": torch.bool, "ring_cursor": torch.int32}


def params_from_numpy(leaves: dict, device=DEFAULT_DEVICE) -> SpawnerParams:
    """The JAX package's SpawnerParams leaves (numpy) -> port params."""
    return SpawnerParams.from_numpy(leaves, device)


def pool_from_numpy(leaves: dict, device=DEFAULT_DEVICE) -> PoolState:
    """The JAX package's PoolState leaves (numpy) -> port PoolState."""
    device = resolve_device(device)
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


def colliders_from_numpy(leaves: dict, static_meta, device=DEFAULT_DEVICE) -> ColliderTable:
    """The JAX package's ColliderTable -> port table: `leaves` holds its
    position, rotation, params, layers (uint32), active and hull_planes as
    numpy; `static_meta` its (kinds, identity_rot, hull_counts)."""
    kinds, identity_rot, hull_counts = static_meta
    device = resolve_device(device)

    def t(k, dtype):
        return torch.as_tensor(np.array(np.asarray(leaves[k]), dtype=dtype, copy=True), device=device)

    return ColliderTable(
        kinds=tuple(int(k) for k in kinds), identity_rot=tuple(bool(i) for i in identity_rot),
        hull_counts=tuple(int(h) for h in hull_counts),
        position=t("position", np.float32), rotation=t("rotation", np.float32), params=t("params", np.float32),
        layers=t("layers", np.int64), active=t("active", np.float32), hull_planes=t("hull_planes", np.float32),
    )


def fields_from_numpy(leaves: dict, kinds, device=DEFAULT_DEVICE) -> FieldTable:
    """The JAX package's FieldTable -> port table: `leaves` holds its
    position, axis, params and active as numpy; `kinds` its static kinds."""
    return field_table_from_rows(kinds, leaves, device)
