"""Checkpoint / resume (port of `bevy_firework_tpu.checkpoint`).

Settings as JSON and the pool and trail arrays as npz round-trip a whole
Scene bit for bit, the PRNG state included, so a resumed run continues the
same trajectory. The file format is the JAX package's: a zip holding
`scene.json` (time, next_id, seed, spawners, force_fields, colliders),
`pool_{sid}.npz` and `trail_{sid}.npz`, with the JAX package's dtypes
(`rng_key` as uint32 [2]; the port holds it as int64 on the host), so a
checkpoint saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Dict

import numpy as np

from .interop import pool_from_numpy, pool_to_numpy
from .pool import POOL_FIELDS, PoolState
from .settings import EffectModifier, spawner_from_dict, spawner_to_dict
from .trails import TrailSettings, trail_from_numpy, trail_to_numpy
from .utils.device import DEFAULT_DEVICE, resolve_device


def _reconstruct_ring_cursor(arrays: Dict[str, np.ndarray]) -> int:
    """Exact ring-cursor recovery for legacy checkpoints that predate the
    field. Ring pools (constant lifetime) die first in, first out, so live
    lanes form a contiguous ring window and claims advance in ring order:
    the cursor sits one past the youngest live lane at the end of its
    same-age cohort."""
    alive = np.asarray(arrays["alive"]).astype(bool)
    if not alive.any():
        return 0
    age = np.asarray(arrays["age"])
    n = alive.shape[0]
    min_age = age[alive].min()
    youngest = alive & (age == min_age)
    idx = np.nonzero(youngest)[0]
    nxt = (idx + 1) % n
    boundary = idx[~youngest[nxt]]
    # no boundary: the whole ring is one same-age cohort; any consistent
    # position works, take the last youngest index
    end = int(boundary[0]) if len(boundary) else int(idx[-1])
    return (end + 1) % n


def pool_to_arrays(state: PoolState) -> Dict[str, np.ndarray]:
    """The pool's leaves as numpy in the JAX package's dtypes."""
    return pool_to_numpy(state)


def pool_from_arrays(arrays: Dict[str, np.ndarray], device=DEFAULT_DEVICE) -> PoolState:
    """A pool from checkpoint arrays on `device`. A field missing from a
    legacy checkpoint takes its reconstruction (only `ring_cursor`); dead
    lanes are made to read dead under the derived-alive convention (alive
    == age < lifetime), since legacy checkpoints stored age 0 there."""
    arrays = dict(arrays)
    for k in POOL_FIELDS:
        if k not in arrays:
            if k == "ring_cursor":
                arrays[k] = np.asarray(_reconstruct_ring_cursor(arrays), np.int32)
                continue
            raise KeyError(f"checkpoint missing pool field {k!r}")
    alive = np.asarray(arrays["alive"]).astype(bool)
    age = np.asarray(arrays["age"], np.float32)
    arrays["age"] = np.where(alive, age, np.maximum(age, np.asarray(arrays["lifetime"], np.float32)))
    return pool_from_numpy(arrays, device)


def save_pool(path: str, state: PoolState):
    np.savez_compressed(path, **pool_to_arrays(state))


def load_pool(path: str, device=DEFAULT_DEVICE) -> PoolState:
    with np.load(path) as z:
        return pool_from_arrays({k: z[k] for k in z.files}, device)


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _npz_read(zf: zipfile.ZipFile, name: str) -> dict:
    with zf.open(name) as fh:
        with np.load(io.BytesIO(fh.read())) as z:
            return {k: z[k] for k in z.files}


def _transform_dict(tf) -> dict:
    return {"translation": [float(v) for v in tf.translation], "rotation": [float(v) for v in tf.rotation]}


def save_scene(path: str, scene) -> None:
    """Snapshot a whole Scene into one zip: per spawner its settings (JSON),
    pool arrays, trail arrays and host-side runtime state (transforms,
    parent velocity, modifier, finished latch, seed, nested buffer, render
    layers), the collider and force-field slots with their live handles,
    and the scene's time, seed and next id. A group member's pool and trail
    are read from its row of the group's batch. Event handlers and
    on_finished observers are not serialized (they are code): register them
    again after loading."""
    meta = {
        "time": scene.time,
        "next_id": scene._next_id,
        "seed": scene._seed,
        "spawners": {},
        "force_fields": {
            "slots": [dataclasses.asdict(s) for s in scene._field_slots],
            "ids": {str(k): v for k, v in scene._field_ids.items()},
            "next_id": scene._next_field_id,
        },
        # every slot, disabled ones included (the table's layout), and the
        # live handles, so set/remove_collider edits and ids survive
        "colliders": {
            "slots": [dataclasses.asdict(s) for s in scene._collider_slots],
            "ids": {str(k): v for k, v in scene._collider_ids.items()},
            "next_id": scene._next_collider_id,
        },
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for sid, slot in scene._spawners.items():
            m = meta["spawners"][str(sid)] = {
                "settings": spawner_to_dict(slot.spawner),
                "capacity": slot.capacity,
                "transform": _transform_dict(slot.transform),
                "global_transform": _transform_dict(slot.global_transform),
                "parent_velocity": [float(v) for v in slot.parent_velocity],
                "modifier": {"scale": slot.modifier.scale, "speed": slot.modifier.speed},
                "finished_fired": slot.finished_fired,
                "seed": slot.seed,
                "nested_buffer": slot.compiled.static.nested_m,
                "render_layers": slot.layers,
            }
            if slot.trail_settings is not None:
                m["trail"] = dataclasses.asdict(slot.trail_settings)
                zf.writestr(f"trail_{sid}.npz", _npz_bytes(trail_to_numpy(slot.trail_state)))
            zf.writestr(f"pool_{sid}.npz", _npz_bytes(pool_to_arrays(slot.state)))
        zf.writestr("scene.json", json.dumps(meta))


def load_scene(path: str, colliders=None, device=DEFAULT_DEVICE):
    """Restore a Scene checkpoint on `device` (the card unless "cpu").
    Event handlers and observers are not serialized (see save_scene):
    register them again after loading.

    colliders: an explicit override of the restored collider scene; None
    restores the checkpoint's own colliders (dynamic edits, disabled slots
    and live handles included; checkpoints without collider state restore
    none)."""
    from .scene import Scene, Transform, _ColliderSlot, _FieldSlot

    dev = resolve_device(device)
    scene = Scene(colliders=colliders, device=dev)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("scene.json"))
        cm = meta.get("colliders")
        if colliders is None and cm:
            scene._collider_slots = [
                _ColliderSlot(kind=s["kind"], identity_rot=s["identity_rot"], position=tuple(s["position"]),
                              rotation=tuple(s["rotation"]), params=tuple(s["params"]), layers=s["layers"],
                              active=s["active"], planes=tuple(tuple(p) for p in s.get("planes", ())))
                for s in cm["slots"]
            ]
            scene._collider_ids = {int(k): v for k, v in cm["ids"].items()}
            scene._next_collider_id = cm["next_id"]
            scene._collider_table = None
        scene.time = meta["time"]
        scene._seed = meta["seed"]
        for sid_s, m in meta["spawners"].items():
            sid = int(sid_s)
            # ids may be non-contiguous after removals; restore each through
            # the explicit-id path
            scene.add_spawner(
                spawner_from_dict(m["settings"]),
                capacity=m["capacity"],
                transform=Transform(tuple(m["transform"]["translation"]), tuple(m["transform"]["rotation"])),
                global_transform=Transform(tuple(m["global_transform"]["translation"]),
                                           tuple(m["global_transform"]["rotation"])),
                modifier=EffectModifier(**m["modifier"]),
                sid=sid,
                nested_buffer=m.get("nested_buffer", 4096),  # older checkpoints predate the knob
                trail=TrailSettings(**m["trail"]) if "trail" in m else None,
                layers=m.get("render_layers", 1),
            )
            slot = scene._spawners[sid]
            slot.parent_velocity = tuple(m["parent_velocity"])
            slot.finished_fired = m["finished_fired"]
            slot.seed = m["seed"]
            slot.state = pool_from_arrays(_npz_read(zf, f"pool_{sid}.npz"), dev)
            if "trail" in m:
                slot.trail_state = trail_from_numpy(_npz_read(zf, f"trail_{sid}.npz"), dev)
        scene._next_id = meta["next_id"]
        ffm = meta.get("force_fields")  # absent in checkpoints older than fields
        if ffm:
            scene._field_slots = [
                _FieldSlot(kind=s["kind"], position=tuple(s["position"]), axis=tuple(s["axis"]),
                           strength=s["strength"], radius=s["radius"], frequency=s.get("frequency", 1.0),
                           phase=s.get("phase", 0.0), active=s["active"])
                for s in ffm["slots"]
            ]
            scene._field_ids = {int(k): v for k, v in ffm["ids"].items()}
            scene._next_field_id = ffm["next_id"]
            scene._field_table = None
    return scene

