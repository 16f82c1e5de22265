"""The system under test, built from a benchmark configuration through the
port's public API: the spawner from its serde form, the colliders, the
pool and the frame input. The pool's state is read back as plain tensors
for the judge."""

from __future__ import annotations

import dataclasses

LANE_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "initial_scale", "age", "lifetime")


@dataclasses.dataclass
class Program:
    bt: object  # the port's package
    compiled: object
    colliders: object  # a ColliderTable or None
    capacity: int
    translation: tuple
    rotation: tuple

    @property
    def static(self):
        return self.compiled.static

    @property
    def params(self):
        return self.compiled.params


def collider(bt, c: dict):
    """The port's Collider for a configuration's collider entry."""
    kind = c["kind"]
    kw = dict(position=tuple(c["position"]), layers=int(c.get("layers", 0xFFFFFFFF)))
    if kind == "cuboid":
        return bt.Collider.cuboid(tuple(c["params"]), rotation=tuple(c["rotation"]), **kw)
    if kind == "sphere":
        return bt.Collider.sphere(c["params"][0], **kw)
    if kind == "halfspace":
        return bt.Collider.halfspace(rotation=tuple(c["rotation"]), **kw)
    raise ValueError(f"no collider kind {kind!r} in the benchmark's configurations")


def build(config: dict, device) -> Program:
    """The port's objects for `config` on `device`."""
    import bevy_firework_tpu_torch as bt

    spawner = bt.spawner_from_dict(config["spawner"])
    rate = config.get("rate")
    counts = {e.emission_pacing.count for e in spawner.emission_settings}
    if rate is not None and counts != {float(rate)}:
        raise ValueError(f"the configuration's rate {rate} is not its spawner's ({sorted(counts)})")
    compiled = bt.compile_spawner(spawner, device=device)
    cols = [collider(bt, c) for c in config.get("colliders", ())]
    table = bt.compile_colliders(cols, device=device) if cols else None
    tf = config["transform"]
    return Program(bt, compiled, table, int(config["capacity"]), tuple(tf["translation"]), tuple(tf["rotation"]))


def pool_seed(seed: int) -> int:
    """The pool's key is (0, seed mod 2^32)."""
    return int(seed) & 0xFFFFFFFF


def state_dict(state) -> dict:
    """A PoolState's lanes and scalars as the judge reads them (the lane
    planes stay on the device)."""
    out = {k: getattr(state, k) for k in LANE_FIELDS}
    out["alive"] = state.alive
    out["time_in_cycle"] = state.time_in_cycle.float().cpu().numpy()
    out["last_emission"] = state.last_emission.float().cpu().numpy()
    out["ring_cursor"] = int(state.ring_cursor)
    out["rng_key"] = tuple(int(v) & 0xFFFFFFFF for v in state.rng_key.tolist())
    return out

