"""Nested-fold configurations and checks shared by the port's tests and
chip_smoke.py (imports torch and the port only, so the card's tests and
chip_smoke can use it without JAX).

bench.py's two nested cells' spawners, and the fold's checks: the seed's
count kernels and the step launch's fold epilogue (kernel row 10) against
their plain version (`step.nested_fold_counts`) on the state each read,
and a folded chain (`multi_step_auto`) against the unfolded one
(`chain_hybrid_unfolded`), every pool field, output and nested count bit
for bit, also across chains with the emitters' enabled bits toggled
between them."""

import dataclasses

import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.compiled import MODE_GLOBAL
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.pool import POOL_FIELDS
from bevy_firework_tpu_torch.step import nested_emitters, nested_fold_counts, nested_lane_counts


def bench_nested(chained: bool):
    """bench.py's `_measure_nested` (2 types, rockets at 4000/s, 10 children
    each over the parent's life) or `_measure_nested_chained` (3 stages)
    spawner."""
    if not chained:
        return pt.ParticleSpawner(
            particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(2.0), linear_drag=0.1),
                               pt.ParticleSettings(lifetime=pt.RandF32.constant(2.0), linear_drag=0.3)],
            emission_settings=[
                pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(4000.0),
                                    initial_velocity=pt.RandVec3(pt.RandF32(2.0, 6.0), (0, 1, 0), 0.5)),
                pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                    emission_pacing=pt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 1.0),
                                    initial_velocity=pt.RandVec3(pt.RandF32(0.2, 1.0), (0, 1, 0), 3.14),
                                    inherit_parent_velocity=True)])
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(1.5), linear_drag=0.2),
                           pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0), linear_drag=0.3),
                           pt.ParticleSettings(lifetime=pt.RandF32.constant(0.5), linear_drag=0.5)],
        emission_settings=[
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(2000.0),
                                initial_velocity=pt.RandVec3(pt.RandF32(3.0, 8.0), (0, 1, 0), 0.4)),
            pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                emission_pacing=pt.EmissionPacing.count_over_duration(8.0, 1.0, 0.0, 1.0),
                                inherit_parent_velocity=True),
            pt.EmissionSettings(particle_index=2, emission_mode=pt.EmissionMode.nested(1),
                                emission_pacing=pt.EmissionPacing.count_over_duration(3.0, 1.0, 0.1, 0.9),
                                inherit_parent_velocity=True)])


def det_nested(destroy: bool = False, chained: bool = False):
    """chip_smoke.py's nested_det spawner: a rocket emitter at 1e5/s with
    constant draws and nested children (box offsets, random speeds, no
    spread: no sinf/cosf), chained grandchildren optional; with `destroy`
    the rockets fall on a floor (`DET_FLOOR`: dead-rank claim, cum mode)."""
    col = pt.ParticleCollisionSettings(restitution=0.5, friction=0.2, destroy_on_collision=True) if destroy else None
    types = [pt.ParticleSettings(lifetime=pt.RandF32.constant(0.6), linear_drag=0.1, collision_settings=col,
                                 acceleration=(0.0, -9.81 if destroy else 0.0, 0.0)),
             pt.ParticleSettings(lifetime=pt.RandF32(0.3, 0.5), linear_drag=0.2, acceleration=(0.0, -2.0, 0.0)),
             pt.ParticleSettings(lifetime=pt.RandF32.constant(0.4), linear_drag=0.3)]
    child = dict(emission_shape=pt.EmissionShape.box((0.1, 0.2, 0.1)),
                 initial_velocity=pt.RandVec3(pt.RandF32(0.1, 0.9), (0.0, 1.0, 0.0), 0.0),
                 initial_velocity_radial=pt.RandF32(0.2, 1.0), inherit_parent_velocity=True)
    ems = [pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(1e5),
                               initial_velocity=pt.RandVec3.constant((0.3, 2.0, 0.1))),
           pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                               emission_pacing=pt.EmissionPacing.count_over_duration(6.0, 1.0, 0.1, 1.0), **child)]
    if chained:
        ems.append(pt.EmissionSettings(particle_index=2, emission_mode=pt.EmissionMode.nested(1),
                                       emission_pacing=pt.EmissionPacing.count_over_duration(3.0, 1.0, 0.2, 0.9),
                                       **child))
    return pt.ParticleSpawner(particle_settings=types[:3 if chained else 2], emission_settings=ems)


DET_FLOOR = [pt.Collider.halfspace(position=(0.0, -0.2, 0.0))]


def burst_nested():
    """A ring archetype whose nested emitter asks for a parent's 10 children
    at once (a window of 0.001 of its life) from 1000 new rockets a frame:
    every frame's total exceeds a 1024-rank child buffer many times over,
    the deferral carries the rest, and the first tile of waiting parents
    owns every rank (at least 256)."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0)),
                           pt.ParticleSettings(lifetime=pt.RandF32.constant(0.5), linear_drag=0.3)],
        emission_settings=[
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(60000.0),
                                initial_velocity=pt.RandVec3.constant((0.3, 2.0, 0.1))),
            pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                emission_pacing=pt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 0.001),
                                emission_shape=pt.EmissionShape.box((0.1, 0.2, 0.1)),
                                initial_velocity=pt.RandVec3(pt.RandF32(0.1, 0.9), (0.0, 1.0, 0.0), 0.0),
                                inherit_parent_velocity=True)])


def tile_ranks(cum: torch.Tensor, M: int) -> int:
    """The most child ranks below M that one TILE-lane tile's parents own,
    from the inclusive count cumsum of a cadence pass."""
    n = cum.shape[0]
    ends = cum[torch.arange(L.TILE - 1, n + L.TILE - 1, L.TILE, device=cum.device).clamp_max(n - 1)].clamp_max(M)
    return int((ends - torch.cat([ends.new_zeros(1), ends[:-1]])).max())


def lane_tile_counts(static, params, e: int, alive, ptype, age, lifetime, le_row, gate) -> torch.Tensor:
    """The per-tile parent counts a folded frame carries into its nested
    stage (the fold epilogue's share) for these cadence inputs:
    `step.nested_lane_counts` summed per TILE-lane tile, int32."""
    counts = nested_lane_counts(static, params, e, alive, ptype, age, lifetime, le_row, gate)[0]
    n_tiles = -(-counts.shape[0] // L.TILE)
    padded = torch.zeros(n_tiles * L.TILE, dtype=torch.int32, device=counts.device)
    padded[:counts.shape[0]] = counts
    return padded.view(n_tiles, L.TILE).sum(-1, dtype=torch.int32)


def check_carry(static, params, state, carry, label: str) -> list:
    """A card `FoldCarry` against the plain version on `state`, the state
    its counts were taken on: each nested emitter's per-tile counts bit for
    bit, NS_ANY, and the next frame's records still zero. Returns each
    emitter's total."""
    totals = []
    any_alive = None
    for j, e in enumerate(nested_emitters(static)):
        want, any_alive = nested_fold_counts(static, params, state, e)
        assert torch.equal(carry.counts[j], want), f"{label}: emitter {e}'s tile counts differ"
        totals.append(int(want.sum()))
    assert int(carry.ns[L.NS_ANY]) == int(any_alive), f"{label}: NS_ANY {int(carry.ns[L.NS_ANY])}"
    assert not bool(carry.ns[L.NS_AT:].any()), f"{label}: the next frame's NS records are not zero"
    return totals


def check_fold_epilogue(c, state, frame, colliders=None, label: str = "fold"):
    """One folded frame on the card from `state`: the seed's count kernels
    against the plain counts on `state`, then the frame's fold epilogue
    against the plain counts on the launch's own post-frame state. Returns
    (post-frame state, {"seed_totals", "fold_totals"})."""
    seed = fs._seed_nested_carry(c.static, c.params, state)
    seed_totals = check_carry(c.static, c.params, state, seed, f"{label} seed")
    new, _o, nxt = fs.fused_step_hybrid(c.static, c.params, colliders, state, frame, stats=False, nested_carry=seed,
                                        fold_out=True)
    return new, {"seed_totals": seed_totals,
                 "fold_totals": check_carry(c.static, c.params, new, nxt, f"{label} epilogue")}


def check_folded_equals_unfolded(c, state, frame, n: int, colliders=None, label: str = "chain"):
    """n frames of `multi_step_auto` (folded where `can_fold_nested`) against
    `chain_hybrid_unfolded` from `state`: every pool field and every output
    with torch.equal. Returns the folded chain's (state, outputs)."""
    a, oa = fs.multi_step_auto(c.static, c.params, colliders, state, frame, n)
    b, ob = fs.chain_hybrid_unfolded(c.static, c.params, colliders, state, frame, n)
    assert_chains_equal(a, oa, b, ob, label)
    return a, oa


def assert_chains_equal(a, oa, b, ob, label: str):
    """Two chains' final states and last outputs equal, every field with
    torch.equal."""
    for k in POOL_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), f"{label}: {k} differs"
    for f in dataclasses.fields(oa):
        assert torch.equal(getattr(oa, f.name), getattr(ob, f.name)), f"{label}: outputs.{f.name} differs"


TOGGLES = ((True, True), (True, False), (False, True), (True, True))  # (global, nested) enabled per chain


def check_enabled_toggles(c, state, frame, n: int, colliders=None) -> list:
    """Four chains of n frames, the enabled bits of the first global and the
    first nested emitter set per chain (`TOGGLES`) between them: each chain
    folded == unfolded. The fold gates its counts on the nested emitter's
    post-frame enabled bit alone, the unfolded pass on active() & enabled;
    they count the same lanes. Returns the per-type live counts after each
    chain."""
    g = c.static.mode_kinds.index(MODE_GLOBAL)
    e = nested_emitters(c.static)[0]
    live = []
    for i, (on_g, on_e) in enumerate(TOGGLES):
        enabled = state.enabled.clone()
        enabled[g], enabled[e] = on_g, on_e
        state = dataclasses.replace(state, enabled=enabled)
        state, out = check_folded_equals_unfolded(c, state, frame, n, colliders, f"toggle chain {i} {(on_g, on_e)}")
        live.append(out.alive_count_per_type.tolist())
    return live
