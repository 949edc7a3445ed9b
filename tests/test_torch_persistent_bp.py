"""The port's persistent broadphase against the JAX package: the fat
rebuild, a reuse step, the two-tier compaction under pressure, the rebuild
decision, `collide` with the cache (overflow bit 4 included, sleepers and
dead bodies in the scene), and a port mirror of
tests/test_persistent_bp.py's equivalence with the per-step broadphase."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu.ops import broadphase as jbp
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import persistent_bp as jpbp
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import persistent_bp as ppbp

from _torch_bridge import (
    assert_equal, np_, pressed_mixed_pile, to_port_state,
)

torch.set_num_threads(2)

BP_FIELDS = [f.name for f in dataclasses.fields(ppbp.BPCache)]


def _assert_bp(p, j, what):
    for f in BP_FIELDS:
        assert_equal(getattr(p, f), getattr(j, f), f"{what} bp.{f}")


def _assert_pairs(p, j, what):
    for cls in range(3):
        for f in ("a", "b", "valid", "count"):
            assert_equal(getattr(p[cls], f), getattr(j[cls], f),
                         f"{what} class {cls} {f}")


def _pbp_both(jcfg, pcfg, jst, rebuild=None):
    """persistent_broadphase in both packages on the same state."""
    def jrun(s):
        return jpbp.persistent_broadphase(
            s, jbp.world_colliders(s), jcfg, jcontacts._base_broadphase(jcfg))

    jpairs, jbpc = jax.jit(jrun)(jst)
    pst = to_port_state(jst)
    ppairs, pbpc = ppbp.persistent_broadphase(
        pst, pbp.world_colliders(pst), pcfg, pcontacts._base_broadphase(pcfg),
        rebuild)
    return (jpairs, jbpc), (ppairs, pbpc)


def _moved(jst, dx=0.0, dq=0.0, seed=0):
    """The state with every dynamic body shifted by up to `dx` per axis and
    its quaternion perturbed by up to `dq` (renormalized)."""
    rng = np.random.default_rng(seed)
    pos = np.array(jst.bodies.pos)
    quat = np.array(jst.bodies.quat)
    dyn = np.asarray(jst.bodies.inv_mass) > 0
    pos[dyn] += rng.uniform(-dx, dx, (dyn.sum(), 3)).astype(np.float32)
    quat[dyn] += rng.uniform(-dq, dq, (dyn.sum(), 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return jst.replace(bodies=jst.bodies.replace(pos=jnp.asarray(pos),
                                                 quat=jnp.asarray(quat)))


@pytest.mark.parametrize("case", ["rebuild", "reuse", "pressure"])
def test_persistent_broadphase_matches_reference(case):
    over = dict(persistent_broadphase=True)
    if case == "pressure":          # kept demand past the tight box-box cap
        over.update(max_box_box_pairs=40, fat_pair_factor=8)
    pcfg, jcfg, jst, _ = pressed_mixed_pile(48, **over)
    (jpairs, jbpc), (ppairs, pbpc) = _pbp_both(jcfg, pcfg, jst)
    if case == "reuse":             # the rebuilt cache, bodies nudged
        jst = _moved(jst.replace(bp=jbpc), dx=0.01)
        (jpairs, jbpc), (ppairs, pbpc) = _pbp_both(jcfg, pcfg, jst, False)
        assert not bool(jpbp.needs_rebuild(jst, jcfg))
        assert_equal(jbpc.anchor_pos, jst.bp.anchor_pos, "kept anchors")
    _assert_pairs(ppairs, jpairs, case)
    _assert_bp(pbpc, jbpc, case)
    bb = ppairs[0]
    assert int(bb.valid.sum()) >= min(50, pcfg.max_box_box_pairs)
    assert int(ppairs[1].valid.sum()) > 5
    assert not bool(pbpc.overflow)
    if case == "pressure":
        assert int(bb.count) > pcfg.max_box_box_pairs


@pytest.mark.parametrize("move", ["still", "shifted", "turned"])
def test_needs_rebuild_matches_reference(move):
    """The rebuild decision, on states well away from the threshold (the
    reference's FMA-contracted norms can decide a state on it otherwise)."""
    pcfg, jcfg, jst, _ = pressed_mixed_pile(48, persistent_broadphase=True)
    (_, jbpc), _ = _pbp_both(jcfg, pcfg, jst)
    jst = jst.replace(bp=jbpc)
    jst = {"still": lambda s: _moved(s, dx=0.005),
           "shifted": lambda s: _moved(s, dx=0.2),
           "turned": lambda s: _moved(s, dq=0.2)}[move](jst)
    want = bool(jpbp.needs_rebuild(jst, jcfg))
    assert want == (move != "still")
    assert bool(ppbp.needs_rebuild(to_port_state(jst), pcfg)) == want


def _with_sleepers(jst):
    """Every other dynamic body asleep (the sleepers below the kill plane
    are dead)."""
    dyn = np.asarray(jst.bodies.inv_mass) > 0
    awake = np.ones(dyn.shape, bool)
    awake[np.flatnonzero(dyn)[::2]] = False
    return jst.replace(sleep=jst.sleep.replace(awake=jnp.asarray(awake)))


@pytest.mark.parametrize("case", ["clean", "sleepers_and_dead",
                                  "rebuild_overflow"])
def test_collide_persistent_matches_reference(case):
    over = dict(persistent_broadphase=True)
    if case == "sleepers_and_dead":
        over.update(sleeping=True, kill_plane_y=0.6)
    if case == "rebuild_overflow":  # the fat rebuild drops pairs: bit 4
        over.update(max_box_box_pairs=60, fat_pair_factor=1)
    pcfg, jcfg, jst, _ = pressed_mixed_pile(48, **over)
    if case == "sleepers_and_dead":
        jst = _with_sleepers(jst)
    jman, jbpc = jax.jit(lambda s: jcontacts.collide(s, jcfg))(jst)
    pman, pbpc = pcontacts.collide(to_port_state(jst), pcfg)
    for f in ("body_a", "body_b", "ga", "gb", "valid", "count", "overflow",
              "overflow_bits", "pair_demand", "point_valid", "feat"):
        assert_equal(getattr(pman, f), getattr(jman, f), f"man.{f}")
    pv = np_(jman.point_valid)
    np.testing.assert_allclose(np_(pman.depth)[pv], np.asarray(jman.depth)[pv],
                               rtol=0, atol=1e-5)
    _assert_bp(pbpc, jbpc, case)
    bits = int(pman.overflow_bits)
    assert bool(bits & 16) == (case == "rebuild_overflow")
    assert int(pman.valid.sum()) > 20


def test_persistent_matches_full_rebuild():
    """tests/test_persistent_bp.py's equivalence, at 24 bodies and 30 steps
    (the reference test: 48 bodies, 120 steps): the cached fat set
    re-filters to the same live set, so contacts agree and trajectories
    agree to float rounding (the pair ORDER differs)."""
    b = pscenes.scene_pile(24, seed=3)
    cfg_off = b.auto_config(persistent_broadphase=False)
    cfg_on = b.auto_config(persistent_broadphase=True)
    st_off, m0 = pengine.simulate(b.finalize(cfg_off, device="cpu"),
                                cfg_off, 30)
    rebuilds = ppbp.persistent_broadphase.rebuilds
    st_on, m1 = pengine.simulate(b.finalize(cfg_on, device="cpu"),
                               cfg_on, 30)
    assert 0 < ppbp.persistent_broadphase.rebuilds - rebuilds < 30
    assert int(m0.contact_count[-1]) == int(m1.contact_count[-1]) > 24
    np.testing.assert_allclose(np_(st_off.bodies.pos), np_(st_on.bodies.pos),
                               rtol=0, atol=1e-4)
    assert not bool(m1.overflow.any())
