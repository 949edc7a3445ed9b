"""The port's whole step against the JAX engine: a small grid pile stepped
side by side, reference-mode steps (sleeping + persistent broadphase) of a
mixed pile, the all-asleep park, the awake count of a step where a body
falls asleep, config 1 to rest, the sphere scenes of tests/test_engine.py,
determinism, config parity, and the rule that the package never imports
JAX."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nudge_tpu.config as jconfig
from nudge_tpu import engine as jengine
from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import broadphase as jbp
from nudge_tpu.ops import cache as jcache
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import grid as jgrid
from nudge_tpu.ops import integrate as jint
from nudge_tpu.ops import solver as jsolver
from nudge_tpu_torch import config as pconfig
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.parallel import mesh as pmesh
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import cache as pcache
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import grid as pgrid
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import persistent_bp as ppbp
from nudge_tpu_torch.ops import solver as psolver

from _torch_bridge import (
    DROPPED, POS_ATOL, assert_close, assert_equal, jax_cfg, np_,
    pressed_mixed_pile, to_port_state,
)

torch.set_num_threads(2)


def test_config_fields_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.SimConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.SimConfig)}
    assert set(jf) - set(pf) == DROPPED
    assert set(pf) <= set(jf)
    for k, v in pf.items():
        assert v == jf[k], k
    with pytest.raises(ValueError):
        pconfig.SimConfig(solver="pallas")


def test_package_imports_no_jax():
    code = ("import sys, nudge_tpu_torch, nudge_tpu_torch.engine, "
            "nudge_tpu_torch.api, nudge_tpu_torch.envs, "
            "nudge_tpu_torch.parallel.mesh; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("knob", [dict(mesh=object())])
def test_unported_modes_raise(knob):
    """What is still not ported (multi-device sharding) raises instead of
    running a partial path; the differentiable mode runs
    (tests/test_torch_autodiff.py)."""
    b = pscenes.scene_single_box()
    cfg = b.auto_config(differentiable=True)
    st = b.finalize(cfg, device="cpu")
    pengine.step(st, cfg)
    with pytest.raises(NotImplementedError):
        pmesh.megabatch_simulate(cfg, steps=1, **knob)
    with pytest.raises(NotImplementedError):
        pmesh.shard_scene_batch(pmesh.make_scene_batch([st]), **knob)


def _pressed_pile(n=120):
    """A small pile with its layers pressed together (contacts from step 0)
    in both packages, with the grid broadphase."""
    pb = pscenes.scene_pile(n, seed=3, walls=True)
    pcfg = pb.auto_config(broadphase="grid")
    jcfg = jax_cfg(pcfg)
    jst = jscenes.scene_pile(n, seed=3, walls=True).finalize(jcfg)
    pos = np.array(jst.bodies.pos)
    dyn = np.asarray(jst.bodies.inv_mass) > 0
    pos[dyn, 1] = 0.5 + (pos[dyn, 1] - 0.75) * (0.995 / 1.15)
    jst = jst.replace(bodies=jst.bodies.replace(pos=jnp.asarray(pos)))
    return pcfg, jcfg, jst, to_port_state(jst)


def _stages_jax(st, cfg):
    wc = jbp.world_colliders(st)
    bb, _, _ = jgrid.grid_broadphase(st, wc, cfg)
    bodies = jint.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = jcontacts.collide(st, cfg)
    warm, pwarm = jcache.read_cached_impulses(st.cache, man, cfg)
    col, _ = jsolver.color_manifolds_cached(man, bodies, cfg, st.colors)
    return bb, man, warm, pwarm, col


def test_grid_pile_steps_match_reference():
    pcfg, jcfg, jst, pst = _pressed_pile()
    jstages = jax.jit(lambda s: _stages_jax(s, jcfg))
    jstep = jax.jit(lambda s: jengine.step(s, jcfg))
    for k in range(5):
        jbb, jman, jwarm, jpwarm, jcol = jstages(jst)
        wc = pbp.world_colliders(pst)
        pbb, _, _ = pgrid.grid_broadphase(pst, wc, pcfg)
        for f in ("a", "b", "valid", "count", "flags"):
            assert_equal(getattr(pbb, f), getattr(jbb, f), f"step {k} pairs.{f}")
        bodies = pint.apply_gravity(pst.bodies, pst.sleep, pcfg)
        pman, _ = pcontacts.collide(pst, pcfg)
        for f in ("body_a", "body_b", "ga", "gb", "valid", "count", "overflow",
                  "point_valid", "feat"):
            assert_equal(getattr(pman, f), getattr(jman, f), f"step {k} man.{f}")
        pv = np_(jman.point_valid)
        for f in ("depth", "pos"):
            assert_close(np_(getattr(pman, f))[pv],
                         np.asarray(getattr(jman, f))[pv], 1e-5,
                         f"step {k} man.{f}")
        pwarm, ppwarm = pcache.read_cached_impulses(pst.cache, pman, pcfg)
        phit = np_((pwarm != 0).any(-1) | (ppwarm != 0))
        jhit = np.asarray((jwarm != 0).any(-1) | (jpwarm != 0))
        assert_equal(phit, jhit, f"step {k} cache hits")
        if k > 0:
            assert jhit.sum() > 100
        pcol, _ = psolver.color_manifolds_cached(pman, bodies, pcfg,
                                                 pst.colors)
        assert_equal(pcol[0], jcol[0], f"step {k} colors")
        assert_equal(pcol[1], jcol[1], f"step {k} n_colors")

        jst, jm = jstep(jst)
        pst, pm = pengine.step(pst, pcfg)
        assert_close(pst.bodies.pos, jst.bodies.pos, POS_ATOL, f"step {k} pos")
        assert_close(pst.bodies.quat, jst.bodies.quat, POS_ATOL,
                     f"step {k} quat")
        assert_equal(pm.contact_count, jm.contact_count, f"step {k}")
        assert not bool(pm.overflow)


def _assert_states_match(pst, jst, what):
    """Integers and booleans of the whole state bitwise, body floats within
    POS_ATOL."""
    for g in ("sleep", "bp", "cache", "colors"):
        for f in dataclasses.fields(getattr(pst, g)):
            a = getattr(getattr(pst, g), f.name)
            if a.dtype in (torch.int32, torch.bool):
                assert_equal(a, getattr(getattr(jst, g), f.name),
                             f"{what} {g}.{f.name}")
    assert_equal(pst.step_count, jst.step_count, f"{what} step_count")
    for f in ("pos", "quat", "vel", "angvel"):
        assert_close(getattr(pst.bodies, f), getattr(jst.bodies, f), POS_ATOL,
                     f"{what} bodies.{f}")


METRIC_INTS = ("contact_count", "spill_count", "overflow", "awake_count",
               "overflow_bits", "manifold_demand", "pair_demand")


def test_reference_mode_steps_match_reference():
    """Sleeping + persistent broadphase on a pressed 48-body mixed pile
    (boxes, spheres, walls, grid), one step at a time from the JAX state
    carried across: bodies fall asleep island by island, parked pairs
    build up, the cache is rebuilt and reused."""
    pcfg, jcfg, jst, _ = pressed_mixed_pile(
        48, sleeping=True, persistent_broadphase=True, sleep_frames=3)
    jstep = jax.jit(lambda s: jengine.step(s, jcfg))
    rebuilds = 0
    for k in range(6):
        rb0 = ppbp.persistent_broadphase.rebuilds
        pst, pm = pengine.step(to_port_state(jst), pcfg)
        rebuilds += ppbp.persistent_broadphase.rebuilds - rb0
        jst, jm = jstep(jst)
        _assert_states_match(pst, jst, f"step {k}")
        for f in METRIC_INTS:
            assert_equal(getattr(pm, f), getattr(jm, f), f"step {k} {f}")
        assert_close(pm.kinetic_energy, jm.kinetic_energy, 1e-3,
                     f"step {k} KE")
        assert not bool(pm.overflow)
    assert 0 < rebuilds < 6
    assert int(pm.awake_count) < 40
    assert int((pst.sleep.pairs[:, 0] >= 0).sum()) > 5


def _box_at_rest(**over):
    b = pscenes.scene_single_box(0.495)
    pcfg = b.auto_config(sleeping=True, **over)
    jcfg = jax_cfg(pcfg)
    return pcfg, jcfg, jscenes.scene_single_box(0.495).finalize(jcfg)


def test_park_matches_reference():
    """With every dynamic body asleep the step is the park: the state comes
    back unchanged except step_count + 1, with all-zero metrics, as the
    JAX engine's `_step_parked` gives."""
    pcfg, jcfg, jst = _box_at_rest(persistent_broadphase=True)
    jst = jst.replace(sleep=jst.sleep.replace(
        awake=jnp.zeros_like(jst.sleep.awake)))
    pst = to_port_state(jst)
    parked0 = pengine.step.parked
    rebuilds0 = ppbp.persistent_broadphase.rebuilds
    pnew, pm = pengine.step(pst, pcfg)
    jnew, jm = jax.jit(lambda s: jengine.step(s, jcfg))(jst)
    assert pengine.step.parked == parked0 + 1
    assert ppbp.persistent_broadphase.rebuilds == rebuilds0
    for f in dataclasses.fields(pengine.StepMetrics):
        assert_equal(getattr(pm, f.name), getattr(jm, f.name), f.name)
        assert not bool(getattr(pm, f.name))
    assert int(pnew.step_count) == int(pst.step_count) + 1
    for g in ("bodies", "boxes", "spheres", "cache", "sleep", "bp", "colors"):
        for f in dataclasses.fields(getattr(pst, g)):
            a = getattr(getattr(pnew, g), f.name)
            assert torch.equal(a, getattr(getattr(pst, g), f.name)), f.name
            assert_equal(a, getattr(getattr(jnew, g), f.name), f.name)


def test_awake_count_is_read_after_update_sleep():
    """A resting box that qualifies to sleep on this step: the metric
    counts it asleep, as the JAX engine does (read from the sleep state
    the step produced, not the one it started from)."""
    pcfg, jcfg, jst = _box_at_rest(sleep_frames=30)
    jst = jst.replace(sleep=jst.sleep.replace(
        idle=jnp.full_like(jst.sleep.idle, 29)))
    pst, pm = pengine.step(to_port_state(jst), pcfg)
    jst2, jm = jax.jit(lambda s: jengine.step(s, jcfg))(jst)
    assert bool(jst.sleep.awake[1]) and not bool(jst2.sleep.awake[1])
    assert_equal(pst.sleep.awake, jst2.sleep.awake, "awake")
    assert int(pm.awake_count) == int(jm.awake_count) == 0


def test_single_box_settles_like_reference():
    """Config 1 for 500 steps, held to tests/test_engine.py's gates, and the
    final height equal to the JAX engine's own CPU result."""
    b = pscenes.scene_single_box(2.0)
    cfg = b.auto_config()
    st, m = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 500)
    pos = np_(st.bodies.pos[1])
    assert abs(pos[1] - 0.5) <= cfg.slop + 1e-3, pos
    assert np.linalg.norm(np_(st.bodies.vel[1])) < 1e-3
    assert np.linalg.norm(np_(st.bodies.angvel[1])) < 1e-2
    assert np.isfinite(np_(st.bodies.pos)).all()
    assert not bool(m.overflow.any())
    assert float(m.kinetic_energy[-1]) < 1e-5

    jb = jscenes.scene_single_box(2.0)
    jcfg = jb.auto_config()
    jst, _ = jengine.simulate(jb.finalize(jcfg), jcfg, 500)
    assert abs(float(pos[1]) - float(jst.bodies.pos[1, 1])) <= 1e-5


def test_two_runs_are_bitwise_equal():
    pcfg, _, _, pst = _pressed_pile(64)
    a, ma = pengine.simulate(pst, pcfg, 8)
    b, mb = pengine.simulate(pst, pcfg, 8)
    for f in ("pos", "quat", "vel", "angvel"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f
    for f in ("impulse", "pseudo", "valid"):
        assert torch.equal(getattr(a.cache, f), getattr(b.cache, f)), f
    assert torch.equal(ma.kinetic_energy, mb.kinetic_energy)


# tests/test_engine.py's sphere scenes, with its gates. The port's plain
# solve costs ~0.1 s a step on the CPU, so each runs until it has come to
# rest rather than the reference test's 400 / 400 / 200 steps.

def _rollout(b, steps):
    cfg = b.auto_config()
    st, m = pengine.simulate(b.finalize(cfg, device="cpu"), cfg,
                             steps)
    assert not bool(m.overflow.any())
    return cfg, np_(st.bodies.pos)


def _ground():
    b = pscenes.SceneBuilder()
    b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    return b


def test_sphere_rests_on_ground():
    b = _ground()
    b.add_sphere(0.5, (0, 2.0, 0))
    cfg, pos = _rollout(b, 120)
    assert abs(pos[1, 1] - 0.5) <= cfg.slop + 2e-3, pos[1]


def test_sphere_on_box_mixed():
    b = _ground()
    b.add_box((0.5, 0.5, 0.5), (0, 0.5, 0))
    b.add_sphere(0.3, (0, 1.6, 0))
    _, pos = _rollout(b, 120)
    assert abs(pos[1, 1] - 0.5) < 0.02
    assert abs(pos[2, 1] - 1.3) < 0.02
    assert np.isfinite(pos).all()


def test_two_spheres_stack():
    b = _ground()
    b.add_sphere(0.5, (0, 0.5, 0))
    b.add_sphere(0.5, (0.01, 1.5, 0))
    _, pos = _rollout(b, 60)
    assert np.isfinite(pos).all()
    assert pos[1, 1] > 0.45 and pos[2, 1] > 0.45
