"""The port's whole step against the JAX engine: a small grid pile stepped
side by side, config 1 to rest, determinism, config parity, and the rule
that the package never imports JAX."""

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
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import cache as pcache
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import grid as pgrid
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import solver as psolver

from _torch_bridge import (
    DROPPED, assert_close, assert_equal, jax_cfg, np_, to_port_state,
)

torch.set_num_threads(2)

# positions after a few steps: every stage agrees to float32 rounding (the
# reference contracts multiply-adds into FMAs), the solve's 20 sweeps grow
# that to ~1e-6, and a step integrates it once
POS_ATOL = 1e-4


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
    code = ("import sys, nudge_tpu_torch, nudge_tpu_torch.engine; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("knob", [
    dict(sleeping=True), dict(persistent_broadphase=True),
    dict(differentiable=True), dict(max_spheres=8)])
def test_unported_modes_raise(knob):
    b = pscenes.scene_single_box()
    cfg = b.auto_config(**knob)
    st = b.finalize(cfg)
    with pytest.raises(NotImplementedError):
        pengine.step(st, cfg)


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
        pman = pcontacts.collide(pst, pcfg)
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


def test_single_box_settles_like_reference():
    """Config 1 for 500 steps, held to tests/test_engine.py's gates, and the
    final height equal to the JAX engine's own CPU result."""
    b = pscenes.scene_single_box(2.0)
    cfg = b.auto_config()
    st, m = pengine.simulate(b.finalize(cfg), cfg, 500)
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
