"""tests/test_engine.py's golden scenes on the port, on the CPU: the 3-box
stack, the base-4 pyramid, the bitwise repeat on a stack and the overflow
flag with its gates, the stack held to the JAX package's trajectory; and
config 2's small scenes (a 2x2x1 stack, a base-4 pyramid) stepped beside
the JAX engine stage by stage. The friction, frictionless and `connect`
cases are in test_torch_contact.py."""

import jax
import numpy as np
import pytest
import torch

from nudge_tpu import engine as jengine
from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import integrate as jint
from nudge_tpu.ops import solver as jsolver
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import solver as psolver

from _torch_bridge import (
    POS_ATOL, assert_close, assert_equal, assert_manifolds_match, jax_cfg,
    metrics_np, np_, rollout_both, to_port_state,
)

torch.set_num_threads(2)


def _rollout(b, steps, **over):
    cfg = b.auto_config(**over)
    st, m = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, steps)
    return cfg, st, metrics_np(m)


# The port's plain solve costs ~0.1-0.35 s a step on the CPU here, so the
# rollouts below are shorter than the reference tests' (500, 400 and 100
# steps): each runs until its scene has come to rest (the JAX package's
# base-10 pyramid is at slop depth from step ~100 on).

def test_stack_3_boxes_survives():
    """Mini config 2: a 1x3x1 column stays standing, 200 steps. At step 4 a
    4-point reduction meets an exact tie and the two packages keep the
    tied points in swapped slots (the FMA difference, ROADMAP Queue 3),
    so the lateral drift parts by ~2e-3; the contact counts of every step
    stay equal and the resting heights within 1e-4."""
    _, st, m, jst, jm = rollout_both(
        lambda S: S.scene_stack(nx=1, ny=3, nz=1), 200)
    pos = np_(st.bodies.pos[1:4])
    np.testing.assert_allclose(pos[:, 1], [0.5, 1.5, 2.5], atol=0.05)
    assert np.abs(pos[:, [0, 2]]).max() < 0.08, pos
    assert not m["overflow"].any()
    for f in ("contact_count", "overflow", "manifold_demand", "pair_demand"):
        assert_equal(m[f], jm[f], f)
    assert_close(pos[:, 1], np.asarray(jst.bodies.pos)[1:4, 1], POS_ATOL, "y")


def test_pyramid_survives():
    """A base-4 pyramid, 120 steps: its top box near its start (ten
    bodies: the rollouts part, the gates alone apply)."""
    _, st, m = _rollout(pscenes.scene_pyramid(base=4), 120)
    pos = np_(st.bodies.pos[1:11])
    assert np.isfinite(pos).all()
    top = pos[-1]
    assert abs(top[1] - (0.5 + 3 * 1.001)) < 0.1, top
    assert abs(top[0]) < 0.15 and abs(top[2]) < 0.15
    assert not m["overflow"].any()


def test_determinism_bitwise():
    b = pscenes.scene_stack(nx=2, ny=2, nz=1)
    cfg = b.auto_config()
    st1, m1 = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 50)
    st2, m2 = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 50)
    for f in ("pos", "quat", "vel", "angvel"):
        assert torch.equal(getattr(st1.bodies, f), getattr(st2.bodies, f)), f
    assert torch.equal(m1.kinetic_energy, m2.kinetic_energy)
    assert int(m1.contact_count[-1]) > 0


def test_overflow_flag_not_corruption():
    """Tiny manifold capacity: the overflow flag raises (bit 3, the
    compaction), the state stays finite."""
    _, st, m = _rollout(pscenes.scene_stack(nx=2, ny=2, nz=2), 50,
                        max_manifolds=4)
    assert m["overflow"].any()
    assert (m["overflow_bits"] & 8).any()
    assert np.isfinite(np_(st.bodies.pos)).all()


def _stages_jax(st, cfg):
    bodies = jint.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = jcontacts.collide(st, cfg)
    col, _ = jsolver.color_manifolds_cached(man, bodies, cfg, st.colors)
    return man, col


@pytest.mark.parametrize("scene,steps", [
    ("stack_2x2x1", 12), ("pyramid_4", 10),
])
def test_config2_scene_steps_match_reference(scene, steps):
    """Config 2's scenes at the reference tests' sizes, each package
    stepped on its own from the same state: every step's manifolds
    (integers exactly, each manifold's points matched by feature id,
    depths and points to 1e-5), colors and contact count, and the bodies
    within POS_ATOL."""
    fn, kw = {"stack_2x2x1": ("scene_stack", dict(nx=2, ny=2, nz=1)),
              "pyramid_4": ("scene_pyramid", dict(base=4))}[scene]
    pcfg = getattr(pscenes, fn)(**kw).auto_config()
    jcfg = jax_cfg(pcfg)
    jst = getattr(jscenes, fn)(**kw).finalize(jcfg)
    pst = to_port_state(jst)
    jstages = jax.jit(lambda s: _stages_jax(s, jcfg))
    jstep = jax.jit(lambda s: jengine.step(s, jcfg))
    contacts = 0
    for k in range(steps):
        jman, jcol = jstages(jst)
        bodies = pint.apply_gravity(pst.bodies, pst.sleep, pcfg)
        pman, _ = pcontacts.collide(pst, pcfg)
        assert_manifolds_match(pman, jman, f"step {k}")
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
        contacts = int(pm.contact_count)
    assert contacts >= 4 * (4 if scene == "stack_2x2x1" else 10)
