"""The port's nudge-parity API (`nudge_tpu_torch.api`): the cases of
tests/test_actuation.py and test_checkpoint_api.py's pipeline test, and
the pipeline held against the JAX package's on one carried state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nudge_tpu import api as japi
from nudge_tpu.ops.integrate import apply_position_correction as japc
from nudge_tpu_torch import api
from nudge_tpu_torch.engine import simulate, step
from nudge_tpu_torch.ops.integrate import apply_position_correction
from nudge_tpu_torch.parallel import mesh
from nudge_tpu_torch.scenes import SceneBuilder

from _torch_bridge import (
    POS_ATOL, assert_close, assert_equal, jax_cfg, to_jax_state,
)


def _box_on_ground(**cfg_over):
    b = SceneBuilder()
    b.add_static_box((10, 0.5, 10), (0, -0.5, 0))
    b.add_box((0.5, 0.5, 0.5), (0, 0.495, 0))
    cfg = b.auto_config(**cfg_over)
    return b.finalize(cfg, device="cpu"), cfg


def test_com_impulse_is_linear_kick():
    st, cfg = _box_on_ground()
    bodies = api.apply_impulse(st.bodies, 1, (2.0, 0.0, 0.0))
    assert np.allclose(bodies.vel[1].numpy(), [2.0, 0.0, 0.0])
    # angular untouched without a point of application
    assert np.allclose(bodies.angvel[1].numpy(), 0.0)
    # statics immune (inv_mass 0)
    bodies = api.apply_impulse(bodies, 0, (5.0, 0.0, 0.0))
    assert np.allclose(bodies.vel[0].numpy(), 0.0)
    # the input is left as it was
    assert not bool(st.bodies.vel.any())


def test_offset_impulse_spins():
    st, cfg = _box_on_ground()
    # r x J with r = (0, 0.5, 0), J = (1, 0, 0) is (0, 0, -0.5); identity
    # quaternion, so the kick is inv_inertia_z * -0.5 about z
    p = st.bodies.pos[1].numpy()
    bodies = api.apply_impulse(st.bodies, 1, (1.0, 0.0, 0.0),
                               point=p + np.array([0.0, 0.5, 0.0]))
    ang = bodies.angvel[1].numpy()
    expect_z = float(st.bodies.inv_inertia[1][2]) * -0.5
    assert np.allclose(ang, [0.0, 0.0, expect_z], atol=1e-6), ang
    assert np.allclose(bodies.vel[1].numpy(), [1.0, 0.0, 0.0])


def test_apply_force_is_dt_scaled_impulse():
    st, cfg = _box_on_ground()
    a = api.apply_force(st.bodies, 1, (3.0, 0.0, 0.0), cfg)
    b = api.apply_impulse(st.bodies, 1, (3.0 * cfg.dt, 0.0, 0.0))
    assert np.allclose(a.vel[1].numpy(), b.vel[1].numpy())


def test_kicked_sleeper_wakes_and_moves():
    st, cfg = _box_on_ground(sleeping=True)
    st, _ = simulate(st, cfg, 200)           # settle + fall asleep
    assert not bool(st.sleep.awake[1])
    x0 = float(st.bodies.pos[1, 0])

    st = st.replace(bodies=api.apply_impulse(st.bodies, 1, (4.0, 0.0, 0.0)))
    st = api.wake(st, 1)
    assert bool(st.sleep.awake[1]) and int(st.sleep.idle[1]) == 0
    st, _ = simulate(st, cfg, 30)
    assert float(st.bodies.pos[1, 0]) > x0 + 0.2   # it actually slid
    assert not bool(torch.isnan(st.bodies.pos).any())


def test_actuation_on_a_batch_equals_each_scene():
    """apply_impulse and wake on a batch (one impulse a scene) do to each
    scene what they do to it alone, bit for bit, and to the same
    reference values."""
    st, cfg = _box_on_ground(sleeping=True)
    batch = mesh.make_scene_batch([st, st, st])
    imp = torch.tensor([[1.0, 0.0, 0.5], [0.0, 2.0, 0.0], [-3.0, 0.0, 1.0]])
    point = st.bodies.pos[1] + torch.tensor([0.1, 0.5, -0.2])
    bb = api.apply_impulse(batch.bodies, 1, imp, point=point)
    woke = api.wake(batch.replace(bodies=bb), 1)
    for i in range(3):
        one = api.apply_impulse(st.bodies, 1, imp[i], point=point)
        assert torch.equal(bb.vel[i], one.vel)
        assert torch.equal(bb.angvel[i], one.angvel)
        assert torch.equal(woke.sleep.awake[i], api.wake(st, 1).sleep.awake)
        ref = japi.apply_impulse(to_jax_state(st, jax_cfg(cfg)).bodies, 1,
                                 np.asarray(imp[i]), point=np.asarray(point))
        assert_close(one.angvel, ref.angvel, 1e-6, "angvel")
        assert_close(one.vel, ref.vel, 0.0, "vel")


def _settled_pair():
    """test_checkpoint_api.py's scene after 30 steps."""
    b = SceneBuilder()
    b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    b.add_box((0.5, 0.5, 0.5), (0, 0.45, 0))
    b.add_box((0.5, 0.5, 0.5), (0.2, 1.4, 0))
    cfg = b.auto_config()
    st, _ = simulate(b.finalize(cfg, device="cpu"), cfg, 30)
    return st, cfg


def _pipeline(api_, apc, st, cfg):
    """One step composed from the seven nudge-parity calls."""
    bodies = api_.apply_gravity(st.bodies, st.sleep, cfg)
    contacts, _bp = api_.collide(st, cfg)
    warm, pwarm = api_.read_cached_impulses(st.cache, contacts)
    con, bodies, acc = api_.setup_contact_constraints(
        bodies, contacts, warm, cfg, pwarm=pwarm)
    bodies, acc, pseudo, pseudo_acc = api_.apply_impulses(con, bodies, acc,
                                                          cfg)
    cache = api_.write_cached_impulses(
        contacts, api_.update_cached_impulses(con, acc), pseudo_acc)
    bodies = api_.advance(bodies, st.sleep, cfg)
    if cfg.split_impulse:
        bodies = apc(bodies, pseudo, st.sleep, cfg)
    return bodies, cache


def test_api_pipeline_matches_engine_step():
    """Composing the seven nudge-parity API calls equals engine.step."""
    st, cfg = _settled_pair()
    ref_state, _ = step(st, cfg)
    bodies, cache = _pipeline(api, apply_position_correction, st, cfg)
    assert_close(bodies.pos, ref_state.bodies.pos, 1e-6, "pos")
    assert_close(bodies.vel, ref_state.bodies.vel, 1e-6, "vel")
    assert_equal(cache.ga, ref_state.cache.ga, "cache.ga")


def test_api_pipeline_matches_reference():
    """The port's pipeline and the JAX package's on one carried state:
    integers exact, floats within POS_ATOL."""
    st, cfg = _settled_pair()
    jcfg = jax_cfg(cfg)
    pb, pc = _pipeline(api, apply_position_correction, st, cfg)
    jb, jc = jax.jit(lambda s: _pipeline(japi, japc, s, jcfg))(
        to_jax_state(st, jcfg))
    for f in ("pos", "quat", "vel", "angvel"):
        assert_close(getattr(pb, f), getattr(jb, f), POS_ATOL, f)
    for f in ("ga", "gb", "feat", "valid"):
        assert_equal(getattr(pc, f), getattr(jc, f), f"cache.{f}")
    assert_close(pc.impulse, jc.impulse, POS_ATOL, "cache.impulse")
    assert bool(jnp.any(jc.valid))
