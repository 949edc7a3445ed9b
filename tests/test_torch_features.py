"""tests/test_features.py on the port, on the CPU: restitution, the
multi-collider body, the coloring invariant and the persistent coloring's
hits. Scenes of one body are also held to the JAX package's trajectory
from the same scene code.

The port's plain solve costs ~0.06-0.4 s a step on the CPU here, so the
rollouts that run past the scene's coming to rest are shorter than the
reference tests' (each says by how much)."""

import numpy as np
import torch

from nudge_tpu import engine as jengine
from nudge_tpu import scenes as jscenes
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import cache as pcache
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import solver as psolver
from nudge_tpu_torch.state import empty_color_cache
from nudge_tpu_torch.utils.debug import coloring_conflicts, finite_state

from _torch_bridge import assert_same_trajectory, jax_cfg, np_, rollout_both

torch.set_num_threads(2)


def _slab(S):
    b = S.SceneBuilder()
    b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    return b


def _windows(step, st, n, k):
    """`n` windows of `k` steps of `step`; the state and the largest
    height of body 1 at the windows' ends."""
    peak = 0.0
    for _ in range(n):
        st, _ = step(st, k)
        peak = max(peak, float(np.asarray(st.bodies.pos)[1, 1]))
    return st, peak


def test_restitution_bounce():
    """e=0.8: a sphere dropped from y=3 bounces above 1.0; e=0: it stops
    dead. The reference test tracks the bounce over 10 windows of 15 steps
    after the impact (~step 43); the peak comes ~35 steps after it, so 4
    windows here, and 120 steps, not 240, for e=0 (at rest by step ~60)."""
    def scene(S):
        b = _slab(S)
        b.add_sphere(0.5, (0, 3.0, 0))
        return b

    pb = scene(pscenes)
    cfg = pb.auto_config(restitution=0.8)
    jcfg = jax_cfg(cfg)
    st = pb.finalize(cfg, device="cpu")
    jst = scene(jscenes).finalize(jcfg)
    # 60 steps to the impact, then 4 windows, all of 15 steps
    st, _ = _windows(lambda s, k: pengine.simulate(s, cfg, k), st, 4, 15)
    jst, _ = _windows(lambda s, k: jengine.simulate(s, jcfg, k), jst, 4, 15)
    st, peak = _windows(lambda s, k: pengine.simulate(s, cfg, k), st, 4, 15)
    jst, jpeak = _windows(lambda s, k: jengine.simulate(s, jcfg, k), jst, 4,
                          15)
    assert peak > 1.0, f"restitution bounce too low: {peak}"
    assert abs(peak - jpeak) < 1e-4
    np.testing.assert_allclose(np_(st.bodies.pos), np.asarray(jst.bodies.pos),
                               rtol=0, atol=1e-4)

    _, st0, m0, jst0, jm0 = rollout_both(scene, 120, restitution=0.0)
    assert abs(float(st0.bodies.pos[1, 1]) - 0.5) < 0.02
    assert_same_trajectory(st0, m0, jst0, jm0)


def test_multi_collider_body_local_transforms():
    """A rigid dumbbell, one body with two boxes at local offsets, rests on
    its two feet and stays level (200 steps; 400 in the reference test, at
    rest by step ~100)."""
    def scene(S):
        b = _slab(S)
        half = np.array([0.4, 0.4, 0.4], np.float32)
        body = b.add_body((0, 1.2, 0), inv_mass=1.0 / 2.0,
                          inv_inertia=S.box_inertia_inv(
                              2.0, np.array([1.4, 0.4, 0.4])))
        b.attach_box(body, half, lpos=(-1.0, 0, 0))
        b.attach_box(body, half, lpos=(+1.0, 0, 0))
        return b

    _, st, m, jst, jm = rollout_both(scene, 200)
    pos, quat = np_(st.bodies.pos[1]), np_(st.bodies.quat[1])
    assert abs(pos[1] - 0.4) < 0.02, pos
    assert abs(quat[0]) < 0.05 and abs(quat[2]) < 0.05
    assert finite_state(st)
    assert_same_trajectory(st, m, jst, jm)


def test_coloring_conflict_free_invariant():
    """After a mixed pile's drop (40 steps; 100 in the reference test) no
    color writes a dynamic body twice, outside the spill color."""
    b = pscenes.scene_pile(64, sphere_frac=0.25, seed=5)
    cfg = b.auto_config()
    st, _ = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 40)
    bodies = pint.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = pcontacts.collide(st, cfg)
    warm, pwarm = pcache.read_cached_impulses(st.cache, man, cfg)
    con, _, _ = psolver.setup_constraints(bodies, man, warm, cfg, pwarm=pwarm)
    assert int(man.valid.sum()) > 30
    assert int(con.spill_count) == 0
    assert int(coloring_conflicts(con, st.bodies)) == 0


def test_persistent_coloring_hits_reuse_colors():
    """A second coloring of the same contact set returns the cached colors
    verbatim and stays conflict-free (40 steps of the pile; 60 in the
    reference test)."""
    from types import SimpleNamespace

    b = pscenes.scene_pile(32, seed=4)
    cfg = b.auto_config()
    st, _ = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 40)
    man, _ = pcontacts.collide(st, cfg)
    cold, cache1 = psolver.color_manifolds_cached(
        man, st.bodies, cfg, empty_color_cache(cfg, device="cpu"))
    warm, _ = psolver.color_manifolds_cached(man, st.bodies, cfg, cache1)
    assert torch.equal(cold[0], warm[0])
    assert int(cold[3]) == 0
    assert int(man.valid.sum()) > 10
    con = SimpleNamespace(color=warm[0], body_a=man.body_a,
                          body_b=man.body_b, valid=man.valid)
    assert int(coloring_conflicts(con, st.bodies)) == 0
