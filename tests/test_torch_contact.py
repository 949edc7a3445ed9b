"""tests/test_engine.py's solver behaviour cases on the port, on the CPU:
friction stops a sliding box, a frictionless box keeps sliding, and
`connect` suppresses contact; each held to the JAX package's trajectory
from the same scene code.

The port's plain solve costs ~0.06 s a step on the CPU here, so the
friction case runs 120 steps, not the reference test's 300 (the box stops
by step ~31)."""

import numpy as np
import torch

from _torch_bridge import assert_same_trajectory, np_, rollout_both

torch.set_num_threads(2)


def _slab(S, friction):
    b = S.SceneBuilder()
    b.add_static_box((50, 0.5, 50), (0, -0.5, 0), friction=friction)
    return b


def test_box_slides_down_then_friction_stops_it():
    """A box on the ground at 3 m/s, friction 0.6: stopped after ~31 steps
    and ~0.76 m."""
    def scene(S):
        b = _slab(S, friction=0.6)
        b.add_box((0.5, 0.5, 0.5), (0, 0.5, 0), vel=(3.0, 0, 0), friction=0.6)
        return b

    _, st, m, jst, jm = rollout_both(scene, 120)
    assert np.linalg.norm(np_(st.bodies.vel[1])) < 5e-2
    assert 0.4 < float(st.bodies.pos[1, 0]) < 1.2
    assert_same_trajectory(st, m, jst, jm)


def test_frictionless_box_keeps_sliding():
    def scene(S):
        b = _slab(S, friction=0.0)
        b.add_box((0.5, 0.5, 0.5), (0, 0.5, 0), vel=(2.0, 0, 0), friction=0.0)
        return b

    _, st, m, jst, jm = rollout_both(scene, 120)
    np.testing.assert_allclose(np_(st.bodies.vel[1, 0]), 2.0, atol=0.05)
    assert_same_trajectory(st, m, jst, jm)


def test_connections_suppress_contact():
    """Connected bodies interpenetrate: no contact ever forms, the box
    falls through the ground."""
    def scene(S):
        b = S.SceneBuilder()
        ground = b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
        box = b.add_box((0.5, 0.5, 0.5), (0, 0.3, 0))   # in the ground
        b.connect(ground, box)
        return b

    _, st, m, jst, jm = rollout_both(scene, 30)
    assert m["contact_count"].max() == 0
    assert float(st.bodies.pos[1, 1]) < 0.0
    assert_same_trajectory(st, m, jst, jm)
