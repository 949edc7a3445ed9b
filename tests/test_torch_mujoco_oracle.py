"""The MuJoCo oracle cross-check of tests/test_mujoco_oracle.py on the
port: the same scenes, steps and bands, MuJoCo's side computed the same
way. MuJoCo solves soft constraints, the port sequential impulses with a
slop, so the comparisons are bands, not bitwise: a dropped box or sphere
rests on the ground at about its half extent or radius in both engines,
and a small stack settles to layer heights near 2 * half per layer in
both. The reference marks its cases slow (its jitted rollouts compile);
the port's 600 CPU steps of these few bodies take seconds, so these run
with the tier-1 tests."""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from nudge_tpu_torch.engine import simulate  # noqa: E402
from nudge_tpu_torch.scenes import SceneBuilder  # noqa: E402

HALF = 0.5
DT = 1.0 / 120.0  # MuJoCo's default integrator prefers small steps
STEPS = 600


def _mj_run(xml):
    model = mujoco.MjModel.from_xml_string(xml)
    data = mujoco.MjData(model)
    for _ in range(STEPS):
        mujoco.mj_step(model, data)
    return data


def _mj_box_stack(n_layers):
    bodies = "\n".join(
        f'<body name="b{i}" pos="0 0 {HALF + 2 * HALF * i + 0.01 * (i + 1)}">'
        f'<freejoint/><geom type="box" size="{HALF} {HALF} {HALF}" '
        f'mass="1" friction="0.5 0.005 0.0001"/></body>'
        for i in range(n_layers))
    data = _mj_run(f"""
    <mujoco>
      <option timestep="{DT}" gravity="0 0 -9.81"/>
      <worldbody>
        <geom type="plane" size="20 20 1" friction="0.5 0.005 0.0001"/>
        {bodies}
      </worldbody>
    </mujoco>""")
    # z of each body (MuJoCo: qpos[7i+2]), gravity along -z
    return np.array([data.qpos[7 * i + 2] for i in range(n_layers)])


def _port_box_stack(n_layers):
    b = SceneBuilder()
    b.add_static_box((20, 0.5, 20), (0, -0.5, 0))
    for i in range(n_layers):
        b.add_box((HALF, HALF, HALF),
                  (0, HALF + 2 * HALF * i + 0.01 * (i + 1), 0))
    cfg = b.auto_config(dt=DT)
    st, _ = simulate(b.finalize(cfg, device="cpu"), cfg, STEPS)
    # bodies.pos is capacity-padded; rows 1..n_layers are the stack (y-up)
    return st.bodies.pos[1:n_layers + 1, 1].numpy()


def test_single_box_drop_matches_mujoco():
    mj = _mj_box_stack(1)
    nd = _port_box_stack(1)
    assert abs(mj[0] - HALF) < 0.02
    assert abs(nd[0] - HALF) < 0.02
    assert abs(mj[0] - nd[0]) < 0.03


def _mj_sphere_drop(radius):
    data = _mj_run(f"""
    <mujoco>
      <option timestep="{DT}" gravity="0 0 -9.81"/>
      <worldbody>
        <geom type="plane" size="20 20 1" friction="0.5 0.005 0.0001"/>
        <body name="s" pos="0 0 1.5"><freejoint/>
          <geom type="sphere" size="{radius}" mass="1"
                friction="0.5 0.005 0.0001"/></body>
      </worldbody>
    </mujoco>""")
    return float(data.qpos[2])


def _port_sphere_drop(radius):
    b = SceneBuilder()
    b.add_static_box((20, 0.5, 20), (0, -0.5, 0))
    b.add_sphere(radius, (0, 1.5, 0))
    cfg = b.auto_config(dt=DT)
    st, _ = simulate(b.finalize(cfg, device="cpu"), cfg, STEPS)
    return float(st.bodies.pos[1, 1])


def test_sphere_drop_matches_mujoco():
    """Config 3's geometry (the one-point box-sphere narrowphase) against
    the oracle."""
    r = 0.4
    mj = _mj_sphere_drop(r)
    nd = _port_sphere_drop(r)
    assert abs(mj - r) < 0.02
    assert abs(nd - r) < 0.02
    assert abs(mj - nd) < 0.03


def test_stack_settle_matches_mujoco():
    n = 3
    mj = _mj_box_stack(n)
    nd = _port_box_stack(n)
    expect = HALF + 2 * HALF * np.arange(n)
    # per-layer rest heights within a band of the ideal stack in both
    assert np.abs(mj - expect).max() < 0.05
    assert np.abs(nd - expect).max() < 0.05
    # rest penetration (height deficit per interface) comparable
    assert np.abs(mj - nd).max() < 0.06
