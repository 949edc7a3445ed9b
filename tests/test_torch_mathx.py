"""tests/test_mathx.py, tests/test_integrate.py's ballistic and frozen
cases and tests/test_property.py's two properties, on the port: each
reference test's own checks, and the port's values held to the JAX
package's on the same inputs (float32 math agrees to a few ulps: the
reference's XLA program contracts multiply-adds into FMAs)."""

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from nudge_tpu import mathx as jm
from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import integrate as jint
from nudge_tpu_torch import mathx as m
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import cache as pcache
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import narrowphase as pnp

from _torch_bridge import assert_close, jax_cfg, np_, to_port_state

torch.set_num_threads(2)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def rand_quat(rng, shape=()):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_cross_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    got = np_(m.cross(_t(a), _t(b)))
    np.testing.assert_allclose(got, np.cross(a, b), atol=1e-5)
    assert_close(got, jm.cross(a, b), ATOL)


def test_quat_rotate_matches_matrix():
    rng = np.random.default_rng(1)
    q = rand_quat(rng, (64,))
    v = rng.normal(size=(64, 3)).astype(np.float32)
    R = np_(m.quat_to_mat(_t(q)))
    got = np_(m.quat_rotate(_t(q), _t(v)))
    np.testing.assert_allclose(got, np.einsum("nij,nj->ni", R, v), atol=1e-5)
    assert_close(got, jm.quat_rotate(q, v), ATOL)
    assert_close(R, jm.quat_to_mat(q), ATOL)


def test_quat_mul_composes_rotation():
    rng = np.random.default_rng(2)
    q1, q2 = rand_quat(rng, (16,)), rand_quat(rng, (16,))
    v = rng.normal(size=(16, 3)).astype(np.float32)
    q12 = m.quat_mul(_t(q1), _t(q2))
    lhs = m.quat_rotate(q12, _t(v))
    rhs = m.quat_rotate(_t(q1), m.quat_rotate(_t(q2), _t(v)))
    np.testing.assert_allclose(np_(lhs), np_(rhs), atol=1e-5)
    assert_close(q12, jm.quat_mul(q1, q2), ATOL)


def test_quat_rotate_inv_roundtrip():
    rng = np.random.default_rng(3)
    q = rand_quat(rng, (16,))
    v = rng.normal(size=(16, 3)).astype(np.float32)
    back = m.quat_rotate_inv(_t(q), m.quat_rotate(_t(q), _t(v)))
    np.testing.assert_allclose(np_(back), v, atol=1e-5)
    assert_close(m.quat_rotate_inv(_t(q), _t(v)), jm.quat_rotate_inv(q, v),
                 ATOL)


def test_quat_integrate_small_step_matches_axis_angle():
    """ω about z for 100 steps of dt: the axis-angle rotation."""
    q = m.quat_identity()
    jq = jm.quat_identity()
    omega = torch.tensor([0.0, 0.0, 2.0])
    for _ in range(100):
        q = m.quat_integrate(q, omega, 1e-3)
        jq = jm.quat_integrate(jq, jnp.asarray(np_(omega)), 1e-3)
    expected = m.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]), 0.2)
    np.testing.assert_allclose(np_(q), np_(expected), atol=1e-3)
    assert_close(q, jq, ATOL)
    assert_close(expected, jm.quat_from_axis_angle(
        jnp.array([0.0, 0.0, 1.0]), 0.2), ATOL)


def test_quat_from_axis_angle_rotates():
    q = m.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]), np.pi / 2)
    v = torch.tensor([1.0, 0.0, 0.0])
    np.testing.assert_allclose(np_(m.quat_rotate(q, v)), [0.0, 1.0, 0.0],
                               atol=1e-6)


def test_orthonormal_basis():
    rng = np.random.default_rng(4)
    n = m.normalize(_t(rng.normal(size=(128, 3))))
    t1, t2 = m.orthonormal_basis(n)
    for a, b in ((t1, n), (t2, n), (t1, t2)):
        np.testing.assert_allclose(np_(m.dot(a, b)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np_(m.norm(t1)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np_(m.norm(t2)), 1.0, atol=1e-5)
    # right-handed: t1 × t2 = n
    np.testing.assert_allclose(np_(m.cross(t1, t2)), np_(n), atol=1e-4)
    jt1, jt2 = jm.orthonormal_basis(jnp.asarray(np_(n)))
    assert_close(t1, jt1, ATOL)
    assert_close(t2, jt2, ATOL)


def _ballistic_states():
    """tests/test_integrate.py's scene: a box at y=3 moving at 1 m/s in x
    above a slab, in both packages from the JAX package's state."""
    def scene(S):
        b = S.SceneBuilder()
        b.add_static_box((10, 0.5, 10), (0, -0.5, 0))
        b.add_box((0.5, 0.5, 0.5), (0, 3.0, 0), vel=(1.0, 0.0, 0.0))
        return b

    pcfg = scene(pscenes).auto_config()
    jcfg = jax_cfg(pcfg)
    jst = scene(jscenes).finalize(jcfg)
    return pcfg, jcfg, jst, to_port_state(jst)


def test_advance_ballistic():
    """60 steps of gravity and advance: the discrete ballistic sum, the
    ground fixed, the quaternion unit, and the JAX package's positions."""
    cfg, jcfg, jst, pst = _ballistic_states()
    bodies, jbodies = pst.bodies, jst.bodies
    n = 60
    for _ in range(n):
        bodies = pint.advance(pint.apply_gravity(bodies, pst.sleep, cfg),
                              pst.sleep, cfg)
        jbodies = jint.advance(jint.apply_gravity(jbodies, jst.sleep, jcfg),
                               jst.sleep, jcfg)
    t = n * cfg.dt
    g = cfg.gravity[1]
    y_expected = 3.0 + g * cfg.dt * cfg.dt * (n * (n + 1) / 2)
    np.testing.assert_allclose(np_(bodies.pos[1, 1]), y_expected, rtol=1e-4)
    np.testing.assert_allclose(np_(bodies.pos[1, 0]), 1.0 * t, rtol=1e-5)
    np.testing.assert_allclose(np_(bodies.pos[0]), [0, -0.5, 0])
    np.testing.assert_allclose(np.linalg.norm(np_(bodies.quat[1])), 1.0,
                               atol=1e-5)
    for f in ("pos", "quat", "vel", "angvel"):
        assert_close(getattr(bodies, f), getattr(jbodies, f), ATOL, f)


def test_asleep_bodies_frozen():
    cfg, _, _, pst = _ballistic_states()
    sleep = pst.sleep.replace(awake=torch.zeros_like(pst.sleep.awake))
    bodies = pint.advance(pint.apply_gravity(pst.bodies, sleep, cfg), sleep,
                          cfg)
    assert torch.equal(bodies.pos, pst.bodies.pos)
    assert torch.equal(bodies.vel, pst.bodies.vel)


# --- tests/test_property.py: the SAT oracle and the cache join ---------------

def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _sat_margin_oracle(ha, qa, pa, hb, qb, pb):
    """Max separation over the 15 normalized candidate axes; > 0 means
    separated. Brute force: project both boxes onto every axis."""
    Ra, Rb = _quat_to_mat_np(qa), _quat_to_mat_np(qb)
    d = pb - pa
    axes = [Ra[:, i] for i in range(3)] + [Rb[:, i] for i in range(3)]
    for i in range(3):
        for j in range(3):
            c = np.cross(Ra[:, i], Rb[:, j])
            n = np.linalg.norm(c)
            if n > 1e-6:
                axes.append(c / n)
    best = -np.inf
    for ax in axes:
        ra = np.sum(ha * np.abs(ax @ Ra))
        rb = np.sum(hb * np.abs(ax @ Rb))
        best = max(best, abs(ax @ d) - (ra + rb))
    return best


unit = st.floats(-1.0, 1.0, allow_nan=False)
halfext = st.floats(0.2, 1.5, allow_nan=False)
coord = st.floats(-2.5, 2.5, allow_nan=False)


def _norm_quat(q):
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q)
    if n < 1e-3:
        return np.array([0.0, 0.0, 0.0, 1.0])
    return q / n


@settings(max_examples=60, deadline=None)
@given(ha=st.tuples(halfext, halfext, halfext),
       hb=st.tuples(halfext, halfext, halfext),
       qa=st.tuples(unit, unit, unit, unit),
       qb=st.tuples(unit, unit, unit, unit),
       pb=st.tuples(coord, coord, coord))
def test_box_box_matches_sat_oracle(ha, hb, qa, qb, pb):
    """The port's box-box twin against a brute-force separating-axis
    oracle: contact iff not separated, and shallow depths that track the
    SAT penetration."""
    ha = np.asarray(ha, np.float32)
    hb = np.asarray(hb, np.float32)
    qa = _norm_quat(qa).astype(np.float32)
    qb = _norm_quat(qb).astype(np.float32)
    pa = np.zeros(3, np.float32)
    pb = np.asarray(pb, np.float32)
    margin = _sat_margin_oracle(ha, qa, pa, hb, qb, pb)
    if abs(margin) < 2e-3:
        return  # numerically ambiguous boundary; both answers acceptable
    out = pnp.box_box(*[_t(x)[None] for x in (ha, qa, pa, hb, qb, pb)])
    valid = np_(out["valid"])[0]
    if margin > 0:
        assert not valid.any(), f"oracle separated by {margin:.4f}"
    else:
        assert valid.any(), f"oracle penetrating by {-margin:.4f}"
        if -margin < 0.1:
            depth = np_(out["depth"])[0]
            assert depth[valid].max() <= 1.15 * -margin + 2e-2


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_cache_join_permutation_invariant(data):
    """The warm-start join on (gid_a, gid_b, feature) keys does not depend
    on the cache's row order; hits return the cached impulse, misses 0."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31 - 1)))
    n_cache = data.draw(st.integers(1, 40))
    n_cur = data.draw(st.integers(1, 40))
    keys = rng.choice(500, size=min(n_cache, 500), replace=False)
    ga = (keys // 25).astype(np.int32)
    gb = ((keys // 5) % 5).astype(np.int32)
    feat = (keys % 5).astype(np.int32)
    imp = rng.normal(size=(len(keys), 3)).astype(np.float32)
    c_valid = rng.random(len(keys)) < 0.8
    k_keys = rng.choice(500, size=min(n_cur, 500), replace=False)
    k_ga = (k_keys // 25).astype(np.int32)
    k_gb = ((k_keys // 5) % 5).astype(np.int32)
    k_feat = (k_keys % 5).astype(np.int32)
    k_valid = rng.random(len(k_keys)) < 0.9

    def run(order):
        return np_(pcache._join(
            *[torch.from_numpy(np.ascontiguousarray(x[order]))
              for x in (ga, gb, feat, imp, c_valid)],
            *[torch.from_numpy(x) for x in (k_ga, k_gb, k_feat, k_valid)]))

    base = run(np.arange(len(keys)))
    np.testing.assert_array_equal(base, run(rng.permutation(len(keys))))
    lut = {(int(a), int(b), int(f)): v
           for a, b, f, v, ok in zip(ga, gb, feat, imp, c_valid) if ok}
    for i in range(len(k_keys)):
        expect = lut.get((int(k_ga[i]), int(k_gb[i]), int(k_feat[i])))
        if not k_valid[i] or expect is None:
            np.testing.assert_array_equal(base[i], np.zeros(3, np.float32))
        else:
            np.testing.assert_array_equal(base[i], expect)
