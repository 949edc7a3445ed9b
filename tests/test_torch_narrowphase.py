"""The port's box-box narrowphase against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu.ops import narrowphase as jnp_np
from nudge_tpu_torch.ops import narrowphase as pt_np

torch.set_num_threads(2)

# normal / pos / depth tolerance: both sides do the same float32 math, but
# the reference's XLA program contracts multiply-adds into FMAs
ATOL = 1e-5


def by_feature(res):
    """Each pair's points in a canonical order: valid points first, by
    feature id.

    The reduction to 4 points takes argmaxes over scores that tie exactly
    or to within an ulp for symmetric clip polygons (the two free corners of
    a parallelogram, points on a line parallel to the chosen diagonal). The
    reference's XLA program contracts multiply-adds into FMAs and the port
    does not, so such ties resolve by the last bit and may differ: two tied
    points swap slots, or a tied twin point is kept instead. Slots are
    therefore compared as sets keyed by feature id, and the tests bound how
    many pairs may differ at all."""
    key = np.where(res["valid"], res["feat"], 1 << 20)
    order = np.argsort(key, axis=1, kind="stable")
    take = lambda x: np.take_along_axis(  # noqa: E731
        x, order if x.ndim == 2 else order[..., None], axis=1)
    return {k: take(res[k]) for k in ("valid", "feat", "pos", "depth")}


def assert_same_manifolds(p, j, max_tie_pairs=0.02):
    """Validity counts exact for every pair; the feature-id sets exact for
    all but `max_tie_pairs` of the pairs (near-tie choices); points and
    depths of the matching pairs within ATOL."""
    np.testing.assert_array_equal(p["valid"].sum(1), j["valid"].sum(1))
    ps, js = by_feature(p), by_feature(j)
    pv = js["valid"]
    np.testing.assert_array_equal(ps["valid"], pv)
    same = ((ps["feat"] == js["feat"]) | ~pv).all(1)
    assert (~same).mean() <= max_tie_pairs, np.flatnonzero(~same)
    ok = pv & same[:, None]
    np.testing.assert_allclose(ps["pos"][ok], js["pos"][ok], atol=ATOL)
    np.testing.assert_allclose(ps["depth"][ok], js["depth"][ok], atol=ATOL)


def _quat(rng, n, spread=None):
    if spread is None:
        q = rng.normal(size=(n, 4))
    else:
        q = np.concatenate([rng.uniform(-spread, spread, (n, 3)),
                            np.ones((n, 1))], 1)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


def random_pairs(seed=0):
    """~256 box pairs: random overlapping, near-aligned face-face stacks,
    crossed edge-edge configurations, and separated pairs."""
    rng = np.random.default_rng(seed)
    n = 64
    ha = rng.uniform(0.2, 1.0, (4 * n, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 1.0, (4 * n, 3)).astype(np.float32)
    qa = np.empty((4 * n, 4), np.float32)
    qb = np.empty((4 * n, 4), np.float32)
    pa = rng.uniform(-3, 3, (4 * n, 3)).astype(np.float32)
    off = np.empty((4 * n, 3), np.float32)
    # random orientations, centers within reach
    qa[:n], qb[:n] = _quat(rng, n), _quat(rng, n)
    off[:n] = rng.uniform(-1.0, 1.0, (n, 3))
    # face-face: near-identity orientations, B resting on A along y
    qa[n:2 * n], qb[n:2 * n] = _quat(rng, n, 0.05), _quat(rng, n, 0.05)
    off[n:2 * n] = np.stack([
        rng.uniform(-0.3, 0.3, n),
        ha[n:2 * n, 1] + hb[n:2 * n, 1] - rng.uniform(0.0, 0.05, n),
        rng.uniform(-0.3, 0.3, n)], 1)
    # edge-edge: boxes tilted 45 degrees about crossed axes, nearly touching
    for k in range(2 * n, 3 * n):
        qa[k] = _axis_angle([1, 0, 0], np.pi / 4 + rng.uniform(-0.05, 0.05))
        qb[k] = _axis_angle([0, 0, 1], np.pi / 4 + rng.uniform(-0.05, 0.05))
    ha[2 * n:3 * n] = hb[2 * n:3 * n] = 0.5
    off[2 * n:3 * n] = np.stack([
        rng.uniform(-0.05, 0.05, n),
        2 * 0.5 * np.sqrt(2) - rng.uniform(0.0, 0.05, n),
        rng.uniform(-0.05, 0.05, n)], 1)
    # separated
    qa[3 * n:], qb[3 * n:] = _quat(rng, n), _quat(rng, n)
    off[3 * n:] = rng.normal(size=(n, 3)) * 4.0
    off[3 * n:] += np.sign(off[3 * n:]) * 3.0
    pb = (pa + off).astype(np.float32)
    return ha, qa, pa, hb, qb, pb


def _run_both(arrays):
    jres = jax.jit(jax.vmap(jnp_np.box_box))(*map(jnp.asarray, arrays))
    pres = pt_np.box_box(*map(torch.from_numpy, arrays))
    return ({k: np.asarray(v) for k, v in jres.items()},
            {k: v.numpy() for k, v in pres.items()})


def test_box_box_matches_reference():
    arrays = random_pairs(0)
    j, p = _run_both(arrays)
    pv = j["valid"]
    assert pv.any(axis=1).sum() > 120         # plenty of contacts
    assert (j["feat"][pv] >= 1024).any()      # edge-edge cases present
    assert (~pv.any(axis=1)).sum() > 60       # separated pairs present
    has = pv.any(axis=1)
    np.testing.assert_array_equal(p["valid"].any(1), has)
    np.testing.assert_allclose(p["normal"][has], j["normal"][has], atol=ATOL)
    assert_same_manifolds(p, j)


@pytest.mark.parametrize("seed", [1, 2])
def test_box_box_matches_reference_more_seeds(seed):
    j, p = _run_both(random_pairs(seed))
    assert_same_manifolds(p, j)


def test_reduce_manifold_matches_reference():
    rng = np.random.default_rng(3)
    uv = rng.uniform(-1, 1, (64, 24, 2)).astype(np.float32)
    depth = rng.uniform(-0.1, 0.2, (64, 24)).astype(np.float32)
    valid = rng.uniform(size=(64, 24)) < 0.4
    ji, jv = jax.vmap(jnp_np._reduce_manifold)(
        jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(valid))
    pi, pv = pt_np._reduce_manifold(torch.from_numpy(uv),
                                    torch.from_numpy(depth),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    sel = np.asarray(jv)
    np.testing.assert_array_equal(pi.numpy()[sel], np.asarray(ji)[sel])
