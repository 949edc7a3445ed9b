"""The port's sphere path against the JAX package's: the box-sphere and
sphere-sphere twins, the sphere classes of both broadphases, the one-point
narrowphase wrapper, and a mixed pile stepped side by side (cached and
fresh coloring). The sphere scenes of tests/test_engine.py run through the
port's engine in test_torch_engine.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import engine as jengine
from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import broadphase as jbp
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import grid as jgrid
from nudge_tpu.ops import narrowphase as jnps
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import grid as pgrid
from nudge_tpu_torch.ops import narrowphase as pnps
from nudge_tpu_torch.ops import narrowphase_1pt as p1pt

from _torch_bridge import (
    POS_ATOL, assert_close, assert_equal, assert_manifolds_match, jax_cfg,
    np_, pressed_mixed_pile, to_port_state,
)

torch.set_num_threads(2)

# The twins are a handful of float32 operations; the reference's XLA
# program contracts multiply-adds into FMAs and sums its dot products in
# its own order, so the two agree to a few ulps.
TWIN_ATOL = 1e-5
IDQ = [0.0, 0.0, 0.0, 1.0]


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _box_sphere_both(h, qa, pa, r, pb):
    """Batched inputs [P,...] through both packages' box_sphere."""
    j = jax.vmap(jnps.box_sphere)(*(jnp.asarray(x, jnp.float32)
                                     for x in (h, qa, pa, r, pb)))
    p = pnps.box_sphere(*(_t(x) for x in (h, qa, pa, r, pb)))
    return j, p


def _assert_1pt(j, p, valid=None):
    assert_equal(p["valid"], j["valid"], "valid")
    for k in ("pos", "normal", "depth"):
        assert_close(p[k], j[k], TWIN_ATOL, k)
    if valid is not None:
        assert_equal(p["valid"], valid, "expected validity")


# the cases of tests/test_narrowphase.py (unit box at the origin)
_BS_CASES = {
    "face": ([0, 0.7, 0], 0.25, True),
    "corner": ([0.6, 0.6, 0.6], 0.25, True),
    "centre_inside": ([0.0, 0.4, 0.0], 0.25, True),
    "separated": ([0, 1.0, 0], 0.25, False),
}


@pytest.mark.parametrize("case", sorted(_BS_CASES))
def test_box_sphere_cases_match_reference(case):
    pb, r, valid = _BS_CASES[case]
    j, p = _box_sphere_both([[0.5] * 3], [IDQ], [[0, 0, 0]], [r], [pb])
    _assert_1pt(j, p, np.array([valid]))
    if case == "centre_inside":
        assert_close(p["normal"], [[0, 1, 0]], 1e-6, "inside normal")
        assert_close(p["depth"], [0.35], 1e-6, "inside depth")


def test_box_sphere_random_matches_reference():
    """Rotated boxes, centres outside, near and inside: every branch."""
    rng = np.random.default_rng(11)
    n = 256
    h = rng.uniform(0.2, 1.0, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pa = rng.uniform(-2, 2, (n, 3))
    pb = pa + rng.uniform(-1.3, 1.3, (n, 3))
    pb[:32] = pa[:32] + rng.uniform(-0.1, 0.1, (32, 3))     # centre inside
    r = rng.uniform(0.1, 0.6, n)
    j, p = _box_sphere_both(h, q, pa, r, pb)
    _assert_1pt(j, p)
    valid = np_(p["valid"])
    assert 32 <= valid.sum() < n


def test_sphere_sphere_matches_reference():
    rng = np.random.default_rng(12)
    n = 256
    pa = rng.uniform(-2, 2, (n, 3))
    pb = pa + rng.uniform(-1, 1, (n, 3))
    pb[0] = pa[0]                                   # coincident centres
    pa[1], pb[1] = [0, 0, 0], [0.7, 0, 0]           # test_narrowphase.py
    ra = rng.uniform(0.1, 0.6, n)
    rb = rng.uniform(0.1, 0.6, n)
    ra[1], rb[1] = 0.5, 0.3
    j = jax.vmap(jnps.sphere_sphere)(*(jnp.asarray(x, jnp.float32)
                                       for x in (ra, pa, rb, pb)))
    p = pnps.sphere_sphere(*(_t(x) for x in (ra, pa, rb, pb)))
    _assert_1pt(j, p)
    assert_close(p["normal"][0], [0, 1, 0], 0, "coincident normal")
    assert_close(p["pos"][1], [0.45, 0, 0], 1e-6, "pos")
    assert 16 < int(p["valid"].sum()) < n


# ---------------------------------------------------------------------------
# mixed piles
# ---------------------------------------------------------------------------

def _mixed(steps):
    """test_sphere_kernel.py's mixed pile (64 bodies, 40% spheres) after
    `steps` JAX steps, in both packages."""
    pb = pscenes.scene_pile(64, sphere_frac=0.4, seed=7)
    pcfg = pb.auto_config()
    jcfg = jax_cfg(pcfg)
    jst = jscenes.scene_pile(64, sphere_frac=0.4, seed=7).finalize(jcfg)
    if steps:
        jst, _ = jengine.simulate(jst, jcfg, steps)
    return pcfg, jcfg, jst, to_port_state(jst)


@pytest.fixture(scope="module")
def mixed20():
    return _mixed(20)


def _pairs(fn, st, wc, cfg):
    return [(x.a, x.b, x.valid, x.count) for x in fn(st, wc, cfg)]


@pytest.mark.parametrize("which", ["mixed20", "pressed"])
def test_grid_matches_allpairs_and_reference_with_spheres(which, request):
    pcfg, jcfg, jst, pst = (request.getfixturevalue("mixed20")
                            if which == "mixed20" else pressed_mixed_pile())
    pwc = pbp.world_colliders(pst)
    jwc = jax.jit(jbp.world_colliders)(jst)
    assert_close(pwc.sph_pos, jwc.sph_pos, 0, "sph_pos")
    assert_equal(pwc.sph_body, jwc.sph_body, "sph_body")
    grid = _pairs(pgrid.grid_broadphase, pst, pwc, pcfg)
    allp = _pairs(pbp.allpairs_broadphase, pst, pwc, pcfg)
    jgr = jax.jit(lambda s, w: _pairs(jgrid.grid_broadphase, s, w, jcfg))(
        jst, jwc)
    jall = jax.jit(lambda s, w: _pairs(jbp.allpairs_broadphase, s, w, jcfg))(
        jst, jwc)
    for cls, name in enumerate(("bb", "bs", "ss")):
        (ga, gb, gv, gc), (aa, ab, av, ac) = grid[cls], allp[cls]
        gset = set(zip(ga[gv].tolist(), gb[gv].tolist()))
        aset = set(zip(aa[av].tolist(), ab[av].tolist()))
        assert gset == aset, name
        assert int(gc) == len(gset) > 0, name
        for k, f in enumerate(("a", "b", "valid", "count")):
            assert_equal(grid[cls][k], jgr[cls][k], f"grid {name}.{f}")
            assert_equal(allp[cls][k], jall[cls][k], f"allpairs {name}.{f}")


@pytest.mark.parametrize("solver", ["xla", "pallas_interpret"])
def test_pairs_1pt_matches_reference(mixed20, solver):
    """The port's narrowphase on the CPU (the one-point twin's rows after
    box-box's) against the JAX narrowphase on the same candidates: its
    vmapped twins, and its Pallas kernel in interpret mode (after
    tests/test_sphere_kernel.py)."""
    pcfg, jcfg, jst, pst = mixed20
    jwc = jax.jit(jbp.world_colliders)(jst)
    bb, bs, ss = jax.jit(lambda s, w: jbp.allpairs_broadphase(s, w, jcfg))(
        jst, jwc)
    assert int(bs.valid.sum()) > 0 and int(ss.valid.sum()) > 0
    jslots = jax.jit(lambda: jcontacts.narrowphase_all(
        jst, jwc, bb, bs, ss, jcfg.replace(solver=solver)))()
    pwc = pbp.world_colliders(pst)
    pbb, pbs, pss = pbp.allpairs_broadphase(pst, pwc, pcfg)
    n0 = p1pt.pairs_1pt_slots_cuda.launches
    pslots = pcontacts.narrowphase_all(pst, pwc, pbb, pbs, pss, pcfg)
    assert p1pt.pairs_1pt_slots_cuda.launches == n0    # the twin ran on CPU
    nbb = bb.a.shape[0]
    assert pbb.a.shape[0] == nbb
    pslots = {k: v[nbb:] for k, v in pslots.items()}
    live = np.asarray(jslots["point_valid"])[nbb:].any(-1)
    assert_equal(np_(pslots["point_valid"]).any(-1), live, "live")
    assert live.sum() > 5
    for k in ("body_a", "body_b", "ga", "gb", "feat", "point_valid",
              "friction", "normal", "pos", "depth"):
        j = np.asarray(jslots[k])[nbb:][live]
        p = np_(pslots[k])[live]
        if j.dtype.kind == "f":
            np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            assert_equal(p, j, k)


@pytest.mark.parametrize("persistent_coloring", [True, False])
def test_mixed_pile_steps_match_reference(persistent_coloring):
    """The slice: a pressed mixed pile stepped in both packages, the
    manifolds slot for slot and the bodies within POS_ATOL."""
    pcfg, jcfg, jst, pst = pressed_mixed_pile(
        persistent_coloring=persistent_coloring)
    jcollide = jax.jit(lambda s: jcontacts.collide(s, jcfg)[0])
    jstep = jax.jit(lambda s: jengine.step(s, jcfg))
    classes = np.zeros(3, int)
    for k in range(4):
        jman = jcollide(jst)
        pman, _ = pcontacts.collide(pst, pcfg)
        assert_manifolds_match(pman, jman, f"step {k}")
        nb = pcfg.max_boxes
        ga, gb = np.asarray(jman.ga), np.asarray(jman.gb)
        v = np.asarray(jman.valid)
        classes += [(v & (gb < nb)).sum(), (v & (ga < nb) & (gb >= nb)).sum(),
                    (v & (ga >= nb)).sum()]
        jst, jm = jstep(jst)
        pst, pm = pengine.step(pst, pcfg)
        assert_close(pst.bodies.pos, jst.bodies.pos, POS_ATOL, f"step {k} pos")
        assert_close(pst.bodies.quat, jst.bodies.quat, POS_ATOL,
                     f"step {k} quat")
        assert_close(pst.bodies.vel, jst.bodies.vel, 10 * POS_ATOL,
                     f"step {k} vel")
        for f in ("contact_count", "spill_count", "overflow_bits",
                  "manifold_demand", "pair_demand"):
            assert_equal(getattr(pm, f), getattr(jm, f), f"step {k} {f}")
        assert not bool(pm.overflow)
    assert (classes > 0).all(), classes        # every class had contacts
