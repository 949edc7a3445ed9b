"""The port's coloring, constraint setup and solve against the JAX
package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import integrate as jint
from nudge_tpu.ops import solver as jsolver
from nudge_tpu.state import ColorCache as JColorCache
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import setup_kernel, solver_kernel
from nudge_tpu_torch.ops import solver as psolver
from nudge_tpu_torch.state import empty_color_cache

from _torch_bridge import (
    assert_close, assert_equal, jax_cfg, port_manifolds, to_port_state,
)

torch.set_num_threads(2)

# Setup is a fixed sequence of float32 operations: both sides agree to a
# few ulps (the reference contracts multiply-adds into FMAs).
SETUP_ATOL = 1e-5
# The solve runs 20 Gauss-Seidel sweeps; ulp-level differences of the
# operands and of the reference's FMA contraction grow through the sweeps.
SOLVE_ATOL = 1e-4


def _scene(n=150, **over):
    """A pile whose layers are pressed together: columns of boxes resting on
    each other and on the ground with ~5 mm penetration, so the step-0
    contacts are the stacked face-face manifolds of a settling pile."""
    pb = pscenes.scene_pile(n, seed=2, walls=True)
    pcfg = pb.auto_config(**over)
    jcfg = jax_cfg(pcfg)
    jst = jscenes.scene_pile(n, seed=2, walls=True).finalize(jcfg)
    pos = np.array(jst.bodies.pos)
    dyn = np.asarray(jst.bodies.inv_mass) > 0
    pos[dyn, 1] = 0.5 + (pos[dyn, 1] - 0.75) * (0.995 / 1.15)
    jst = jst.replace(bodies=jst.bodies.replace(pos=jnp.asarray(pos)))
    pst = to_port_state(jst)
    jbodies = jint.apply_gravity(jst.bodies, jst.sleep, jcfg)
    pbodies = pint.apply_gravity(pst.bodies, pst.sleep, pcfg)
    jman, _ = jax.jit(lambda s: jcontacts.collide(s, jcfg))(jst)
    return pcfg, jcfg, jbodies, pbodies, jman, port_manifolds(jman)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _assert_coloring(pc, jc):
    color, n_colors, relax, spill, _ = pc
    assert_equal(color, jc[0], "color")
    assert_equal(n_colors, jc[1], "n_colors")
    assert_equal(relax, jc[2], "relax")
    assert_equal(spill, jc[3], "spill")


@pytest.mark.parametrize("max_colors", [24, 2])
def test_color_manifolds_matches_reference(scene, max_colors):
    pcfg, jcfg, jb, pb, jman, pman = scene
    pcfg = pcfg.replace(max_colors=max_colors)
    jcfg = jcfg.replace(max_colors=max_colors)
    jc = jsolver.color_manifolds(jman, jb, jcfg)
    pc = psolver.color_manifolds(pman, pb, pcfg)
    _assert_coloring(pc, jc)
    if max_colors == 2:
        assert int(jc[3]) > 0            # the spill path ran
        assert int(pc[4]) >= 0           # and the port names its color
    else:
        assert int(jc[3]) == 0


def _jax_color_cache(pcache):
    return JColorCache(**{f.name: jnp.asarray(getattr(pcache, f.name).numpy())
                          for f in dataclasses.fields(JColorCache)})


@pytest.mark.parametrize("max_colors", [24, 2])
def test_color_manifolds_cached_matches_reference(scene, max_colors):
    pcfg, jcfg, jb, pb, jman, pman = scene
    pcfg = pcfg.replace(max_colors=max_colors)
    jcfg = jcfg.replace(max_colors=max_colors)
    pcc = empty_color_cache(pcfg)
    jcc = _jax_color_cache(pcc)
    # first frame from an empty cache, then a frame that hits the cache for
    # most manifolds and misses for the ones whose order changed
    for frame in range(2):
        jc, jcc2 = jsolver.color_manifolds_cached(jman, jb, jcfg, jcc)
        pc, pcc2 = psolver.color_manifolds_cached(pman, pb, pcfg, pcc)
        _assert_coloring(pc, jc)
        for f in dataclasses.fields(JColorCache):
            assert_equal(getattr(pcc2, f.name), getattr(jcc2, f.name), f.name)
        jcc, pcc = jcc2, pcc2
        if frame == 0:
            # drop every 7th cached row: those manifolds must recolor
            keep = torch.ones_like(pcc.valid)
            keep[::7] = False
            pcc = pcc.replace(valid=pcc.valid & keep)
            jcc = _jax_color_cache(pcc)
    if max_colors == 2:
        assert int(jc[3]) > 0


def test_round_hash_wraps_like_int32():
    for c in range(30):
        h = (jnp.int32(c + 1) * jnp.uint32(0x9E3779B9).astype(jnp.int32))
        h = (h ^ (h >> 13)) * jnp.uint32(0x85EBCA6B).astype(jnp.int32)
        assert psolver.round_hash(c) == int(h & jnp.int32(0x3FFFFF))


def _warm(pman, seed=0):
    rng = np.random.default_rng(seed)
    m = pman.valid.shape[0]
    warm = (rng.normal(size=(m, 4, 3)) * 0.2).astype(np.float32)
    warm[..., 1] = np.abs(warm[..., 1]) + 0.05
    pwarm = rng.uniform(0, 0.05, size=(m, 4)).astype(np.float32)
    return warm, pwarm


CON_FIELDS = ("t1", "t2", "ra", "rb", "jna", "jnb", "jt1a", "jt1b", "jt2a",
              "jt2b", "mn", "mt1", "mt2", "bias", "pos_bias", "pwarm", "im_a",
              "im_b", "relax")


def _setup_both(scene, max_colors=24):
    pcfg, jcfg, jb, pb, jman, pman = scene
    pcfg = pcfg.replace(max_colors=max_colors)
    jcfg = jcfg.replace(max_colors=max_colors)
    warm, pwarm = _warm(pman)
    jcol = jsolver.color_manifolds(jman, jb, jcfg)
    pcol = psolver.color_manifolds(pman, pb, pcfg)
    jcon, jb2, jacc = jsolver.setup_constraints(
        jb, jman, jnp.asarray(warm), jcfg, coloring=jcol,
        pwarm=jnp.asarray(pwarm))
    pcon, pb2, pacc = psolver.setup_constraints(
        pb, pman, torch.from_numpy(warm), pcfg, coloring=pcol,
        pwarm=torch.from_numpy(pwarm))
    return pcfg, jcfg, (jcon, jb2, jacc), (pcon, pb2, pacc)


def test_setup_constraints_matches_reference(scene):
    _, _, (jcon, jb2, jacc), (pcon, pb2, pacc) = _setup_both(scene)
    for k in CON_FIELDS:
        assert_close(getattr(pcon, k), getattr(jcon, k), SETUP_ATOL, k)
    for k in ("color", "n_colors", "point_valid", "valid", "spill_count"):
        assert_equal(getattr(pcon, k), getattr(jcon, k), k)
    for a, b, k in zip(pacc, jacc, ("acc_n", "acc_t1", "acc_t2")):
        assert_close(a, b, SETUP_ATOL, k)
    assert_close(pb2.vel, jb2.vel, SETUP_ATOL, "vel")
    assert_close(pb2.angvel, jb2.angvel, SETUP_ATOL, "angvel")
    assert float(np.abs(np.asarray(jacc[0])).max()) > 0.01   # warm start ran


@pytest.mark.parametrize("max_colors", [24, 2])
def test_solve_matches_reference(scene, max_colors):
    pcfg, jcfg, (jcon, jb2, jacc), (pcon, pb2, pacc) = _setup_both(
        scene, max_colors)
    jb3, jacc3, jpseudo, jpacc = jsolver.solve(jb2, jcon, jacc, jcfg)
    pb3, pacc3, ppseudo, ppacc = psolver.solve(pb2, pcon, pacc, pcfg)
    assert_close(pb3.vel, jb3.vel, SOLVE_ATOL, "vel")
    assert_close(pb3.angvel, jb3.angvel, SOLVE_ATOL, "angvel")
    for a, b, k in zip(pacc3, jacc3, ("acc_n", "acc_t1", "acc_t2")):
        assert_close(a, b, SOLVE_ATOL, k)
    assert_close(ppseudo[0], jpseudo[0], SOLVE_ATOL, "pseudo vel")
    assert_close(ppseudo[1], jpseudo[1], SOLVE_ATOL, "pseudo angvel")
    assert_close(ppacc, jpacc, SOLVE_ATOL, "pseudo acc")
    assert_close(psolver.accumulated_world_impulse(pcon, pacc3),
                 jsolver.accumulated_world_impulse(jcon, jacc3), SOLVE_ATOL,
                 "world impulse")
    if max_colors == 2:
        assert int(jcon.spill_count) > 0


def test_wrappers_take_the_twins_on_cpu(scene):
    """setup_kernel.setup / solver_kernel.solve on CPU tensors are exactly
    the twins, and launch nothing."""
    pcfg, _, _, pb, _, pman = scene
    warm, pwarm = (torch.from_numpy(x) for x in _warm(pman))
    col = psolver.color_manifolds(pman, pb, pcfg)
    n0, n1 = setup_kernel.setup.launches, solver_kernel.solve.launches
    con, velw, acc = setup_kernel.setup(pb, pman, warm, pcfg, col, pwarm)
    velw2, acc2, pacc2 = solver_kernel.solve(velw, con, acc, pcfg)
    assert (setup_kernel.setup.launches, solver_kernel.solve.launches) == (n0, n1)
    con_t, b2, acc_t = psolver.setup_constraints(pb, pman, warm, pcfg,
                                                 coloring=col, pwarm=pwarm)
    b3, acc3, (pv, pw), pacc3 = psolver.solve(b2, con_t, acc_t, pcfg)
    assert torch.equal(velw2, torch.cat([b3.vel, b3.angvel, pv, pw], 1))
    for a, b in zip(acc2 + (pacc2,), acc3 + (pacc3,)):
        assert torch.equal(a, b)
