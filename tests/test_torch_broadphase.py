"""The port's scenes and broadphases against the JAX package's: the same
pile must finalize to the same arrays and yield the same candidate pairs;
and tests/test_grid.py's big ground and connection filter on the port."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import broadphase as jbp
from nudge_tpu.ops import grid as jgrid
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import grid as pgrid
from nudge_tpu_torch.state import state_to_numpy

from _torch_bridge import (
    DROPPED, assert_equal, jax_cfg, np_, to_port_state, tree,
)

torch.set_num_threads(2)


def _pile(n, spacing, **over):
    """The same pile built by both packages, with the port's config."""
    jb = jscenes.scene_pile(n, seed=1, spacing=spacing, walls=True)
    pb = pscenes.scene_pile(n, seed=1, spacing=spacing, walls=True)
    pcfg = pb.auto_config(**over)
    return jb, pb, pcfg


def _scene(name):
    """The JAX and the port SceneBuilder of one scene: a pile of n bodies
    (walls, spacing 1.15) or config 2's stack and pyramid, at full size and
    at the sizes of the reference's tests."""
    if isinstance(name, int):
        return (jscenes.scene_pile(name, seed=1, spacing=1.15, walls=True),
                pscenes.scene_pile(name, seed=1, spacing=1.15, walls=True))
    fn, kw = {"stack": ("scene_stack", {}),
              "stack_1x3x1": ("scene_stack", dict(nx=1, ny=3, nz=1)),
              "stack_2x2x1": ("scene_stack", dict(nx=2, ny=2, nz=1)),
              "stack_2x2x2": ("scene_stack", dict(nx=2, ny=2, nz=2)),
              "pyramid": ("scene_pyramid", {}),
              "pyramid_4": ("scene_pyramid", dict(base=4))}[name]
    return getattr(jscenes, fn)(**kw), getattr(pscenes, fn)(**kw)


@pytest.mark.parametrize("n", [64, 300, "stack", "stack_1x3x1",
                               "stack_2x2x1", "stack_2x2x2", "pyramid",
                               "pyramid_4"])
def test_scene_finalizes_like_reference(n):
    jb, pb = _scene(n)
    pcfg = pb.auto_config()
    jcfg = jb.auto_config()
    for f in dataclasses.fields(jcfg):
        if f.name not in DROPPED:
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    jt = tree(jb.finalize(jcfg))
    pt = to_port_state(jb.finalize(jcfg))      # the bridge itself
    own = pb.finalize(pcfg, device="cpu")
    back = state_to_numpy(own)
    for group in ("bodies", "boxes", "spheres", "cache", "sleep", "bp",
                  "colors"):
        for k in back[group]:        # the bp memo fields are not ported
            v = jt[group][k]
            assert_equal(getattr(getattr(own, group), k), v, f"{group}.{k}")
            assert_equal(getattr(getattr(pt, group), k), v, f"{group}.{k}")
            assert_equal(back[group][k], v, f"{group}.{k}")
            assert back[group][k].dtype == v.dtype, f"{group}.{k}"
            assert back[group][k].shape == v.shape, f"{group}.{k}"
    for k in ("connections", "step_count"):
        assert_equal(back[k], jt[k], k)
        assert back[k].shape == jt[k].shape, k


def _pairs_both(n, spacing, broadphase):
    jb, pb, pcfg = _pile(n, spacing, broadphase=broadphase)
    jcfg = jax_cfg(pcfg)
    jst = jb.finalize(jcfg)
    pst = to_port_state(jst)
    fn_j = {"allpairs": jbp.allpairs_broadphase,
            "grid": jgrid.grid_broadphase}[broadphase]
    fn_p = {"allpairs": pbp.allpairs_broadphase,
            "grid": pgrid.grid_broadphase}[broadphase]
    jbb, _, _ = jax.jit(lambda s: fn_j(s, jbp.world_colliders(s), jcfg))(jst)
    pbb, _, _ = fn_p(pst, pbp.world_colliders(pst), pcfg)
    return jbb, pbb


@pytest.mark.parametrize("broadphase,n,spacing", [
    ("allpairs", 64, 0.97), ("allpairs", 200, 1.0),
    ("grid", 64, 0.97), ("grid", 300, 0.97), ("grid", 300, 1.15),
])
def test_pairs_match_reference(broadphase, n, spacing):
    jbb, pbb = _pairs_both(n, spacing, broadphase)
    assert int(jbb.count) > 0
    assert_equal(pbb.valid, jbb.valid, "valid")
    assert_equal(pbb.a, jbb.a, "a")
    assert_equal(pbb.b, jbb.b, "b")
    assert_equal(pbb.count, jbb.count, "count")
    assert_equal(pbb.flags, jbb.flags, "flags")


def test_grid_overflow_flags_match_reference():
    """Tight density and expand budgets: the overflow bits must agree."""
    jb, pb, pcfg = _pile(300, 0.97, broadphase="grid", grid_density=2,
                         grid_expand_cap=600, max_box_box_pairs=64)
    jcfg = jax_cfg(pcfg)
    jst = jb.finalize(jcfg)
    pst = to_port_state(jst)
    jbb, _, _ = jax.jit(lambda s: jgrid.grid_broadphase(
        s, jbp.world_colliders(s), jcfg))(jst)
    pbb, _, _ = pgrid.grid_broadphase(pst, pbp.world_colliders(pst), pcfg)
    assert int(jbb.flags) == 7
    assert_equal(pbb.flags, jbb.flags, "flags")
    assert_equal(pbb.count, jbb.count, "count")
    assert_equal(pbb.a, jbb.a, "a")
    assert_equal(pbb.b, jbb.b, "b")


def test_compact_mask_matches_reference():
    rng = np.random.default_rng(0)
    mask = rng.uniform(size=1000) < 0.3
    for cap in (10, 300, 1200):
        ji, jv, jc = jbp.compact_mask(jax.numpy.asarray(mask), cap)
        pi, pv, pc = pbp.compact_mask(torch.from_numpy(mask), cap)
        assert_equal(pi, ji)
        assert_equal(pv, jv)
        assert_equal(pc, jc)


def _pair_set(cp):
    v = np_(cp.valid)
    return set(zip(np_(cp.a)[v].tolist(), np_(cp.b)[v].tolist()))


def test_grid_handles_big_ground():
    """The ground slab goes through the grid's big-collider channel and
    still pairs with every box on it, as all-pairs finds (40 steps of the
    drop; 120 in the reference test: the bottom layer lands by step ~15)."""
    b = pscenes.scene_pile(64)
    cfg = b.auto_config(pairs_per_box=16.0)
    st, _ = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 40)
    wc = pbp.world_colliders(st)
    ap = _pair_set(pbp.allpairs_broadphase(st, wc, cfg)[0])
    gp = _pair_set(pgrid.grid_broadphase(st, wc, cfg)[0])
    ground_a = {p for p in ap if 0 in p}
    ground_g = {p for p in gp if 0 in p}
    assert ground_a == ground_g
    assert len(ground_g) >= 16


def test_grid_connection_filter():
    b = pscenes.SceneBuilder()
    g = b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    x = b.add_box((0.5, 0.5, 0.5), (0, 0.3, 0))
    b.connect(g, x)
    cfg = b.auto_config(broadphase="grid")
    st = b.finalize(cfg, device="cpu")
    bb, _, _ = pgrid.grid_broadphase(st, pbp.world_colliders(st), cfg)
    assert _pair_set(bb) == set()
    # and without the connection the pair is there
    b2 = pscenes.SceneBuilder()
    b2.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    b2.add_box((0.5, 0.5, 0.5), (0, 0.3, 0))
    st2 = b2.finalize(cfg, device="cpu")
    bb2, _, _ = pgrid.grid_broadphase(st2, pbp.world_colliders(st2), cfg)
    assert _pair_set(bb2) == {(0, 1)}
