"""The port's scenes and broadphases against the JAX package's: the same
pile must finalize to the same arrays and yield the same candidate pairs."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import broadphase as jbp
from nudge_tpu.ops import grid as jgrid
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import grid as pgrid
from nudge_tpu_torch.state import state_to_numpy

from _torch_bridge import DROPPED, assert_equal, jax_cfg, to_port_state, tree

torch.set_num_threads(2)


def _pile(n, spacing, **over):
    """The same pile built by both packages, with the port's config."""
    jb = jscenes.scene_pile(n, seed=1, spacing=spacing, walls=True)
    pb = pscenes.scene_pile(n, seed=1, spacing=spacing, walls=True)
    pcfg = pb.auto_config(**over)
    return jb, pb, pcfg


@pytest.mark.parametrize("n", [64, 300])
def test_scene_finalizes_like_reference(n):
    jb, pb, pcfg = _pile(n, 1.15)
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
