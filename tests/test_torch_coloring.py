"""The port's greedy coloring rounds against the JAX package's: the plain
`color_rounds` against the Pallas coloring kernel (interpret mode) and the
whole fresh coloring against the reference's XLA loop, at 24 colors and at
4, where most manifolds spill. Colors are integers: every comparison is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu.ops import coloring_kernel as jck
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import integrate as jint
from nudge_tpu.ops import solver as jsolver
from nudge_tpu_torch.ops import coloring_kernel as pck
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import solver as psolver

from _torch_bridge import (
    assert_equal, np_, port_manifolds, pressed_mixed_pile,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    """The manifolds of a pressed ~120-body mixed pile, in both packages."""
    pcfg, jcfg, jst, pst = pressed_mixed_pile()
    jb = jint.apply_gravity(jst.bodies, jst.sleep, jcfg)
    pb = pint.apply_gravity(pst.bodies, pst.sleep, pcfg)
    jman, _ = jax.jit(lambda s: jcontacts.collide(s, jcfg))(jst)
    assert int(jman.count) > 100
    return pcfg, jcfg, jb, pb, jman, port_manifolds(jman)


def _inputs(pb, pman):
    return (pman.body_a, pman.body_b, pman.valid, pb.inv_mass > 0.0,
            pb.pos.shape[0])


@pytest.mark.parametrize("max_colors", [24, 4])
def test_color_rounds_match_pallas_kernel(scene, max_colors):
    """Raw colors: the port's plain rounds against
    `color_manifolds_pallas(interpret=True)`, mapped as the reference's
    solver.color_manifolds maps them (max_colors and invalid -> -1)."""
    _, _, jb, pb, jman, pman = scene
    dyn = jb.inv_mass > 0.0
    jraw = jck.color_manifolds_pallas(jman.body_a, jman.body_b, jman.valid,
                                      dyn, jb.pos.shape[0], max_colors,
                                      interpret=True)
    jraw = jnp.where(jraw == max_colors, -1, jraw)
    jraw = jnp.where(jman.valid, jraw, -1)
    praw = pck.color_rounds_plain(*_inputs(pb, pman), max_colors)
    assert_equal(praw, jraw, "raw colors")
    spilled = int(((praw < 0) & pman.valid).sum())
    if max_colors == 4:
        assert spilled > 0
    else:
        assert spilled == 0


@pytest.mark.parametrize("max_colors", [24, 4])
def test_fresh_coloring_matches_xla_loop(scene, max_colors):
    """The whole fresh coloring (rounds, spill, height relabel) against the
    reference's XLA loop."""
    pcfg, jcfg, jb, pb, jman, pman = scene
    jc = jsolver.color_manifolds(jman, jb, jcfg.replace(max_colors=max_colors))
    pc = psolver.color_manifolds(pman, pb, pcfg.replace(max_colors=max_colors))
    for k, name in enumerate(("color", "n_colors", "relax", "spill")):
        assert_equal(pc[k], jc[k], name)


@pytest.mark.parametrize("max_colors", [24, 4])
def test_color_rounds_are_conflict_free(scene, max_colors):
    """Within a round's color no dynamic body appears twice, every valid
    manifold is colored unless the rounds ran out, and on CPU tensors the
    wrapper runs the twin and launches nothing."""
    _, _, _, pb, _, pman = scene
    n0 = pck.color_rounds.launches
    raw = np_(pck.color_rounds(*_inputs(pb, pman), max_colors))
    assert pck.color_rounds.launches == n0
    valid = np_(pman.valid)
    dyn = np_(pb.inv_mass > 0.0)
    ba, bb = np_(pman.body_a), np_(pman.body_b)
    assert (raw[~valid] == -1).all()
    assert raw.max() <= max_colors - 2
    for c in range(raw.max() + 1):
        sel = raw == c
        bodies = np.concatenate([ba[sel][dyn[ba[sel]]], bb[sel][dyn[bb[sel]]]])
        assert len(bodies) == len(np.unique(bodies)), c
    if (raw[valid] < 0).any():
        assert raw.max() == max_colors - 2


def test_round_hashes_table():
    """The i32 table of round constants the CUDA kernel reads."""
    t = pck._round_hashes(24, "cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [psolver.round_hash(c) for c in range(24)]
    assert pck._round_hashes(24, "cpu") is t          # built once


def _cached_manifolds(seed, max_colors, n_bodies=400, m=1500, live=1100):
    """`live` manifolds in front of a dead tail (body 0, not valid) between
    random bodies, a tenth of them static, with the colors a cache would
    give them: a fresh coloring's, two thirds of them kept, the rest -1."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(0, n_bodies, (m,), generator=g)
    b = (a + torch.randint(1, 30, (m,), generator=g)) % n_bodies
    valid = torch.arange(m) < live
    a = torch.where(valid, a, 0).to(torch.int32)
    b = torch.where(valid, b, 0).to(torch.int32)
    dyn = torch.rand(n_bodies, generator=g) > 0.1
    fresh = pck.color_rounds_plain(a, b, valid, dyn, n_bodies, max_colors)
    keep = torch.rand(m, generator=g) < 2 / 3
    return a, b, valid, dyn, torch.where(keep, fresh, -1), n_bodies


def _rounds_read_only(a, b, valid, dyn, color, n_bodies, max_colors):
    """The claim rounds with the forbidden table built once from the cached
    colors and then only read, run while any valid manifold is uncolored.
    Returns (raw colors, rounds run, whether a manifold that some round
    found not free won a later one)."""
    K = max_colors
    dyn_a, dyn_b = dyn[a], dyn[b]
    ia, ib = a.to(torch.int64), b.to(torch.int64)
    forbid = torch.zeros((n_bodies, K), dtype=torch.bool)
    c = torch.clamp(color, 0, K - 1).to(torch.int64)
    for side, d in ((ia, dyn_a), (ib, dyn_b)):
        sel = (color >= 0) & d
        forbid[side[sel], c[sel]] = True
    idx = torch.arange(a.shape[0], dtype=torch.int32)
    blocked = torch.zeros_like(valid)
    rounds = 0
    for r in range(K - 1):
        uncolored = valid & (color < 0)
        if not bool(uncolored.any()):
            break
        rounds += 1
        elig = uncolored & ~forbid[ia, r] & ~forbid[ib, r]
        blocked |= uncolored & ~elig
        token = idx ^ pck.round_hash(r)
        claim = pck.claim_min(n_bodies, a, b,
                              torch.where(elig & dyn_a, token, pck.INF_I32),
                              torch.where(elig & dyn_b, token, pck.INF_I32))
        win = (elig & (~dyn_a | (claim[a] == token))
               & (~dyn_b | (claim[b] == token)))
        color = torch.where(win, r, color)
    late = bool((blocked & (color >= 0)).any())
    return color, rounds, late


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_colors", [24, 2])
def test_cached_rounds_need_no_forbid_writes(seed, max_colors):
    """The invariant the cached coloring's kernel rests on: the reference's
    loop, which adds each round's winners to its forbidden-color table,
    gives the same colors as the table built once from the cached colors
    and only read (round c reads column c before it writes it; later rounds
    read higher columns). On CPU tensors the wrapper is that loop and
    launches nothing."""
    a, b, valid, dyn, color, n_bodies = _cached_manifolds(seed, max_colors)
    n0 = pck.color_rounds_cached.launches
    twin = pck.color_rounds_cached(a, b, valid, dyn, color.clone(), n_bodies,
                                   max_colors)
    assert pck.color_rounds_cached.launches == n0
    once, rounds, late = _rounds_read_only(a, b, valid, dyn, color, n_bodies,
                                           max_colors)
    assert torch.equal(twin, once)
    assert torch.equal(twin[color >= 0], color[color >= 0])
    assert bool((twin[~valid] == -1).all())
    new = valid & (color < 0)
    assert int(new.sum()) > 100
    if max_colors == 24:
        # every new manifold colored, and the stop rule was needed: one
        # that a round found not free won a later round
        assert bool((twin[new] >= 0).all()) and late and rounds >= 3
    else:
        assert rounds == 1 and bool((twin[new] < 0).any())
