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
