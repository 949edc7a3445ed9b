"""The port's debug and checkpoint utilities against the JAX package's:
`coloring_conflicts` and `finite_state` give the same answers, a
checkpoint the JAX package saved restores into the port, and the port's
own save -> restore is bitwise."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import engine as jengine
from nudge_tpu import scenes as jscenes
from nudge_tpu.utils import checkpoint as jckpt
from nudge_tpu.utils import debug as jdebug
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.utils import checkpoint as pckpt
from nudge_tpu_torch.utils import debug as pdebug

from _torch_bridge import (
    assert_equal, jax_cfg, pressed_mixed_pile, to_port_state,
)

torch.set_num_threads(2)

GROUPS = ("bodies", "boxes", "spheres", "cache", "sleep", "bp", "colors")


def _assert_states_equal(a, b):
    for g in GROUPS:
        for f in dataclasses.fields(getattr(a, g)):
            x, y = getattr(getattr(a, g), f.name), getattr(getattr(b, g), f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), f"{g}.{f.name}"
    assert torch.equal(a.connections, b.connections)
    assert torch.equal(a.step_count, b.step_count)


@functools.lru_cache(maxsize=None)
def _reference_mode(n=24, steps=3):
    """(port cfg, JAX cfg, JAX state after `steps` reference-mode steps),
    built once per module."""
    pb = pscenes.scene_pile(n, seed=2)
    pcfg = pb.auto_config(sleeping=True, persistent_broadphase=True)
    jcfg = jax_cfg(pcfg)
    jst, _ = jengine.simulate(jscenes.scene_pile(n, seed=2).finalize(jcfg),
                              jcfg, steps)
    return pcfg, jcfg, jst


@pytest.mark.parametrize("colors", ["solver", "random"])
def test_coloring_conflicts_matches_reference(colors):
    """On a pressed pile's manifolds: the solver's own coloring (no
    conflict) and random colors from a few (many conflicts)."""
    from nudge_tpu.ops import contacts as jcontacts
    from nudge_tpu.ops import solver as jsolver

    _, jcfg, jst, _ = pressed_mixed_pile(48)
    man, _ = jax.jit(lambda s: jcontacts.collide(s, jcfg))(jst)
    if colors == "solver":
        color = jax.jit(lambda m, b: jsolver.color_manifolds(m, b, jcfg))(
            man, jst.bodies)[0]
    else:
        rng = np.random.default_rng(0)
        color = jnp.asarray(rng.integers(0, 3, man.valid.shape[0]), jnp.int32)
    jcon = types.SimpleNamespace(color=color, body_a=man.body_a,
                                 body_b=man.body_b, valid=man.valid)
    pcon = types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                    for k, v in vars(jcon).items()})
    pst = to_port_state(jst)
    want = int(jdebug.coloring_conflicts(jcon, jst.bodies))
    assert int(pdebug.coloring_conflicts(pcon, pst.bodies)) == want
    assert int(man.valid.sum()) > 30
    assert (want == 0) == (colors == "solver")


def test_finite_state_matches_reference():
    _, _, jst = _reference_mode()
    pst = to_port_state(jst)
    assert pdebug.finite_state(pst) and jdebug.finite_state(jst)
    vel = pst.bodies.vel.clone()
    vel[3, 1] = float("nan")
    bad = pst.replace(bodies=pst.bodies.replace(vel=vel))
    jbad = jst.replace(bodies=jst.bodies.replace(
        vel=jst.bodies.vel.at[3, 1].set(jnp.nan)))
    assert not pdebug.finite_state(bad) and not jdebug.finite_state(jbad)


def test_jax_checkpoint_restores_into_port(tmp_path):
    """A reference checkpoint (its tight-list memo fields included) loads
    into the port; every field the port models comes back exactly, and the
    port steps on from it like from the state carried across."""
    pcfg, jcfg, jst = _reference_mode()
    path = tmp_path / "ref.npz"
    jckpt.save(str(path), jst)
    assert "bp/tight_bb_a" in np.load(path).files
    like = pscenes.scene_pile(24, seed=2).finalize(pcfg, device="cpu")
    restored = pckpt.restore(str(path), like)
    _assert_states_equal(restored, to_port_state(jst))
    a, _ = pengine.step(restored, pcfg)
    b, _ = pengine.step(to_port_state(jst), pcfg)
    _assert_states_equal(a, b)


def test_port_checkpoint_roundtrip_is_bitwise(tmp_path):
    pcfg, _, jst = _reference_mode()
    st, _ = pengine.simulate(to_port_state(jst), pcfg, 2)
    path = tmp_path / "sub" / "port.npz"
    pckpt.save(str(path), st)
    like = pscenes.scene_pile(24, seed=2).finalize(pcfg, device="cpu")
    restored = pckpt.restore(str(path)[:-4], like)    # suffix optional
    _assert_states_equal(restored, st)
    a, ma = pengine.simulate(restored, pcfg, 2)
    b, mb = pengine.simulate(st, pcfg, 2)
    _assert_states_equal(a, b)
    assert torch.equal(ma.kinetic_energy, mb.kinetic_energy)


def test_restore_missing_field(tmp_path):
    pcfg, _, jst = _reference_mode()
    st = to_port_state(jst)
    path = tmp_path / "port.npz"
    pckpt.save(str(path), st)
    data = dict(np.load(path))
    del data["bp/anchor_pos"]
    np.savez(path, **data)
    like = pscenes.scene_pile(24, seed=2).finalize(pcfg, device="cpu")
    with pytest.raises(KeyError):
        pckpt.restore(str(path), like)
    loose = pckpt.restore(str(path), like, strict=False)
    assert torch.equal(loose.bp.anchor_pos, like.bp.anchor_pos)
    assert_equal(loose.bodies.pos, np.asarray(jst.bodies.pos), "pos")
