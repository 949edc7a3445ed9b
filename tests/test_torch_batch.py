"""BASELINE config 5's batching in the port: the batch constructors
(`scenes.scene_pile_batch`, `scene_pile_megachunks`, `scene_pile_stacked`
and the on-device jitter) and `parallel.mesh`, held against the JAX
package's on the XLA path, and the cases of tests/test_parallel.py that
need no device mesh (those that do: tests/test_torch_parallel.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nudge_tpu import scenes as jscenes
from nudge_tpu.parallel import mesh as jmesh
from nudge_tpu_torch import config as pconfig
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.parallel import mesh as pmesh
from nudge_tpu_torch.state import tree_map

from _torch_bridge import (
    assert_equal, assert_same_trajectory, jax_cfg, metrics_np, np_, tree,
    to_port_state,
)


# The renormalised quaternions: the reference's norm is an XLA reduction
# that contracts the squares' sum into FMAs, and it lands one float32 step
# from the port's on ~9% of the bodies (43 of 528 in the two cases below).
# Where such a norm sits at or above 1.0 (21 of the 43), one step is 2^-23,
# and dividing w ~ 0.998 by norms 2^-23 apart moves it by ~2^-23: two of
# its own steps (2^-24 below 1.0). Measured on both cases: at most 2 steps,
# max abs 2^-23 (1.19e-7), so 1e-7 cannot hold; the tolerance is that one
# norm step.
QUAT_ATOL = 2.0 ** -23


def _leaves(st):
    flat = []
    tree_map(lambda x: flat.append(x), st)
    return flat


def assert_states_equal(a, b, where=""):
    """Every leaf of two port states bitwise equal."""
    for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b))):
        assert torch.equal(x, y), f"{where}: leaf {i} differs"


def _flat_dict(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat_dict(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# --- the batch constructors -------------------------------------------------

@pytest.mark.parametrize("n_scenes,k,sphere_frac", [(4, 8, 0.0), (3, 20, 0.3)])
def test_scene_pile_batch_finalizes_like_reference(n_scenes, k, sphere_frac):
    pb = pscenes.scene_pile_batch(n_scenes, k, sphere_frac=sphere_frac, seed=2)
    jb = jscenes.scene_pile_batch(n_scenes, k, sphere_frac=sphere_frac, seed=2)
    pcfg = pb.auto_config()
    assert dataclasses.asdict(pcfg) == {
        f.name: getattr(jb.auto_config(), f.name)
        for f in dataclasses.fields(pconfig.SimConfig)}
    pst = _flat_dict(tree(pb.finalize(pcfg, device="cpu")))
    jst = _flat_dict(tree(jb.finalize(jax_cfg(pcfg))))
    for key, v in pst.items():
        assert_equal(v, jst[key], key)


def _reference_jitter(n, n_dyn, seed):
    """The reference's draw (nudge_tpu/scenes.py `_stack_on_device`)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
    u = jax.random.uniform
    return tuple(torch.from_numpy(np.array(a)) for a in (
        u(k1, (n, n_dyn), minval=-0.05, maxval=0.05),
        u(k2, (n, n_dyn), minval=-0.05, maxval=0.05),
        u(k3, (n, n_dyn, 3), minval=-0.02, maxval=0.02)))


@pytest.mark.parametrize("n,spc,k,seed", [(3, 2, 8, 2), (5, 4, 24, 7)])
def test_jitter_apply_matches_reference(n, spc, k, seed):
    """Given the reference's dx, dz, dq, the port's apply gives the
    reference's stack: positions bitwise, quaternions within QUAT_ATOL,
    every other leaf bitwise."""
    pb = pscenes.scene_pile_batch(spc, k, seed=seed)
    pcfg = pb.auto_config()
    jb = jscenes.scene_pile_batch(spc, k, seed=seed)
    n_dyn = jb.num_bodies - 1
    ref = jscenes._stack_on_device(jb.finalize(jax_cfg(pcfg)), n, n_dyn, seed)
    out = pscenes.apply_stack_jitter(pb.finalize(pcfg, device="cpu"),
                                     *_reference_jitter(n, n_dyn, seed))
    assert_equal(out.bodies.pos, ref.bodies.pos, "pos")
    np.testing.assert_allclose(np_(out.bodies.quat), np_(ref.bodies.quat),
                               rtol=0, atol=QUAT_ATOL)
    pst, jst = _flat_dict(tree(out)), _flat_dict(tree(ref))
    for key, v in pst.items():
        if key not in ("bodies.pos", "bodies.quat"):
            assert_equal(v, jst[key], key)
    assert out.step_count.shape == (n,)


def test_port_jitter_draw():
    """The port's own draw: shapes and ranges, the ground untouched, every
    copy moved, a fixed seed gives a fixed stack, another seed another."""
    n, spc, k = 4, 2, 8
    st, cfg = pscenes.scene_pile_megachunks(n, spc, k, seed=3, device="cpu")
    again, _ = pscenes.scene_pile_megachunks(n, spc, k, seed=3, device="cpu")
    other, _ = pscenes.scene_pile_megachunks(n, spc, k, seed=4, device="cpu")
    n_dyn = spc * k
    dx, dz, dq = pscenes.stack_jitter(n, n_dyn, 3, "cpu")
    assert dx.shape == dz.shape == (n, n_dyn) and dq.shape == (n, n_dyn, 3)
    assert float(dx.abs().max()) <= 0.05 and float(dz.abs().max()) <= 0.05
    assert float(dq.abs().max()) <= 0.02
    assert_states_equal(st, again, "same seed")
    assert not torch.equal(st.bodies.pos, other.bodies.pos)
    b = pscenes.scene_pile_batch(spc, k, seed=3)
    st0 = b.finalize(cfg, device="cpu")
    for c in range(n):
        assert torch.equal(st.bodies.pos[c, 0], st0.bodies.pos[0])
        assert torch.equal(st.bodies.quat[c, 0], st0.bodies.quat[0])
        assert torch.equal(st.bodies.pos[c, :, 1], st0.bodies.pos[:, 1])
        moved = st.bodies.pos[c, 1:1 + n_dyn] - st0.bodies.pos[1:1 + n_dyn]
        assert bool((moved[:, [0, 2]] != 0).any(-1).all())
        norm = torch.linalg.vector_norm(st.bodies.quat[c], dim=-1)
        assert float((norm - 1).abs().max()) < 1e-6
    assert not torch.equal(st.bodies.pos[0], st.bodies.pos[1])


def test_megachunk_grid_table_covers_footprint():
    """Without a cfg, scene_pile_megachunks grows auto_config's grid table
    to the chunk's footprint at the smallest cell the grid can take (an
    upright box's AABB); at a few scenes a chunk it is auto_config's own,
    as in the reference."""
    b = pscenes.scene_pile_batch(64, 8)
    _, cfg = pscenes.scene_pile_megachunks(1, 64, 8, device="cpu")
    pos = np.asarray(b.pos)
    span = pos.max(0) - pos.min(0)
    cell = 2 * (0.5 + cfg.aabb_margin)
    assert all(d * cell >= s for d, s in zip(cfg.grid_table_dims, span))
    assert cfg.grid_table_dims[0] > b.auto_config().grid_table_dims[0]
    _, small = pscenes.scene_pile_megachunks(1, 2, 8, device="cpu")
    assert small == pscenes.scene_pile_batch(2, 8).auto_config()


# --- parallel.mesh: the cases of tests/test_parallel.py without a mesh -------

def test_chunked_step_matches_unchunked():
    batch, cfg = pscenes.scene_pile_stacked(4, 24, seed=5, device="cpu")
    ref, mref = pmesh.batched_step(cfg, donate=False)(batch)
    out, mout = pmesh.batched_step_chunked(cfg, n_chunks=2,
                                           donate=False)(batch)
    assert_states_equal(ref, out, "chunked")
    assert torch.equal(mref.contact_count, mout.contact_count)
    assert mref.contact_count.shape == (4,)
    with pytest.raises(ValueError):
        pmesh.batched_step_chunked(cfg, n_chunks=3)(batch)


def test_megachunk_rollout_matches_per_chunk():
    batch, cfg = pscenes.scene_pile_megachunks(3, 2, 8, seed=2, device="cpu")
    before = tree_map(torch.clone, batch)
    steps = 10
    rolled, m = pmesh.megabatch_simulate(cfg, steps, donate=False)(batch)
    assert_states_equal(batch, before, "the input batch")
    for c in range(3):
        solo, mref = pengine.simulate(pmesh.take(batch, c), cfg, steps)
        assert_states_equal(pmesh.take(rolled, c), solo, f"chunk {c}")
        assert int(m.contact_count[c]) == int(mref.contact_count[-1])
    # chunks are decorrelated (jitter applied)
    assert not torch.equal(rolled.bodies.pos[0], rolled.bodies.pos[1])


def _small_cfg():
    return pconfig.SimConfig(
        max_bodies=16, max_boxes=16, max_spheres=8,
        max_box_box_pairs=64, max_box_sphere_pairs=32,
        max_sphere_sphere_pairs=16, max_manifolds=112)


def test_scene_independence():
    """A scene's rollout inside a batch equals its rollout alone, bit for
    bit (the reference's test_scene_independence_under_sharding, without
    the mesh)."""
    cfg = _small_cfg()
    n_scenes, steps, probe = 6, 5, 3
    states = [pscenes.scene_pile(8, sphere_frac=0.25, seed=i).finalize(
        cfg, device="cpu") for i in range(n_scenes)]
    rolled, m = pmesh.batched_simulate(cfg, steps)(
        pmesh.make_scene_batch(states))
    assert m.contact_count.shape == (steps, n_scenes)
    solo, _ = pmesh.batched_simulate(cfg, steps)(
        pmesh.make_scene_batch([states[probe]]))
    assert_states_equal(pmesh.take(rolled, probe), pmesh.take(solo, 0),
                        "scene 3")


# --- across packages ----------------------------------------------------------

def _per_scene(pst, pm, jst, jm, i):
    """Scene i of both packages' batches, metrics with a step axis."""
    def sl(m):
        return {k: v[..., i:i + 1] if v.ndim == 1 else v[:, i] for k, v in
                m.items()}
    jsc = jax.tree.map(lambda x: x[i], jst)
    return pmesh.take(pst, i), sl(pm), jsc, sl(jm)


def test_megabatch_matches_reference():
    """The reference's megachunk stack (its jitter carried across) through
    both packages' megabatch_simulate."""
    pcfg = pscenes.scene_pile_batch(2, 8, seed=2).auto_config()
    jcfg = jax_cfg(pcfg)
    jbatch, _ = jscenes.scene_pile_megachunks(3, 2, 8, cfg=jcfg, seed=2)
    pbatch = to_port_state(jbatch)
    steps = 5
    jst, jm = jmesh.megabatch_simulate(jcfg, steps, donate=False)(jbatch)
    pst, pm = pmesh.megabatch_simulate(pcfg, steps)(pbatch)
    pm, jm = metrics_np(pm), metrics_np(jm)
    for c in range(3):
        assert_same_trajectory(*_per_scene(pst, pm, jst, jm, c))


def test_batched_simulate_matches_reference():
    """The reference's stacked batch (its jitter carried across) through
    both packages' batched_simulate, every step's integer metrics too."""
    pcfg = pscenes.scene_pile(24, seed=5).auto_config()
    jcfg = jax_cfg(pcfg)
    jbatch, _ = jscenes.scene_pile_stacked(4, 24, cfg=jcfg, seed=5)
    pbatch = to_port_state(jbatch)
    steps = 5
    jst, jm = jmesh.batched_simulate(jcfg, steps, donate=False)(jbatch)
    pst, pm = pmesh.batched_simulate(pcfg, steps)(pbatch)
    pm, jm = metrics_np(pm), metrics_np(jm)
    assert pm["contact_count"].shape == (steps, 4)
    for i in range(4):
        assert_same_trajectory(*_per_scene(pst, pm, jst, jm, i))
