"""The solve's color-sorted layout: the order against the JAX package's
color slots, the packed rows' round trip, the per-body sums over the
shared body-sorted entry lists, the row layout and the C entry points
against the CUDA sources, and the entry points' default device."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import integrate as jint
from nudge_tpu.ops import setup_kernel as jsetup_kernel
from nudge_tpu.ops import solver as jsolver
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch import state as pstate
from nudge_tpu_torch.envs import BoxPushEnv
from nudge_tpu_torch.ops import integrate as pint
from nudge_tpu_torch.ops import persistent_bp as ppbp
from nudge_tpu_torch.ops import setup_kernel, solver_kernel
from nudge_tpu_torch.ops import solver as psolver

from _torch_bridge import jax_cfg, port_manifolds, to_port_state

torch.set_num_threads(2)

I32_MAX = 2 ** 31 - 1
HEADER = (Path(__file__).resolve().parents[1] / "nudge_tpu_torch" / "csrc"
          / "common.cuh")


@pytest.fixture(scope="module")
def pile():
    """A pile pressed into resting columns (contacts from step 0): the port
    and JAX bodies after gravity, and both packages' manifolds."""
    n = 150
    pb = pscenes.scene_pile(n, seed=2, walls=True)
    pcfg = pb.auto_config()
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


def _colored(pile, max_colors):
    pcfg, jcfg, jb, pb, jman, pman = pile
    pcfg = pcfg.replace(max_colors=max_colors)
    jcfg = jcfg.replace(max_colors=max_colors)
    pcol = psolver.color_manifolds(pman, pb, pcfg)
    order = solver_kernel.color_order(pman, pb, pcol, pcfg)
    return pcfg, jcfg, pcol, order


@pytest.mark.parametrize("max_colors", [24, 4])
def test_color_order_matches_jax_color_slots(pile, max_colors):
    """The port visits the manifolds in the order of the TPU kernel's
    group-padded slots with the padding removed."""
    _, _, jb, pb, jman, pman = pile
    pcfg, jcfg, pcol, order = _colored(pile, max_colors)
    jcol = jsolver.color_manifolds(jman, jb, jcfg)
    jslot, _ = jsetup_kernel.color_slots(jcol[0], jman, jb, jcfg)
    jorder = np.argsort(np.asarray(jslot), kind="stable")
    np.testing.assert_array_equal(order.order.numpy(), jorder)
    m = jorder.shape[0]
    np.testing.assert_array_equal(order.slot.numpy()[jorder], np.arange(m))
    color = np.minimum(np.asarray(jcol[0]), max_colors)
    counts = np.bincount(color, minlength=max_colors + 1)
    np.testing.assert_array_equal(
        order.offsets.numpy(),
        np.concatenate([[0], np.cumsum(counts)[:max_colors]]))
    assert int(order.offsets[-1]) == int(pman.valid.sum())
    if max_colors == 4:
        assert int(pcol[3]) > 0          # the spill state


def _warm(m, seed=0):
    rng = np.random.default_rng(seed)
    warm = (rng.normal(size=(m, 4, 3)) * 0.2).astype(np.float32)
    warm[..., 1] = np.abs(warm[..., 1]) + 0.05
    pwarm = rng.uniform(0, 0.05, size=(m, 4)).astype(np.float32)
    return torch.from_numpy(warm), torch.from_numpy(pwarm)


def _setup(pile, max_colors):
    pman, pb = pile[5], pile[3]
    pcfg, _, pcol, order = _colored(pile, max_colors)
    warm, pwarm = _warm(pman.valid.shape[0])
    con, velw, acc = setup_kernel.setup_plain(pb, pman, warm, pcfg, pcol,
                                              pwarm)
    return pcfg, order, con, velw, acc


@pytest.mark.parametrize("max_colors", [24, 4])
def test_pack_unpack_round_trip(pile, max_colors):
    """unpack_constraints(pack_constraints(...)) gives back setup_plain's
    ContactConstraints exactly, and unpack_acc its accumulators."""
    _, order, con, _, acc = _setup(pile, max_colors)
    packed, work = setup_kernel.pack_constraints(con, acc, order)
    assert packed.rows.shape == (solver_kernel.ROWS, con.valid.shape[0])
    back = setup_kernel.unpack_constraints(packed)
    for f in con.__dataclass_fields__:
        a, b = getattr(back, f), getattr(con, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for a, b in zip(setup_kernel.unpack_acc(work, order), acc):
        assert torch.equal(a, b)
    # the pseudo accumulators start from the warm pseudo impulses
    pacc = work[12:16, order.slot.long()].T
    assert torch.equal(pacc, torch.where(con.point_valid, con.pwarm, 0.0))


def _segment_sum(state, keys, perm, vals, jacobi, keep=None):
    """The kernels' per-body sum in float32, one body segment at a time:
    state[body] += Σ vals (warm start) or Σ (vals - state[body] before the
    sum) (the spill color's Jacobi update), over the entries of the
    segment in order, skipping manifolds without `keep`."""
    out = state.copy()
    m = keys.shape[0]
    e = 0
    while e < m and keys[e] != I32_MAX:
        body = keys[e]
        base = out[body].copy()
        acc = base.copy()
        while e < m and keys[e] == body:
            i = perm[e]
            if keep is None or keep[i]:
                acc = acc + (vals[i] - base) if jacobi else acc + vals[i]
            e += 1
        out[body] = acc
    return out


def test_shared_keys_sum_like_two_sorts(pile):
    """The solve's spill sums over setup's entry lists (every live dynamic
    entry, other colors skipped) equal, bit for bit, the sums over entry
    lists sorted for the spill color alone."""
    pcfg, order, con, _, _ = _setup(pile, 4)
    dyn_a, dyn_b = con.im_a > 0, con.im_b > 0
    spilled = con.valid & (con.color == con.spill_color)
    assert int(spilled.sum()) > 0
    rng = np.random.default_rng(1)
    m = con.valid.shape[0]
    n = pile[3].pos.shape[0]
    state = rng.normal(size=(n, 12)).astype(np.float32)
    post_a = rng.normal(size=(m, 12)).astype(np.float32)
    post_b = rng.normal(size=(m, 12)).astype(np.float32)
    keep = spilled.numpy()
    old = state
    for body, take, post in ((con.body_a, dyn_a, post_a),
                             (con.body_b, dyn_b, post_b)):
        keys, perm = solver_kernel.body_segments(body, spilled & take)
        old = _segment_sum(old, keys.numpy(), perm.numpy(), post, True)
    new = state
    for keys, perm, post in ((order.keys_a, order.perm_a, post_a),
                             (order.keys_b, order.perm_b, post_b)):
        new = _segment_sum(new, keys.numpy(), perm.numpy(), post, True, keep)
    assert np.array_equal(old, new)
    assert not np.array_equal(old, state)


def test_warm_start_sums_match_twin(pile):
    """Setup's warm start as the kernels do it: per-manifold velocity
    changes in the kernel's operation order, summed per body over the
    shared entry lists (side a, then side b), equal setup_plain's velw bit
    for bit."""
    pcfg, order, con, velw, (an, at1, at2) = _setup(pile, 24)
    pb = pile[3]

    def psum(x):
        return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]

    def ang(j1, j2, j3):
        return psum((j1 * an[..., None] + j2 * at1[..., None])
                    + j3 * at2[..., None])

    pw = torch.where(con.point_valid, con.pwarm, 0.0)
    P = (psum(an)[:, None] * con.n + psum(at1)[:, None] * con.t1) \
        + psum(at2)[:, None] * con.t2
    Pp = psum(pw)[:, None] * con.n
    da = torch.cat([-P * con.im_a[:, None], -ang(con.jna, con.jt1a, con.jt2a),
                    -Pp * con.im_a[:, None], -psum(pw[..., None] * con.jna)],
                   1)
    db = torch.cat([P * con.im_b[:, None], ang(con.jnb, con.jt1b, con.jt2b),
                    Pp * con.im_b[:, None], psum(pw[..., None] * con.jnb)], 1)
    z = torch.zeros_like(pb.vel)
    state = torch.cat([pb.vel, pb.angvel, z, z], 1).numpy()
    for keys, perm, d in ((order.keys_a, order.perm_a, da),
                          (order.keys_b, order.perm_b, db)):
        state = _segment_sum(state, keys.numpy(), perm.numpy(), d.numpy(),
                             False)
    assert torch.equal(torch.from_numpy(state), velw)
    assert not torch.equal(velw[:, 0:6], torch.cat([pb.vel, pb.angvel], 1))


def test_row_layout_matches_cuda_header():
    """solver_kernel.ROW_FIELDS and the work rows are the offsets that
    csrc/common.cuh gives the kernels."""
    consts = dict((k, int(v)) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", HEADER.read_text()))
    off = 0
    for name, width in solver_kernel.ROW_FIELDS:
        key = "kRow" + "".join(p.capitalize() for p in name.split("_"))
        key = {"kRowPointValid": "kRowPv"}.get(key, key)
        assert consts[key] == off, name
        off += width
    assert consts["kRows"] == off == solver_kernel.ROWS
    assert consts["kWorkRows"] == solver_kernel.WORK_ROWS
    assert consts["kWorkScratch"] == 16 and consts["kWorkAccP"] == 12


def test_c_entry_points_match_their_ctypes_signatures():
    """Every `extern "C"` function of csrc/ takes the arguments that
    _build's ctypes signature passes: pointers (and the stream) as void*,
    counts as int, constants as float, in the same order and number. A
    mismatch would only show on the card."""
    import ctypes

    from nudge_tpu_torch import _build

    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    found = {}
    for src in sorted(HEADER.parent.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     text):
            found[name] = "".join(
                "p" if "*" in a else a.split()[-2][0]
                for a in args.split(",") if a.strip())
    assert found == {k: "".join(kinds[t] for t in v)
                     for k, v in _build._SIGNATURES.items()}


def _single_box():
    b = pscenes.scene_single_box()
    return b, b.auto_config()


@pytest.mark.parametrize("make", [
    lambda b, cfg: b.finalize(cfg),
    lambda b, cfg: pstate.empty_state(cfg),
    lambda b, cfg: pstate.empty_cache(cfg),
    lambda b, cfg: pstate.empty_color_cache(cfg),
    lambda b, cfg: ppbp.empty_bp_cache(cfg, cfg.max_bodies),
    lambda b, cfg: pscenes.scene_pile_megachunks(2, 2, 8)[0],
    lambda b, cfg: pscenes.scene_pile_stacked(2, 8)[0],
    lambda b, cfg: BoxPushEnv()._proto,
], ids=["finalize", "empty_state", "empty_cache", "empty_color_cache",
        "empty_bp_cache", "scene_pile_megachunks", "scene_pile_stacked",
        "BoxPushEnv"])
def test_entry_points_default_to_the_card(make):
    """With no device the state is built on the card; where torch has no
    CUDA device that raises instead of falling back to the CPU."""
    b, cfg = _single_box()
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            make(b, cfg)
        return
    out = make(b, cfg)
    first = out.bodies.pos if hasattr(out, "bodies") else out.valid
    assert first.is_cuda
