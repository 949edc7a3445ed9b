"""What the narrowphase kernels' live-pairs-only design rests on, on the
CPU.

The box-box kernel (csrc/narrowphase.cu) and the one-point kernel
(csrc/narrowphase_1pt.cu) write only `point_valid` for a dead pair slot;
the other fields, the collider ids too, stay as `torch.empty` made them,
so:
  - `contacts.compact_manifolds` must read nothing of a slot without a
    valid point but `point_valid`, in both of its branches, and give what
    the JAX package's compaction gives on the clean slots;
  - the broadphases hand the narrowphase their live pairs as a prefix with
    (0, 0) in the dead slots (the coloring kernel walks only that prefix of
    the manifolds that the compaction packs);
and the plain model of the kernel's reduction order must pick the twin's
first maximum (torch.argmax) wherever the values are ordered.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu_torch.ops import broadphase as pbp
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.ops import grid as pgrid
from nudge_tpu_torch.ops import narrowphase_kernel as npk
from nudge_tpu_torch.ops import persistent_bp as ppbp

from _torch_bridge import assert_equal, jax_cfg, port_manifolds, pressed_mixed_pile

torch.set_num_threads(2)

def _slots(pcfg, pst):
    wc = pbp.world_colliders(pst)
    bb, bs, ss = pgrid.grid_broadphase(pst, wc, pcfg)
    return pcontacts.narrowphase_all(pst, wc, bb, bs, ss, pcfg)


def _garbage(slots, seed):
    """The slots with every field of a slot without a valid point, except
    point_valid, replaced by NaN or random ints (what the kernel leaves)."""
    rng = np.random.default_rng(seed)
    dead = ~slots["point_valid"].any(1)
    out = dict(slots)
    for k in ("normal", "friction", "pos", "depth"):
        x = slots[k].clone()
        x[dead] = float("nan")
        out[k] = x
    for k in ("feat", "body_a", "body_b", "ga", "gb"):
        x = slots[k].clone()
        x[dead] = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31 - 1, size=tuple(x[dead].shape), dtype=np.int32))
        out[k] = x
    return out


@pytest.mark.parametrize("cap", ["all_slots", "depth_priority", "drops"])
def test_compact_manifolds_reads_only_point_valid_of_dead_slots(cap):
    pcfg, _, _, pst = pressed_mixed_pile(120)
    slots = _slots(pcfg, pst)
    n = slots["point_valid"].shape[0]
    live = int(slots["point_valid"].any(1).sum())
    dead = n - live
    assert live > 50 and dead > 50
    m = {"all_slots": n, "depth_priority": (n + live) // 2,
         "drops": live // 2}[cap]
    cfg = pcfg.replace(max_manifolds=m)
    over = torch.tensor(False)
    clean = pcontacts.compact_manifolds(slots, cfg, over)
    dirty = pcontacts.compact_manifolds(_garbage(slots, 7), cfg, over)
    jslots = {k: jnp.asarray(v.numpy()) for k, v in slots.items()}
    ref = port_manifolds(jcontacts.compact_manifolds(
        jslots, jax_cfg(cfg), jnp.asarray(False)))
    for f in dataclasses.fields(pcontacts.Manifolds):
        a = getattr(dirty, f.name)
        if a is None:
            continue
        assert torch.equal(a, getattr(clean, f.name)), f.name
        assert_equal(a, getattr(ref, f.name), f.name)
    assert bool(clean.overflow) == (cap == "drops")
    assert int(clean.valid.sum()) == min(live, m)


def test_one_point_rows_keep_their_ids_and_dead_slots():
    """The joined slots of a mixed pile on the CPU, the one-point rows
    after box-box's: every row's ids by the kernels' rule (box i is i,
    sphere j is nb + j, read from the pair lists; the kernels write them
    on live rows), and the dead one-point slots without a valid point;
    `_garbage` then garbles all a dead slot holds besides, its ids too
    (the test above)."""
    pcfg, _, _, pst = pressed_mixed_pile(120)
    wc = pbp.world_colliders(pst)
    bb, bs, ss = pgrid.grid_broadphase(pst, wc, pcfg)
    slots = pcontacts.narrowphase_all(pst, wc, bb, bs, ss, pcfg)
    nb = pst.boxes.half.shape[0]
    ga = torch.cat([bb.a, bs.a, nb + ss.a])
    gb = torch.cat([bb.b, nb + bs.b, nb + ss.b])
    assert torch.equal(slots["ga"], ga) and torch.equal(slots["gb"], gb)
    live = torch.cat([bs.valid, ss.valid])
    one = slots["point_valid"][bb.a.shape[0]:]
    assert not bool(one[~live].any())
    assert not bool(one[:, 1:].any())
    assert int((~live).sum()) > 50 and bool(one[live, 0].any())


def _assert_prefix(pairs, what):
    v = pairs.valid
    k = int(v.sum())
    assert torch.equal(v, torch.arange(v.shape[0]) < k), what
    assert k == min(int(pairs.count), v.shape[0]), what
    assert not bool(pairs.a[~v].any()) and not bool(pairs.b[~v].any()), what


@pytest.mark.parametrize("broadphase", ["grid", "allpairs"])
def test_live_pairs_form_a_prefix(broadphase):
    pcfg, _, _, pst = pressed_mixed_pile(120)
    fn = {"grid": pgrid.grid_broadphase,
          "allpairs": pbp.allpairs_broadphase}[broadphase]
    for cls, pairs in zip(("bb", "bs", "ss"),
                          fn(pst, pbp.world_colliders(pst), pcfg)):
        assert int(pairs.valid.sum()) > 0, cls
        _assert_prefix(pairs, cls)


def test_persistent_refilter_keeps_the_prefix():
    """The refilter drops pairs in the middle of the fat list (a band of
    sleepers, bodies moved apart); its compaction still leaves a prefix."""
    pcfg, _, _, pst = pressed_mixed_pile(120, sleeping=True,
                                         persistent_broadphase=True)
    base = pcontacts._base_broadphase(pcfg)
    wc = pbp.world_colliders(pst)
    (bb, bs, ss), bp = ppbp.persistent_broadphase(pst, wc, pcfg, base, True)
    n_fat = int(bp.bb_valid.sum())
    dyn = pst.bodies.inv_mass > 0
    asleep = dyn & (torch.arange(dyn.shape[0]) % 3 == 0)
    pos = pst.bodies.pos.clone()
    pos[dyn & (torch.arange(dyn.shape[0]) % 3 == 1), 0] += 0.04
    st = pst.replace(bodies=pst.bodies.replace(pos=pos),
                     sleep=pst.sleep.replace(awake=pst.sleep.awake & ~asleep),
                     bp=bp)
    (bb, bs, ss), _ = ppbp.persistent_broadphase(
        st, pbp.world_colliders(st), pcfg, base, False)
    assert 0 < int(bb.valid.sum()) < n_fat
    for cls, pairs in (("bb", bb), ("bs", bs), ("ss", ss)):
        _assert_prefix(pairs, cls)


def _rows(seed, n=400):
    """Candidate values with many exact ties, invalid candidates (-1e30),
    -inf and +inf, and rows where every candidate is invalid."""
    rng = np.random.default_rng(seed)
    k = npk.CANDIDATES
    x = rng.integers(0, 4, size=(n, k)).astype(np.float32)
    x[rng.random((n, k)) < 0.3] = -1e30
    x[rng.random((n, k)) < 0.05] = -np.inf
    x[rng.random((n, k)) < 0.02] = np.inf
    x[: n // 10] = -1e30
    x[n // 10: n // 5] = -np.inf
    x[n // 5: n // 4] = rng.choice([-1e30, -np.inf], size=(n // 4 - n // 5, k))
    return torch.from_numpy(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_reduction_model_is_first_max(seed):
    x = _rows(seed)
    assert torch.equal(npk.first_max_model(x), torch.argmax(x, dim=-1))


def test_kernel_reduction_model_with_nan():
    """A NaN never wins the kernel's scan after candidate 0, and a NaN at
    candidate 0 is kept: where the twin (torch.argmax, NaN as the maximum)
    and the kernel may part."""
    x = _rows(3)
    rng = np.random.default_rng(3)
    x[torch.from_numpy(rng.random(tuple(x.shape)) < 0.1)] = float("nan")
    first_nan = torch.isnan(x[:, 0])
    assert 0 < int(first_nan.sum()) < x.shape[0]
    got = npk.first_max_model(x)
    assert not bool(got[first_nan].any())
    later_as_neg_inf = torch.where(torch.isnan(x), -torch.inf, x)
    assert torch.equal(got[~first_nan],
                       torch.argmax(later_as_neg_inf, dim=-1)[~first_nan])
    assert not torch.equal(got, torch.argmax(x, dim=-1))
