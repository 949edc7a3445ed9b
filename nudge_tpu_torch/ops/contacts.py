"""Contact generation: broadphase -> narrowphase -> manifold compaction
(PyTorch port of `nudge_tpu.ops.contacts`).

Contacts are grouped by collider pair into manifolds of up to 4 points
sharing (body_a, body_b, normal, friction); the solver works per manifold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import trace
from ..config import SimConfig
from ..state import SimState, flatten
from . import narrowphase as nps
from .broadphase import (
    allpairs_broadphase, compact_mask, dead_mask, world_colliders,
)
from .narrowphase_1pt import (
    pairs_1pt_adjoint_cuda, pairs_1pt_slots_cuda, pairs_1pt_slots_plain,
)
from .narrowphase_kernel import (
    POSE_INPUTS, SHAPE_COLUMNS, SHAPE_INPUTS, SLOTS, box_box_adjoint_cuda,
    box_box_slots, box_box_slots_cuda, box_box_slots_plain, empty_slots,
)
from .segment import entries, segment_sum

POINTS = nps.BOX_BOX_POINTS
_I32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class Manifolds:
    """Fixed-capacity SoA contact manifolds."""

    body_a: torch.Tensor       # i32[M]
    body_b: torch.Tensor       # i32[M]
    ga: torch.Tensor           # i32[M] first collider gid (pair identity)
    gb: torch.Tensor           # i32[M]
    normal: torch.Tensor       # f32[M,3] world, from body_a to body_b
    friction: torch.Tensor     # f32[M]
    pos: torch.Tensor          # f32[M,P,3] world contact points
    depth: torch.Tensor        # f32[M,P]
    feat: torch.Tensor         # i32[M,P]
    point_valid: torch.Tensor  # bool[M,P]
    valid: torch.Tensor        # bool[M]
    count: torch.Tensor        # i32 true manifold count (may exceed M)
    overflow: torch.Tensor     # bool
    # bit0 box-box pairs | bit1 box-sphere pairs | bit2 sphere-sphere pairs
    # | bit3 manifold compaction | bit4 persistent-broadphase rebuild
    # | bit5 grid cell density | bit6 grid expand capacity
    overflow_bits: Optional[torch.Tensor] = None
    pair_demand: Optional[torch.Tensor] = None

    @property
    def contact_count(self) -> torch.Tensor:
        return torch.sum(self.point_valid.to(torch.int32))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def narrowphase_all(state: SimState, wc, bb, bs, ss, cfg: SimConfig):
    """Per-pair manifold slot arrays over all candidates, in the order
    box-box, box-sphere, sphere-sphere. This is the one place that knows
    that layout: each narrowphase writes its own rows from row 0.

    On the card the kernels run inside `NarrowphaseFn` (`narrowphase_cuda`),
    whose backward is the kernels' backward; when no collider input carries
    a gradient it builds no graph."""
    if state.boxes.half.device.type == "cuda":
        return narrowphase_cuda(state, wc, bb, bs, ss)
    if bs.a.shape[0] + ss.a.shape[0] == 0:
        return box_box_slots(state.boxes, wc, bb)
    return narrowphase_joined_plain(state, wc, bb, bs, ss)


def narrowphase_cuda(state: SimState, wc, bb, bs, ss):
    """The kernels' slots, as one `NarrowphaseFn` node: differentiable in
    the colliders' world poses (`wc`'s box_pos, box_quat, sph_pos) and in
    their shapes and frictions (`SHAPE_LEAVES`)."""
    outs = NarrowphaseFn.apply(wc.box_pos, wc.box_quat, wc.sph_pos,
                               *shape_leaves(state), state, wc, bb, bs, ss)
    return dict(zip(SLOTS, outs))


# the colliders' shape and friction inputs of the narrowphase, in
# NarrowphaseFn's order after the poses
SHAPE_LEAVES = ("box_half", "box_friction", "sphere_radius",
                "sphere_friction")


def shape_leaves(state: SimState):
    return (state.boxes.half, state.boxes.friction, state.spheres.radius,
            state.spheres.friction)


def narrowphase_joined_plain(state: SimState, wc, bb, bs, ss):
    """The three pair classes' slots from the twins, joined."""
    slots = box_box_slots_plain(state.boxes, wc, bb)
    one = pairs_1pt_slots_plain(state.boxes, state.spheres, wc, bs, ss)
    return {k: torch.cat([slots[k], one[k]]) for k in slots}


def narrowphase_joined_cuda(state: SimState, wc, bb, bs, ss):
    """The three pair classes' slots written by the two kernels into one
    set of buffers: box-box rows [0, P_bb), the one-point kernel's after
    them. Two kernels and nothing else."""
    n_bb = bb.a.shape[0]
    out = empty_slots(n_bb + bs.a.shape[0] + ss.a.shape[0],
                      state.boxes.half.device)
    box_box_slots_cuda(state.boxes, wc, bb,
                       out={k: v[:n_bb] for k, v in out.items()})
    pairs_1pt_slots_cuda(state.boxes, state.spheres, wc, bs, ss,
                         out={k: v[n_bb:] for k, v in out.items()})
    return out


def _slot_grads(grads: dict, p: int, device):
    """The adjoints of the slots' pos, depth, normal and friction (zeros
    for an output autograd passed none)."""
    out = []
    for key in ("pos", "depth", "normal", "friction"):
        g = grads.get(key)
        row, _ = SLOTS[key]
        out.append(torch.zeros((p,) + row, dtype=torch.float32, device=device)
                   if g is None else g.contiguous())
    return out


def collider_entries(bb, bs, ss, nb: int):
    """The segment-sum entries of the narrowphase's pose adjoint rows: row
    2r + side of pair row r (box-box, box-sphere, sphere-sphere rows in
    narrowphase_all's order) adds into collider `side ? gb : ga` (global
    ids: a box keeps its index, sphere i is nb + i), for live pairs. A dead
    pair's rows get INT32_MAX, which the sum skips: the backward kernels
    leave them unwritten."""
    if bs.a.shape[0] + ss.a.shape[0] == 0:
        ga, gb, live = bb.a, bb.b, bb.valid
    else:
        ga = torch.cat([bb.a, bs.a, nb + ss.a])
        gb = torch.cat([bb.b, nb + bs.b, nb + ss.b])
        live = torch.cat([bb.valid, bs.valid, ss.valid])
    return entries(torch.stack([ga, gb], 1), live[:, None].expand(-1, 2))


def narrowphase_backward_cuda(state: SimState, wc, bb, bs, ss, grads: dict,
                              shapes: bool = False):
    """d loss / d (box_pos, box_quat, sph_pos) of the world colliders from
    the adjoints of narrowphase_all's slots (`grads`: pos, depth, normal,
    friction): the box-box and the one-point backward kernels write each
    pair row's pose adjoints, and one segment sum adds them per collider in
    a fixed order. With `shapes`, then also d loss / d SHAPE_LEAVES, from
    the kernels' shape instances and a second segment sum."""
    return _backward_kernels(state.boxes, state.spheres, wc, bb, bs, ss,
                             grads, shapes)


def _backward_kernels(boxes, spheres, wc, bb, bs, ss, grads: dict,
                      shapes: bool = False):
    """The two backward kernels write the live pair rows of one adjoint
    buffer (box-box rows, then the one-point rows; an output adjoint that
    autograd passed as None goes in as a null pointer, a zero), and one
    segment sum adds them per collider. With `shapes` the kernels' shape
    instances also write the rows of a [P, SHAPE_INPUTS] buffer, which a
    second segment sum over the same entries adds per collider into the
    columns half (3), friction, radius."""
    nb = boxes.half.shape[0]
    ns = spheres.radius.shape[0]
    n_bb, n_1pt = bb.a.shape[0], bs.a.shape[0] + ss.a.shape[0]
    g = [None if grads.get(k) is None else grads[k].contiguous()
         for k in ("pos", "depth", "normal", "friction")]
    dev = boxes.half.device
    adj = torch.empty((n_bb + n_1pt, POSE_INPUTS), dtype=torch.float32,
                      device=dev)
    shp = (torch.empty((n_bb + n_1pt, SHAPE_INPUTS), dtype=torch.float32,
                       device=dev) if shapes else None)

    def rows(x, sl):
        return None if x is None else x[sl]

    head, tail = slice(0, n_bb), slice(n_bb, None)
    box_box_adjoint_cuda(boxes, wc, bb, *[rows(x, head) for x in g[:3]],
                         out=adj[head], g_friction=rows(g[3], head),
                         out_shape=rows(shp, head))
    if n_1pt:
        pairs_1pt_adjoint_cuda(boxes, spheres, wc, bs, ss,
                               *[rows(x, tail) for x in g[:3]],
                               out=adj[tail], g_friction=rows(g[3], tail),
                               out_shape=rows(shp, tail))
    keys, perm = collider_entries(bb, bs, ss, nb)
    pose = segment_sum(keys, perm, adj.reshape(-1, 7), nb + ns)
    out = (pose[:nb, 0:3].contiguous(), pose[:nb, 3:7].contiguous(),
           pose[nb:, 0:3].contiguous())
    if not shapes:
        return out
    per = segment_sum(keys, perm, shp.reshape(-1, SHAPE_COLUMNS), nb + ns)
    return out + (per[:nb, 0:3].contiguous(), per[:nb, 3].contiguous(),
                  per[nb:, 4].contiguous(), per[nb:, 3].contiguous())


def narrowphase_backward_plain(state: SimState, wc, bb, bs, ss, grads: dict,
                               shapes: bool = False):
    """The plain version of `narrowphase_backward_cuda`: autograd through
    the twins (`narrowphase_joined_plain`) on the same inputs."""
    leaves = [t.detach().requires_grad_() for t in
              (wc.box_pos, wc.box_quat, wc.sph_pos)]
    wcg = wc._replace(box_pos=leaves[0], box_quat=leaves[1],
                      sph_pos=leaves[2])
    stg = state
    if shapes:
        shp = [t.detach().requires_grad_() for t in shape_leaves(state)]
        leaves += shp
        stg = state.replace(
            boxes=state.boxes.replace(half=shp[0], friction=shp[1]),
            spheres=state.spheres.replace(radius=shp[2], friction=shp[3]))
    with torch.enable_grad():
        slots = narrowphase_joined_plain(stg, wcg, bb, bs, ss)
        n = slots["pos"].shape[0]
        keys = ("pos", "depth", "normal", "friction")
        outs = [slots[k] for k in keys]
        gs = _slot_grads(grads, n, slots["pos"].device)
        pairs = [(y, g) for y, g in zip(outs, gs) if y.requires_grad]
        got = torch.autograd.grad([y for y, _ in pairs], leaves,
                                  [g for _, g in pairs], allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(got, leaves))


class NarrowphaseFn(torch.autograd.Function):
    """narrowphase_all on the card as one autograd node: the forward runs
    the box-box and one-point kernels into fresh slot buffers and saves the
    tensors its backward reads (an in-place write to one before the
    backward raises); the backward runs their backward kernels, the shape
    instances only when a shape or friction input needs a gradient. Inputs
    with a gradient: the colliders' world positions and quaternions (`wc`'s
    box_pos, box_quat, sph_pos), then SHAPE_LEAVES; outputs with one: pos,
    depth, normal, and friction when a friction input needs one."""

    @staticmethod
    def forward(ctx, box_pos, box_quat, sph_pos, box_half, box_friction,
                sphere_radius, sphere_friction, state, wc, bb, bs, ss):
        if bs.a.shape[0] + ss.a.shape[0] == 0:
            slots = box_box_slots(state.boxes, wc, bb)
        else:
            slots = narrowphase_joined_cuda(state, wc, bb, bs, ss)
        saved, ctx.rebuild = flatten((state.boxes, state.spheres, wc, bb, bs,
                                      ss))
        ctx.save_for_backward(*saved)
        # the outputs without a gradient reach the backward as None, not as
        # zero tensors autograd would fill
        ctx.set_materialize_grads(False)
        smooth = ["pos", "depth", "normal"]
        if ctx.needs_input_grad[4] or ctx.needs_input_grad[6]:
            smooth.append("friction")
        ctx.mark_non_differentiable(*[slots[k] for k in SLOTS
                                      if k not in smooth])
        return tuple(slots[k] for k in SLOTS)

    @staticmethod
    def backward(ctx, *grads):
        g = dict(zip(SLOTS, grads))
        shapes = any(ctx.needs_input_grad[3:7])
        got = _backward_kernels(*ctx.rebuild(ctx.saved_tensors), g, shapes)
        if not shapes:
            got = got + (None,) * 4
        return (*got, None, None, None, None, None)


def compact_manifolds(slots: dict, cfg: SimConfig, pair_overflow,
                      pair_bits=None) -> Manifolds:
    """Pack pairs with any contact to the front of a cfg.max_manifolds
    array. Past capacity the shallowest manifolds are dropped (depth
    priority), and the kept ones stay in pair order."""
    cap = cfg.max_manifolds
    if pair_bits is None:
        pair_bits = pair_overflow.to(torch.int32)
    has_contact = torch.any(slots["point_valid"], dim=-1)
    n = has_contact.shape[0]
    dev = has_contact.device
    if n <= cap:
        idx, valid, count = compact_mask(has_contact, cap)
    else:
        neg_inf = torch.full((), -float("inf"), dtype=torch.float32,
                             device=dev)
        depth = torch.amax(
            torch.where(slots["point_valid"], slots["depth"], neg_inf), -1)
        key = torch.where(has_contact, -depth, -neg_inf)   # deepest first
        order = torch.sort(key, stable=True).indices
        count = torch.sum(has_contact.to(torch.int32))
        kept = torch.arange(cap, device=dev) < torch.clamp_max(count, cap)
        # dropped slots to the back, index order restored in front
        sel = torch.where(kept, order[:cap], 2 ** 30)
        idx = torch.sort(sel).values
        valid = kept
        idx = torch.where(valid, idx, 0)

    def take(x, fill=0):
        # index_select, not x[idx]: every dropped slot reads row 0, and the
        # backward of x[idx] (index_put_ with accumulate, sorted) adds those
        # rows' zeros to row 0 one after another (~5 ms a field at 61,440
        # manifold slots); index_select's (index_add_) adds them at once.
        # The sums are the same: one live term a row and exact zeros.
        out = torch.index_select(x, 0, idx)
        mask = valid.reshape(valid.shape + (1,) * (out.ndim - 1))
        return torch.where(mask, out, torch.full((), fill, dtype=out.dtype,
                                                 device=dev))

    over = count > cap
    return Manifolds(
        body_a=take(slots["body_a"]),
        body_b=take(slots["body_b"]),
        ga=take(slots["ga"], fill=_I32_MAX),
        gb=take(slots["gb"], fill=_I32_MAX),
        normal=take(slots["normal"]),
        friction=take(slots["friction"]),
        pos=take(slots["pos"]),
        depth=take(slots["depth"]),
        feat=take(slots["feat"]),
        point_valid=take(slots["point_valid"], fill=False),
        valid=valid,
        count=count.to(torch.int32),
        overflow=over | pair_overflow,
        overflow_bits=torch.where(over, 8, 0).to(torch.int32) | pair_bits,
    )


def _base_broadphase(cfg: SimConfig):
    mode = cfg.broadphase
    if mode == "auto":
        mode = "grid" if cfg.num_colliders > 1024 else "allpairs"
    if mode == "grid":
        from .grid import grid_broadphase

        return grid_broadphase
    return allpairs_broadphase


def collide(state: SimState, cfg: SimConfig, rebuild=None):
    """Broadphase + narrowphase + compaction for one step. Returns
    (Manifolds, BPCache): the cache threads the persistent broadphase
    between steps (ops/persistent_bp; `rebuild` forces its rebuild
    decision, which is otherwise its device flag)."""
    wc = world_colliders(state)
    base = _base_broadphase(cfg)
    if cfg.persistent_broadphase:
        from .persistent_bp import persistent_broadphase

        # the rebuild caches pairs as if every body were awake, so waking
        # islands reconnect at once; dead bodies (below the kill plane)
        # never wake and stay out of the rebuild
        dead = dead_mask(state.bodies, state.sleep, cfg)
        rb_awake = torch.ones_like(state.sleep.awake)
        if dead is not None:
            rb_awake = rb_awake & ~dead
        awake_state = state.replace(sleep=state.sleep.replace(awake=rb_awake))

        def base_awake(_, wcx, cfgx):
            return base(awake_state, wcx, cfgx)

        (bb, bs, ss), bp = persistent_broadphase(state, wc, cfg, base_awake,
                                                 rebuild)
    else:
        bb, bs, ss = base(state, wc, cfg)
        bp = state.bp
    slots = narrowphase_all(state, wc, bb, bs, ss, cfg)
    if trace.enabled():     # the candidate pairs the narrowphases ran on
        trace.count(pairs=sum((c.valid.sum() for c in (bs, ss)
                               if c.a.shape[0] > 0), bb.valid.sum()))
    pair_overflow = bb.overflow
    bits = bb.overflow.to(torch.int32)
    pair_demand = bb.count
    for cls, bit in ((bs, 2), (ss, 4)):
        if cls.a.shape[0] > 0:
            pair_overflow = pair_overflow | cls.overflow
            bits = bits | torch.where(cls.overflow, bit, 0).to(torch.int32)
            pair_demand = pair_demand + cls.count
    if bb.flags is not None:        # grid pair/density/expand -> bits 0/5/6
        pair_overflow = pair_overflow | (bb.flags != 0)
        bits = bits | (bb.flags & 1)
        bits = bits | (((bb.flags >> 1) & 3) << 5)
    if cfg.persistent_broadphase:
        # rebuild-time drops poison every reuse step until the next rebuild
        pair_overflow = pair_overflow | bp.overflow
        bits = bits | torch.where(bp.overflow, 16, 0).to(torch.int32)
        bits = bits | torch.where(bp.overflow, ((bp.flags >> 1) & 3) << 5, 0)
    man = compact_manifolds(slots, cfg, pair_overflow, pair_bits=bits)
    return man.replace(pair_demand=pair_demand), bp
