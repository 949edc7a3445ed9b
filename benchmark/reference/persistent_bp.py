"""The persistent broadphase of the reference step: a fat rebuild cached
in the state, refiltered every step. A frozen copy of the port's plain
code, for box scenes on the grid broadphase.

At rebuild time the candidate pairs are generated with a fat speculative
margin (cfg.rebuild_margin) under fat pair capacities (`fat_cfg`) and
cached with each body's anchor position and orientation. Every step each
body's conservative displacement since its anchor, |x - x0| + 2 r |q - q0|
(r the body's circumradius), is held against rebuild_margin / 2
(`needs_rebuild`): while no body has moved that far, the cache holds
every pair whose AABBs overlap now. Each step then refilters the fat set
against the current AABBs and the live filters (sleep, the kill plane,
connections) and compacts it to the tight capacity, core pairs first
under pressure (`two_tier_compact`).

Translation note against the port: its `control.cond` on `needs_rebuild`
is a Python branch on the predicate read to the host.
"""

from __future__ import annotations

import torch

from .collide import _pair_filter, box_aabbs, compact_mask
from .tree import Rec


def fat_cfg(cfg):
    """The configuration the rebuild runs under: the fat margin and fat
    pair capacities."""
    k = max(cfg.fat_pair_factor, 1)
    fat = cfg.replace(
        aabb_margin=cfg.rebuild_margin,
        max_box_box_pairs=k * cfg.max_box_box_pairs,
        max_box_sphere_pairs=k * cfg.max_box_sphere_pairs,
        max_sphere_sphere_pairs=k * cfg.max_sphere_sphere_pairs)
    fat.total_pairs = (fat.max_box_box_pairs + fat.max_box_sphere_pairs
                       + fat.max_sphere_sphere_pairs)
    return fat


def _norm(x):
    """Euclidean norm over the last axis, summed in index order."""
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return torch.sqrt(s)


def _body_radius(state):
    """Per-body circumradius over its box colliders."""
    n = state.bodies.pos.shape[0]
    bx = state.boxes
    r = torch.zeros((n,), dtype=torch.float32, device=bx.half.device)
    r_box = _norm(bx.half) + _norm(bx.lpos)
    r.scatter_reduce_(0, torch.clamp_min(bx.body, 0).long(),
                      torch.where(bx.body >= 0, r_box, 0.0), "amax")
    return r


def needs_rebuild(state, cfg):
    """bool 0-d tensor: the cache is stale or some body moved past half the
    rebuild margin since its anchor."""
    bp = state.bp
    d = _norm(state.bodies.pos - bp.anchor_pos)
    dq = _norm(state.bodies.quat - bp.anchor_quat)
    disp = d + 2.0 * _body_radius(state) * dq
    return bp.stale | torch.any(disp > 0.5 * cfg.rebuild_margin)


def rebuild(state, wc, cfg, base_broadphase):
    """The fat rebuild: `base_broadphase(state, wc, cfg)` (the box-box
    candidates with their grid flags) under `fat_cfg`, anchored at the
    state's poses."""
    bb = base_broadphase(state, wc, fat_cfg(cfg))
    ovf = (bb.count > bb.a.shape[-1]) | (bb.flags != 0)
    flg = ovf.to(torch.int32) | bb.flags
    return state.bp.replace(
        bb_a=bb.a, bb_b=bb.b, bb_valid=bb.valid, overflow=ovf, flags=flg,
        anchor_pos=state.bodies.pos, anchor_quat=state.bodies.quat,
        stale=torch.zeros((), dtype=torch.bool, device=ovf.device))


def two_tier_compact(keep, core, a, b, live_cap: int):
    """Compact the kept fat pairs to the tight capacity `live_cap`. Under
    pressure (more kept pairs than capacity) the core pairs come first,
    then the speculative shell, each in cache order; without pressure the
    cache order stands. Returns (a, b, valid, count), count the true kept
    demand."""
    cap = max(live_cap, 1)
    n = keep.shape[0]
    cnt = torch.sum(keep.to(torch.int32))
    pressure = cnt > cap
    first = torch.where(pressure, core, keep)
    second = keep & ~first
    sel, vv, _ = compact_mask(torch.cat([first, second]), cap)
    sel = torch.where(sel >= n, sel - n, sel)
    return (torch.where(vv, a[sel], 0), torch.where(vv, b[sel], 0), vv, cnt)


def persistent_broadphase(state, wc, cfg, base_broadphase):
    """(the step's box-box candidates Rec(a, b, valid, count), the new
    cache): the fat rebuild where `needs_rebuild`, else the cache as it
    stands, then the refilter against the current AABBs."""
    bp = state.bp
    if bool(needs_rebuild(state, cfg)):
        bp = rebuild(state, wc, cfg, base_broadphase)

    bodies, sleep, conn, bx = (state.bodies, state.sleep, state.connections,
                               state.boxes)
    lo, hi = box_aabbs(bx.half, wc.box_pos, wc.box_quat, cfg.aabb_margin)
    m2 = 2.0 * cfg.aabb_margin
    a64, b64 = bp.bb_a.long(), bp.bb_b.long()
    lo_a, hi_a, lo_b, hi_b = lo[a64], hi[a64], lo[b64], hi[b64]
    keep = bp.bb_valid & _pair_filter(bodies, sleep, bx.body[a64],
                                      bx.body[b64], conn, cfg)
    keep = keep & torch.all((lo_a <= hi_b) & (lo_b <= hi_a), dim=-1)
    core = keep & torch.all((lo_a <= hi_b - m2) & (lo_b <= hi_a - m2),
                            dim=-1)
    a, b, valid, count = two_tier_compact(keep, core, bp.bb_a, bp.bb_b,
                                          cfg.max_box_box_pairs)
    return Rec(a=a, b=b, valid=valid, count=count), bp
