"""Collision detection of the reference step: world poses, the grid
broadphase (or the persistent broadphase's refilter of its cached fat
pairs, `persistent_bp`), the box-box narrowphase and the depth-priority
compaction into manifold slots. A frozen copy of the port's plain twins,
for box scenes (the grid path of scenes over 1,024 colliders)."""

from __future__ import annotations

import numpy as np
import torch

from . import narrowphase as nps
from .mathx import quat_mul, quat_rotate, quat_to_mat
from .tree import Rec

_I32_MAX = 2 ** 31 - 1


def world_colliders(state):
    """World poses of the box colliders. Padded colliders (body -1) read the
    last body, as a wrapped gather does."""
    bd, bx = state.bodies, state.boxes
    bq = bd.quat[bx.body]
    box_quat = quat_mul(bq, bx.lquat)
    box_pos = bd.pos[bx.body] + quat_rotate(bq, bx.lpos)
    return Rec(box_pos=box_pos, box_quat=box_quat, box_body=bx.body)


def box_aabbs(half, wpos, wquat, margin: float):
    """World AABB of oriented boxes: extent_i = Σ_j |R_ij|·half_j."""
    R = torch.abs(quat_to_mat(wquat))
    ext = (R[..., 0] * half[..., 0:1] + R[..., 1] * half[..., 1:2]
           + R[..., 2] * half[..., 2:3]) + margin
    return wpos - ext, wpos + ext


def _connection_mask(body_a, body_b, connections):
    """bool[...]: True where the body pair is in the user-filtered list."""
    ca, cb = connections[:, 0], connections[:, 1]
    lo = torch.minimum(body_a, body_b)[..., None]
    hi = torch.maximum(body_a, body_b)[..., None]
    clo = torch.minimum(ca, cb)
    chi = torch.maximum(ca, cb)
    return torch.any((lo == clo) & (hi == chi) & (ca >= 0), dim=-1)


def compact_mask(mask_flat: torch.Tensor, cap: int):
    """Indices of the first `cap` True entries (ascending). Returns
    (idx i64[cap], valid[cap], count i32). A prefix sum places every True
    entry at its rank; ranks are unique, so the scatter is deterministic
    (entries past `cap` all land in one discarded slot)."""
    n = mask_flat.shape[0]
    dev = mask_flat.device
    rank = torch.cumsum(mask_flat.to(torch.int64), 0) - 1
    count = (rank[-1] + 1) if n else torch.zeros((), dtype=torch.int64,
                                                  device=dev)
    tgt = torch.where(mask_flat & (rank < cap), rank,
                      torch.full_like(rank, cap))
    out = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=dev))
    valid = torch.arange(cap, device=dev) < torch.clamp_max(count, cap)
    idx = torch.where(valid, out[:cap], 0)
    return idx, valid, count.to(torch.int32)


def dead_mask(bodies, sleep, cfg):
    """bool[N]: bodies force-slept below the kill plane (they have left
    the world and leave the broadphase), or None when the kill plane or
    sleeping is off."""
    if cfg.kill_plane_y <= -1e8 or not cfg.sleeping:
        return None
    return ((bodies.inv_mass > 0.0) & ~sleep.awake
            & (bodies.pos[:, 1] < cfg.kill_plane_y))


def _pair_filter(bodies, sleep, body_a, body_b, connections, cfg=None):
    """Distinct bodies, not both non-moving, neither dead, not connected."""
    moving = (bodies.inv_mass > 0.0) & sleep.awake
    keep = body_a != body_b
    keep = keep & (moving[body_a] | moving[body_b])
    if cfg is not None:
        dead = dead_mask(bodies, sleep, cfg)
        if dead is not None:
            keep = keep & ~dead[body_a] & ~dead[body_b]
    if connections.shape[0] > 0:
        keep = keep & ~_connection_mask(body_a, body_b, connections)
    return keep


# Half stencil: home cell first, then the 13 lexicographically positive
# neighbour offsets.
_OFF_ALL = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                    axis=-1).reshape(27, 3)
_OFFSETS = _OFF_ALL[(_OFF_ALL[:, 0] * 9 + _OFF_ALL[:, 1] * 3
                     + _OFF_ALL[:, 2]) >= 0]                     # [14,3]


def _all_aabbs(state, wc, cfg):
    """Collider arrays over global ids (boxes only): lo/hi[G,3], body[G],
    valid[G]."""
    bx = state.boxes
    lo, hi = box_aabbs(bx.half, wc.box_pos, wc.box_quat, cfg.aabb_margin)
    body, valid = bx.body, bx.body >= 0
    dead = dead_mask(state.bodies, state.sleep, cfg)
    if dead is not None:
        valid = valid & ~dead[torch.clamp_min(body, 0)]
    return lo, hi, body, valid


def _median_or_one(ext, valid):
    """jnp.nan_to_num(jnp.median(where(valid, ext, nan)), nan=1.0)."""
    s = torch.sort(ext).values
    g = s.shape[0]
    mid = s[(g - 1) // 2] * 0.5 + s[g // 2] * 0.5
    return torch.where(torch.all(valid), mid, torch.ones_like(mid))


def grid_broadphase(state, wc, cfg):
    """The box-box candidate pairs: Rec(a, b, valid, count, flags)."""
    lo, hi, body, valid = _all_aabbs(state, wc, cfg)
    dev = lo.device
    g = lo.shape[0]
    center = 0.5 * (lo + hi)
    ext = torch.amax(0.5 * (hi - lo), dim=-1)

    med = _median_or_one(ext, valid)
    big = valid & (ext > 2.0 * med)
    if cfg.grid_cell > 0.0:
        cell = torch.full((), cfg.grid_cell, dtype=torch.float32, device=dev)
        big = valid & (2.0 * ext > cell)
    else:
        cell = 2.0 * torch.amax(torch.where(valid & ~big, ext, 0.0))
        cell = torch.clamp_min(cell, 1e-3)
    in_grid = valid & ~big

    ex, ey, ez = cfg.grid_table_dims
    dims = torch.tensor([ex, ey, ez], dtype=torch.int32, device=dev)
    coords_abs = torch.floor(center / cell).to(torch.int32)
    n_in = torch.clamp_min(torch.sum(in_grid.to(torch.float32)), 1.0)
    cmean = torch.floor(
        torch.sum(torch.where(in_grid[:, None], coords_abs.to(torch.float32),
                              0.0), dim=0) / n_in).to(torch.int32)
    cmin = cmean - dims // 2
    coords = torch.minimum(torch.clamp_min(coords_abs - cmin, 0), dims - 1)
    lin = (coords[:, 0] * ey + coords[:, 1]) * ez + coords[:, 2]
    tbl_size = ex * ey * ez
    # dead colliders park in cell tbl_size+1; out-of-extent queries read the
    # always-empty cell tbl_size
    lin = torch.where(in_grid, lin, tbl_size + 1)

    lin_sorted, order = torch.sort(lin, stable=True)
    order = order.to(torch.int32)
    pos_arr = torch.arange(g, dtype=torch.int32, device=dev)
    li = lin_sorted.to(torch.int64)
    start_tbl = torch.full((tbl_size + 2,), g, dtype=torch.int32, device=dev)
    start_tbl.scatter_reduce_(0, li, pos_arr, "amin")
    end_tbl = torch.zeros((tbl_size + 2,), dtype=torch.int32, device=dev)
    end_tbl.scatter_reduce_(0, li, pos_arr + 1, "amax")

    off = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)     # [14,3]
    n_off = off.shape[0]
    ncoords = coords[:, None, :] + off[None, :, :]                   # [G,14,3]
    in_ext = torch.all((ncoords >= 0) & (ncoords < dims), dim=-1)
    nlin = (ncoords[..., 0] * ey + ncoords[..., 1]) * ez + ncoords[..., 2]
    nlin = torch.where(in_ext, nlin, tbl_size).to(torch.int64)       # [G,14]

    qlo = start_tbl[nlin]
    qhi = end_tbl[nlin]
    cnt_raw = torch.where(in_grid[:, None], torch.clamp_min(qhi - qlo, 0), 0)
    density_overflow = torch.any(cnt_raw > cfg.grid_density)
    cnt = torch.clamp_max(cnt_raw, cfg.grid_density)

    # --- two-stage expansion into a flat candidate list -------------------
    cnt_flat = cnt.reshape(-1).to(torch.int64)                       # [G*14]
    qlo_flat = qlo.reshape(-1).to(torch.int64)
    offs = torch.cumsum(cnt_flat, 0)
    total_cand = offs[-1]
    off0 = offs - cnt_flat                                           # exclusive
    cap = cfg.grid_expand_cap or min(16 * cfg.total_pairs, 64 * g)
    # segment of every output slot: the one whose [off0, offs) holds it.
    # The reference marks segment starts and takes a running max; for the
    # live slots (t < total_cand) both name the same, always non-empty,
    # segment, and a search over the prefix sums needs no scan.
    t_slot = torch.arange(cap, dtype=torch.int64, device=dev)
    seg_c = torch.clamp_max(torch.searchsorted(offs, t_slot, right=True),
                            cnt_flat.shape[0] - 1)
    live = t_slot < total_cand
    pos = torch.clamp(qlo_flat[seg_c] + (t_slot - off0[seg_c]), 0, g - 1)

    i = torch.clamp_max(seg_c // n_off, g - 1)                       # querier
    same_cell = (seg_c % n_off) == 0

    moving = ((state.bodies.inv_mass > 0.0) & state.sleep.awake)[body]
    j = order[pos].to(torch.int64)                                   # candidate
    j_body = body[j]
    i_body = body[i]
    i32 = i.to(torch.int32)
    j32 = j.to(torch.int32)
    keep = live & valid[j] & torch.where(same_cell, j > i, j != i)
    keep &= torch.all((lo[i] <= hi[j]) & (lo[j] <= hi[i]), dim=-1)
    keep &= i_body != j_body
    keep &= moving[i] | moving[j]
    if state.connections.shape[0] > 0:
        keep &= ~_connection_mask(i_body, j_body, state.connections)
    expand_overflow = total_cand > cap

    # --- big colliders: dense side channel against everyone ---
    big_cap = cfg.max_big_colliders
    bidx, bvalid, _ = compact_mask(big, big_cap)
    big_idx = torch.where(bvalid, bidx, g - 1)
    big_valid = torch.arange(big_cap, device=dev) < torch.sum(big.to(torch.int32))
    bi = big_idx[:, None]
    bj = torch.arange(g, dtype=torch.int64, device=dev)[None, :]
    b_overlap = torch.all((lo[bi] <= hi[bj]) & (lo[bj] <= hi[bi]), dim=-1)
    b_keep = b_overlap & big_valid[:, None] & valid[bj]
    b_keep &= (bj != bi) & (~big[bj] | (bj > bi))
    b_keep &= _pair_filter(state.bodies, state.sleep, body[bi], body[bj],
                           state.connections, cfg)
    b_a = torch.minimum(bi, bj).to(torch.int32)
    b_b = torch.maximum(bi, bj).to(torch.int32)

    # --- compact all candidates once, then split by class ---
    flat_a = torch.cat([torch.minimum(i32, j32), b_a.reshape(-1)])
    flat_b = torch.cat([torch.maximum(i32, j32), b_b.reshape(-1)])
    flat_keep = torch.cat([keep, b_keep.reshape(-1)])

    pcap = cfg.total_pairs
    sel, sel_valid, total = compact_mask(flat_keep, pcap)
    a_s = torch.where(sel_valid, flat_a[sel], 0)
    b_s = torch.where(sel_valid, flat_b[sel], 0)

    def split(mask, cap_c, a_vals, b_vals):
        ii, vv, cnt_c = compact_mask(mask, cap_c)
        return Rec(
            a=torch.where(vv, a_vals[ii], 0).to(torch.int32),
            b=torch.where(vv, b_vals[ii], 0).to(torch.int32),
            valid=vv, count=cnt_c)

    nb = cfg.max_boxes
    bb = split(sel_valid & (b_s < nb), cfg.max_box_box_pairs, a_s, b_s)
    bb = bb.replace(flags=(torch.where(total > pcap, 1, 0)
                           | torch.where(density_overflow, 2, 0)
                           | torch.where(expand_overflow, 4, 0)).to(torch.int32))
    return bb


def combine_friction(fa, fb):
    """Geometric-mean material combine."""
    return torch.sqrt(torch.clamp_min(fa * fb, 0.0))


def box_box_slots(bx, wc, bb):
    """Per-pair manifold slots with the plain PyTorch twin."""
    a = bb.a.to(torch.int64)
    b = bb.b.to(torch.int64)
    man = nps.box_box(bx.half[a], wc.box_quat[a], wc.box_pos[a],
                      bx.half[b], wc.box_quat[b], wc.box_pos[b])
    return dict(
        body_a=bx.body[a], body_b=bx.body[b],
        ga=bb.a.to(torch.int32), gb=bb.b.to(torch.int32),
        normal=man["normal"],
        friction=combine_friction(bx.friction[a], bx.friction[b]),
        pos=man["pos"], depth=man["depth"], feat=man["feat"],
        point_valid=man["valid"] & bb.valid[:, None],
    )


# the manifold slot fields, in the kernels' order of output arguments: the
# shape of one pair slot's row, and the type
_F32, _I32 = torch.float32, torch.int32


def compact_manifolds(slots: dict, cfg, pair_overflow,
                      pair_bits=None):
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
    return Rec(
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


def collide(state, cfg):
    """Broadphase, narrowphase and compaction for one step (the grid
    broadphase, or the persistent broadphase's refilter; boxes only).
    Returns (the manifolds, the persistent broadphase's cache: the
    state's own when that is off)."""
    if cfg.max_spheres:
        raise NotImplementedError("the reference steps box scenes only")
    wc = world_colliders(state)
    if cfg.persistent_broadphase:
        bb, bp = _persistent_pairs(state, wc, cfg)
    else:
        bb, bp = grid_broadphase(state, wc, cfg), state.bp
    slots = box_box_slots(state.boxes, wc, bb)
    overflow = bb.count > bb.a.shape[0]
    if cfg.persistent_broadphase:
        # the rebuild's drops poison every step until the next rebuild
        pair_overflow = overflow | bp.overflow
        bits = overflow.to(torch.int32)
        bits = bits | torch.where(bp.overflow, 16, 0).to(torch.int32)
        bits = bits | torch.where(bp.overflow, ((bp.flags >> 1) & 3) << 5, 0)
    else:
        pair_overflow = overflow | (bb.flags != 0)
        bits = overflow.to(torch.int32) | (bb.flags & 1)
        bits = bits | (((bb.flags >> 1) & 3) << 5)
    man = compact_manifolds(slots, cfg, pair_overflow, pair_bits=bits)
    return man.replace(pair_demand=bb.count), bp


def _persistent_pairs(state, wc, cfg):
    """The persistent broadphase's candidates and cache. Its rebuild
    caches pairs as if every body were awake, so waking islands reconnect
    at once; dead bodies (below the kill plane) stay out of it."""
    from . import persistent_bp

    dead = dead_mask(state.bodies, state.sleep, cfg)
    rb_awake = torch.ones_like(state.sleep.awake)
    if dead is not None:
        rb_awake = rb_awake & ~dead
    awake_state = state.replace(sleep=state.sleep.replace(awake=rb_awake))

    def base_awake(_, wcx, cfgx):
        return grid_broadphase(awake_state, wcx, cfgx)

    return persistent_bp.persistent_broadphase(state, wc, cfg, base_awake)
