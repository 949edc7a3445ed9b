"""Scalable broadphase: uniform grid via sort + dense cell table (PyTorch
port of `nudge_tpu.ops.grid`).

Every collider gets one home cell in a dense table of static extent
(cfg.grid_table_dims), re-based to the scene's mean cell each step and
clamped at the borders. Colliders are sorted by cell; per-cell [start, end)
ranges are scatter-built into the table; each collider reads up to
`grid_density` entries of its home cell and its 13 lexicographically
positive neighbours, so every overlapping pair is emitted exactly once.
Oversized colliders (the ground slab, the walls) skip the grid and are
tested densely against everyone through a small side channel.

Translation notes against the reference:
  - `jnp.median` of a NaN-masked array is NaN whenever any collider slot is
    padding (and then falls back to 1.0), else the mean of the two middle
    values; `torch.median` would return the lower middle value instead;
  - the reference finds each expanded candidate slot's segment with a
    dropped-out-of-range scatter of segment starts and an associative max
    scan; here one `searchsorted` over the segments' prefix sums gives the
    same segment for every live slot (a cummax scan over the ~1.3M slots
    of the 20,480 pile cost 3.7 ms per step on the H100);
  - `nonzero(size=, fill_value=)` is `compact_mask` plus explicit fill.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..state import SimState
from .broadphase import (
    CandidatePairs, WorldColliders, _connection_mask, _pair_filter, box_aabbs,
    compact_mask, dead_mask, empty_pairs,
)

# Half stencil: home cell first, then the 13 lexicographically positive
# neighbour offsets.
_OFF_ALL = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                    axis=-1).reshape(27, 3)
_OFFSETS = _OFF_ALL[(_OFF_ALL[:, 0] * 9 + _OFF_ALL[:, 1] * 3
                     + _OFF_ALL[:, 2]) >= 0]                     # [14,3]


def _all_aabbs(state: SimState, wc: WorldColliders, cfg: SimConfig):
    bx = state.boxes
    lo, hi = box_aabbs(bx.half, wc.box_pos, wc.box_quat, cfg.aabb_margin)
    valid = bx.valid
    dead = dead_mask(state.bodies, state.sleep, cfg)
    if dead is not None:
        valid = valid & ~dead[torch.clamp_min(bx.body, 0)]
    return lo, hi, bx.body, valid


def _median_or_one(ext, valid):
    """jnp.nan_to_num(jnp.median(where(valid, ext, nan)), nan=1.0)."""
    s = torch.sort(ext).values
    g = s.shape[0]
    mid = s[(g - 1) // 2] * 0.5 + s[g // 2] * 0.5
    return torch.where(torch.all(valid), mid, torch.ones_like(mid))


def grid_broadphase(state: SimState, wc: WorldColliders, cfg: SimConfig):
    """Returns (bb, bs, ss) CandidatePairs like allpairs_broadphase."""
    lo, hi, body, valid = _all_aabbs(state, wc, cfg)
    dev = lo.device
    g = lo.shape[0]
    center = 0.5 * (lo + hi)
    ext = torch.amax(0.5 * (hi - lo), dim=-1)

    med = _median_or_one(ext, valid)
    big = valid & (ext > 2.0 * med)
    if cfg.grid_cell > 0.0:
        cell = torch.tensor(cfg.grid_cell, dtype=torch.float32, device=dev)
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

    off = torch.as_tensor(_OFFSETS, dtype=torch.int32, device=dev)  # [14,3]
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
    is_bb = sel_valid & (b_s < cfg.max_boxes)
    ii, vv, cnt_bb = compact_mask(is_bb, cfg.max_box_box_pairs)
    flags = (torch.where(total > pcap, 1, 0)
             | torch.where(density_overflow, 2, 0)
             | torch.where(expand_overflow, 4, 0)).to(torch.int32)
    bb = CandidatePairs(
        a=torch.where(vv, a_s[ii], 0).to(torch.int32),
        b=torch.where(vv, b_s[ii], 0).to(torch.int32),
        valid=vv, count=cnt_bb, flags=flags,
    )
    empty = empty_pairs(dev)
    return bb, empty, empty
