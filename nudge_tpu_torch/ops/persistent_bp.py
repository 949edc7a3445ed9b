"""Persistent (amortized) broadphase (PyTorch port of
`nudge_tpu.ops.persistent_bp`).

At rebuild time the candidate pairs are generated with a fat speculative
margin (cfg.rebuild_margin) under fat pair capacities and cached in the
state with anchor positions and orientations. Every step each body's
conservative displacement since its anchor, |x - x0| + 2 r |q - q0| (r the
body's circumradius), is held against rebuild_margin / 2: while no body has
moved that far, every pair whose AABBs overlap now was inside the fat set,
so the cache is a superset of the live pairs. Each step then re-filters the
fat set against the current AABBs and the live filters (sleep, the kill
plane, connections) and compacts it to the tight per-class capacity.

Translation notes against the reference:
  - the reference picks rebuild or reuse with `lax.cond`; here
    `control.cond` on the device flag `needs_rebuild` (a predicate read in
    the eager step, two conditional graph nodes in the compiled one);
  - the tight-list memo (`bb_code`, `tight_bb_*`, `memo_ok`) serves only the
    reference's `aligned_fast_path`, which the port does not have: with it
    off the reference always runs `two_tier_compact`, and reads the memo
    nowhere else, so leaving it out changes no output;
  - `two_tier_compact` sorts a 2^30-sentinel key in the reference; here the
    same order (core pairs first under pressure, else cache order) comes
    from one prefix-sum compaction over [first tier | second tier].
"""

from __future__ import annotations

import dataclasses

import torch

from .. import control
from ..config import SimConfig
from ..state import SimState, _Replace
from .broadphase import (
    CandidatePairs, WorldColliders, _pair_filter, box_aabbs, compact_mask,
    empty_pairs, sphere_aabbs,
)


@dataclasses.dataclass
class BPCache(_Replace):
    """Cached fat candidate pairs + rebuild anchors (part of SimState)."""

    bb_a: torch.Tensor        # i32[Pbb] fat box-box pairs
    bb_b: torch.Tensor
    bb_valid: torch.Tensor    # bool[Pbb]
    bs_a: torch.Tensor
    bs_b: torch.Tensor
    bs_valid: torch.Tensor
    ss_a: torch.Tensor
    ss_b: torch.Tensor
    ss_valid: torch.Tensor
    overflow: torch.Tensor    # bool: the last rebuild dropped pairs
    flags: torch.Tensor       # i32 rebuild-time attribution (grid flags:
                              # bit0 fat pair cap, bit1 cell density, bit2
                              # expand cap)
    anchor_pos: torch.Tensor  # f32[N,3]
    anchor_quat: torch.Tensor  # f32[N,4]
    stale: torch.Tensor       # bool: force a rebuild (initial state)


def fat_cfg(cfg: SimConfig) -> SimConfig:
    """Config the rebuild runs under: the fat margin AND fat pair
    capacities (a lattice spawn has ~13 half-stencil neighbours per body
    within the 0.1 margin, more than the tight capacity holds)."""
    k = max(cfg.fat_pair_factor, 1)
    return cfg.replace(
        aabb_margin=cfg.rebuild_margin,
        max_box_box_pairs=k * cfg.max_box_box_pairs,
        max_box_sphere_pairs=k * cfg.max_box_sphere_pairs,
        max_sphere_sphere_pairs=k * cfg.max_sphere_sphere_pairs,
    )


def empty_bp_cache(cfg: SimConfig, n_bodies: int,
                   device="cuda") -> BPCache:
    fat = fat_cfg(cfg)

    def z(c):
        return torch.zeros((c,), dtype=torch.int32, device=device)

    def f(c):
        return torch.zeros((c,), dtype=torch.bool, device=device)

    nbb = fat.max_box_box_pairs
    ns = max(fat.max_box_sphere_pairs, 0)
    nss = max(fat.max_sphere_sphere_pairs, 0)
    return BPCache(
        bb_a=z(nbb), bb_b=z(nbb), bb_valid=f(nbb),
        bs_a=z(ns), bs_b=z(ns), bs_valid=f(ns),
        ss_a=z(nss), ss_b=z(nss), ss_valid=f(nss),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        flags=torch.zeros((), dtype=torch.int32, device=device),
        anchor_pos=torch.zeros((n_bodies, 3), dtype=torch.float32,
                               device=device),
        anchor_quat=torch.zeros((n_bodies, 4), dtype=torch.float32,
                                device=device),
        stale=torch.ones((), dtype=torch.bool, device=device),
    )


def _norm(x):
    """Euclidean norm over the last axis, summed in index order."""
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return torch.sqrt(s)


def _body_radius(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Per-body circumradius over its colliders (for the rotation bound)."""
    n = state.bodies.pos.shape[0]
    bx, sp = state.boxes, state.spheres
    r = torch.zeros((n,), dtype=torch.float32, device=bx.half.device)
    r_box = _norm(bx.half) + _norm(bx.lpos)
    r.scatter_reduce_(0, torch.clamp_min(bx.body, 0).long(),
                      torch.where(bx.valid, r_box, 0.0), "amax")
    if cfg.max_spheres > 0:
        r_s = sp.radius + _norm(sp.lpos)
        r.scatter_reduce_(0, torch.clamp_min(sp.body, 0).long(),
                          torch.where(sp.valid, r_s, 0.0), "amax")
    return r


def needs_rebuild(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """bool 0-d tensor: the cache is stale or some body moved past half the
    rebuild margin since its anchor."""
    bp = state.bp
    d = _norm(state.bodies.pos - bp.anchor_pos)
    dq = _norm(state.bodies.quat - bp.anchor_quat)
    disp = d + 2.0 * _body_radius(state, cfg) * dq
    return bp.stale | torch.any(disp > 0.5 * cfg.rebuild_margin)


def _rebuild(state: SimState, wc: WorldColliders, cfg: SimConfig,
             base_broadphase) -> BPCache:
    bb, bs, ss = base_broadphase(state, wc, fat_cfg(cfg))
    ovf = bb.overflow
    if bs.a.shape[0] > 0:
        ovf = ovf | bs.overflow | ss.overflow
    if bb.flags is not None:       # grid density/expand drops are real drops
        ovf = ovf | (bb.flags != 0)
    flg = ovf.to(torch.int32)
    if bb.flags is not None:
        flg = flg | bb.flags
    old = state.bp
    has_sph = bs.a.shape[0] > 0
    return BPCache(
        bb_a=bb.a, bb_b=bb.b, bb_valid=bb.valid,
        bs_a=bs.a if has_sph else old.bs_a,
        bs_b=bs.b if has_sph else old.bs_b,
        bs_valid=bs.valid if has_sph else old.bs_valid,
        ss_a=ss.a if ss.a.shape[0] else old.ss_a,
        ss_b=ss.b if ss.a.shape[0] else old.ss_b,
        ss_valid=ss.valid if ss.a.shape[0] else old.ss_valid,
        overflow=ovf, flags=flg,
        anchor_pos=state.bodies.pos, anchor_quat=state.bodies.quat,
        stale=torch.zeros((), dtype=torch.bool, device=ovf.device),
    )


def two_tier_compact(keep, core, a, b, live_cap: int):
    """Compact the kept fat pairs to the tight capacity `live_cap`. Under
    pressure (more kept pairs than capacity) the CORE pairs come first,
    then the speculative shell, each in cache order, so an overflow sheds
    the speculative pairs first; without pressure the cache order stands.
    Returns (a, b, valid, count) with count the true kept demand."""
    cap = max(live_cap, 1)
    n = keep.shape[0]
    cnt = torch.sum(keep.to(torch.int32))
    pressure = cnt > cap
    first = torch.where(pressure, core, keep)
    second = keep & ~first
    sel, vv, _ = compact_mask(torch.cat([first, second]), cap)
    sel = torch.where(sel >= n, sel - n, sel)
    return (torch.where(vv, a[sel], 0), torch.where(vv, b[sel], 0), vv, cnt)


def persistent_broadphase(state: SimState, wc: WorldColliders,
                          cfg: SimConfig, base_broadphase, rebuild=None):
    """Returns ((bb, bs, ss), new BPCache). `base_broadphase(state, wc, cfg)`
    is the full rebuild (grid or all-pairs), run under `fat_cfg`. `rebuild`
    forces the decision (a bool, or a 0-d bool tensor); by default it is
    `needs_rebuild`, on the device."""
    if rebuild is None:
        rebuild = needs_rebuild(state, cfg)
    elif isinstance(rebuild, bool):
        rebuild = torch.full((), rebuild, dtype=torch.bool,
                             device=state.bodies.pos.device)

    def fat(s, w):
        persistent_broadphase.rebuilds += 1
        return _rebuild(s, w, cfg, base_broadphase)

    bp = control.cond(rebuild, fat, lambda s, w: s.bp, (state, wc),
                      name="rebuild")

    bodies, sleep, conn = state.bodies, state.sleep, state.connections
    bx, sp = state.boxes, state.spheres
    blo, bhi = box_aabbs(bx.half, wc.box_pos, wc.box_quat, cfg.aabb_margin)
    m2 = 2.0 * cfg.aabb_margin

    def refilter(a, b, valid, body_a, body_b, lo, hi, lo_b, hi_b, live_cap):
        """Current-AABB overlap + live filters over the fat array (keep),
        and the pairs that overlap with the margin stripped (core), then
        the two-tier compaction."""
        a64, b64 = a.long(), b.long()
        lo_a, hi_a, lo_bb, hi_bb = lo[a64], hi[a64], lo_b[b64], hi_b[b64]
        keep = valid & _pair_filter(bodies, sleep, body_a[a64], body_b[b64],
                                    conn, cfg)
        keep = keep & torch.all((lo_a <= hi_bb) & (lo_bb <= hi_a), dim=-1)
        core = keep & torch.all((lo_a <= hi_bb - m2) & (lo_bb <= hi_a - m2),
                                dim=-1)
        a_s, b_s, vv, cnt = two_tier_compact(keep, core, a, b, live_cap)
        return CandidatePairs(a=a_s, b=b_s, valid=vv, count=cnt)

    bb = refilter(bp.bb_a, bp.bb_b, bp.bb_valid, bx.body, bx.body,
                  blo, bhi, blo, bhi, cfg.max_box_box_pairs)
    if cfg.max_spheres > 0:
        slo, shi = sphere_aabbs(sp.radius, wc.sph_pos, cfg.aabb_margin)
        bs = refilter(bp.bs_a, bp.bs_b, bp.bs_valid, bx.body, sp.body,
                      blo, bhi, slo, shi, cfg.max_box_sphere_pairs)
        ss = refilter(bp.ss_a, bp.ss_b, bp.ss_valid, sp.body, sp.body,
                      slo, shi, slo, shi, cfg.max_sphere_sphere_pairs)
    else:
        bs = ss = empty_pairs(blo.device)
    # bb.count stays the true tight demand (pair telemetry); collide() ORs
    # bp.overflow into the step's overflow flag
    return (bb, bs, ss), bp


control.counter(persistent_broadphase, "rebuilds")
