"""Broadphase: world AABBs + candidate pairs (PyTorch port of
`nudge_tpu.ops.broadphase`).

Masked all-pairs test compacted to fixed capacity; the grid path for large
scenes lives in ops/grid.py. Overflow sets a flag instead of corrupting.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import SimConfig
from ..mathx import quat_mul, quat_rotate, quat_to_mat
from ..state import SimState


class WorldColliders(NamedTuple):
    box_pos: torch.Tensor     # f32[B,3]
    box_quat: torch.Tensor    # f32[B,4]
    box_body: torch.Tensor    # i32[B]


@dataclasses.dataclass
class CandidatePairs:
    """Fixed-capacity candidate pairs for one narrowphase class."""

    a: torch.Tensor          # i32[P] collider index
    b: torch.Tensor          # i32[P]
    valid: torch.Tensor      # bool[P]
    count: torch.Tensor      # i32 true number of candidates (may exceed P)
    # overflow attribution: bit0 pair capacity, bit1 grid cell density,
    # bit2 grid expand capacity
    flags: Optional[torch.Tensor] = None

    @property
    def overflow(self) -> torch.Tensor:
        return self.count > self.a.shape[-1]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def world_colliders(state: SimState) -> WorldColliders:
    """World transforms of the box colliders. Padded colliders (body -1)
    read the last body, as the reference's wrapped gather does."""
    bd, bx = state.bodies, state.boxes
    bq = bd.quat[bx.body]
    box_quat = quat_mul(bq, bx.lquat)
    box_pos = bd.pos[bx.body] + quat_rotate(bq, bx.lpos)
    return WorldColliders(box_pos, box_quat, bx.body)


def box_aabbs(half, wpos, wquat, margin: float):
    """World AABB of oriented boxes: extent_i = Σ_j |R_ij|·half_j."""
    R = torch.abs(quat_to_mat(wquat))
    ext = (R[..., 0] * half[..., 0:1] + R[..., 1] * half[..., 1:2]
           + R[..., 2] * half[..., 2:3]) + margin
    return wpos - ext, wpos + ext


def _aabb_overlap(lo_a, hi_a, lo_b, hi_b):
    """[Na,3] x [Nb,3] -> bool[Na,Nb]."""
    return torch.all(
        (lo_a[:, None, :] <= hi_b[None, :, :])
        & (lo_b[None, :, :] <= hi_a[:, None, :]),
        dim=-1,
    )


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


def _compact_pairs(mask, cap: int, n_cols: int) -> CandidatePairs:
    idx, valid, count = compact_mask(mask.reshape(-1), cap)
    return CandidatePairs(
        a=(idx // n_cols).to(torch.int32),
        b=(idx % n_cols).to(torch.int32),
        valid=valid,
        count=count,
    )


def dead_mask(bodies, sleep, cfg: SimConfig):
    """bool[N]: bodies force-slept below the kill plane, or None when the
    kill plane is off (always, while the port runs without sleeping)."""
    if cfg.kill_plane_y <= -1e8 or not cfg.sleeping:
        return None
    return (bodies.dynamic & ~sleep.awake
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


def empty_pairs(device) -> CandidatePairs:
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return CandidatePairs(a=z, b=z, valid=z.bool(),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=device))


def allpairs_broadphase(state: SimState, wc: WorldColliders, cfg: SimConfig):
    """Masked all-pairs broadphase over boxes. Returns (bb, bs, ss)."""
    bodies, sleep, bx = state.bodies, state.sleep, state.boxes
    blo, bhi = box_aabbs(bx.half, wc.box_pos, wc.box_quat, cfg.aabb_margin)
    nb = cfg.max_boxes
    bb_mask = _aabb_overlap(blo, bhi, blo, bhi)
    iu = torch.arange(nb, device=blo.device)
    bb_mask &= iu[:, None] < iu[None, :]
    bb_mask &= bx.valid[:, None] & bx.valid[None, :]
    bb_mask &= _pair_filter(bodies, sleep, bx.body[:, None], bx.body[None, :],
                            state.connections, cfg)
    bb = _compact_pairs(bb_mask, cfg.max_box_box_pairs, nb)
    bb = bb.replace(flags=bb.overflow.to(torch.int32))
    empty = empty_pairs(blo.device)
    return bb, empty, empty
