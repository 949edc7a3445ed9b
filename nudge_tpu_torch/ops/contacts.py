"""Contact generation: broadphase -> narrowphase -> manifold compaction
(PyTorch port of `nudge_tpu.ops.contacts`, box-box only).

Contacts are grouped by collider pair into manifolds of up to 4 points
sharing (body_a, body_b, normal, friction); the solver works per manifold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import SimConfig
from ..state import SimState
from . import narrowphase as nps
from .broadphase import (
    allpairs_broadphase, compact_mask, world_colliders,
)
from .narrowphase_kernel import box_box_slots

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
    # bit0 box-box pairs | bit3 manifold compaction | bit5 grid cell
    # density | bit6 grid expand capacity
    overflow_bits: Optional[torch.Tensor] = None
    pair_demand: Optional[torch.Tensor] = None

    @property
    def contact_count(self) -> torch.Tensor:
        return torch.sum(self.point_valid.to(torch.int32))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def narrowphase_all(state: SimState, wc, bb, cfg: SimConfig):
    """Per-pair manifold slot arrays over the box-box candidates."""
    return box_box_slots(state.boxes, wc, bb)


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
        neg_inf = torch.tensor(-float("inf"), device=dev)
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
        out = x[idx]
        mask = valid.reshape(valid.shape + (1,) * (out.ndim - 1))
        return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype,
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


def collide(state: SimState, cfg: SimConfig) -> Manifolds:
    """Broadphase + narrowphase + compaction for one step."""
    if cfg.persistent_broadphase:
        raise NotImplementedError(
            "persistent_broadphase is not ported yet (ROADMAP Queue 1 item 9)")
    wc = world_colliders(state)
    bb, _, _ = _base_broadphase(cfg)(state, wc, cfg)
    slots = narrowphase_all(state, wc, bb, cfg)
    pair_overflow = bb.overflow
    bits = bb.overflow.to(torch.int32)
    if bb.flags is not None:        # grid pair/density/expand -> bits 0/5/6
        pair_overflow = pair_overflow | (bb.flags != 0)
        bits = bits | (bb.flags & 1)
        bits = bits | (((bb.flags >> 1) & 3) << 5)
    man = compact_manifolds(slots, cfg, pair_overflow, pair_bits=bits)
    return man.replace(pair_demand=bb.count)
