"""The iterated contact solve: the CUDA kernel's wrapper, and the
color-sorted order that setup writes the solve's rows in.

Replaces `nudge_tpu/ops/solver_kernel.py: solve_packed` (kernel body
`_solve_kernel`, also reached through `solve_pallas`). The TPU kernel ran
the whole solve as one sequential Pallas grid over color-sorted 1,024-wide
groups. Here `color_order` sorts the manifolds once a step, before setup,
by (color, smallest dynamic body id), as the TPU kernel's `spatial_subkey`
orders them; setup (ops/setup_kernel.py) writes each manifold's rows at its
slot in that order, and one launch of csrc/solve.cu runs every sweep and
every color over those rows, reading the color segments' offsets, the
color count and the spill color from device memory: no host read. The
spill color runs as Jacobi through deterministic per-body segment sums
over the body-sorted entry lists that setup's warm start also uses.

`solve` takes and returns velw[N,12] (v | w | pseudo v | pseudo w). It
dispatches by device: CPU tensors go to the plain twin `solve_plain`
(`solver.solve_from`) over a `ContactConstraints`; CUDA tensors launch the
kernel over setup's `PackedConstraints`, or raise. The CUDA path updates
velw and setup's work rows in place.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..config import CONTACT_POINTS, SimConfig
from . import solver

VEL_ROW = 12
# The solve's constraint rows: (field, words per manifold), stored
# field-major in slot order, vector fields point-major (csrc/common.cuh
# kRow*). Body ids are int32 bits, point_valid is 0.0 / 1.0.
ROW_FIELDS = (
    ("n", 3), ("t1", 3), ("t2", 3),
    ("ra", 12), ("rb", 12), ("jna", 12), ("jnb", 12), ("jt1a", 12),
    ("jt1b", 12), ("jt2a", 12), ("jt2b", 12),
    ("mn", 4), ("mt1", 4), ("mt2", 4), ("bias", 4), ("pos_bias", 4),
    ("pwarm", 4),
    ("mu", 1), ("im_a", 1), ("im_b", 1), ("relax", 1), ("point_valid", 4),
    ("body_a", 1), ("body_b", 1),
)
ROWS = sum(w for _, w in ROW_FIELDS)
# The work rows (slot order): λn, λt1, λt2, pseudo λ (4 points each), then
# 24 scratch rows (csrc/common.cuh kWork*)
WORK_ROWS = 4 * CONTACT_POINTS + 2 * VEL_ROW
_SUBKEY_BIG = (1 << 24) - 1
_I32_MAX = 2 ** 31 - 1


def pack_velw(vel, angvel, pvel, pang):
    return torch.cat([vel, angvel, pvel, pang], 1).contiguous()


def solve_plain(velw, con: solver.ContactConstraints, acc, cfg: SimConfig):
    """Plain PyTorch twin of the solve kernel."""
    vel, angvel, acc, (pv, pw), pacc = solver.solve_from(
        velw[:, 0:3], velw[:, 3:6], con, acc,
        (velw[:, 6:9], velw[:, 9:12]), cfg)
    return pack_velw(vel, angvel, pv, pw), acc, pacc


@dataclasses.dataclass
class SlotOrder:
    """Where each manifold sits in the solve's color-sorted layout, and the
    body-sorted entry lists of the per-body sums."""

    order: torch.Tensor    # i64[M] the manifold at each slot
    slot: torch.Tensor     # i32[M] the slot of each manifold
    offsets: torch.Tensor  # i32[max_colors+1] segment starts; last = live
    keys_a: torch.Tensor   # i32[M] side-a body of each entry, sorted
    perm_a: torch.Tensor   # i64[M] its manifold
    keys_b: torch.Tensor
    perm_b: torch.Tensor


def body_segments(body, take):
    """(keys, perm) for a deterministic per-body segment sum: `keys` are the
    body ids of the entries with `take` (INT32_MAX elsewhere) in stable
    sorted order along the last dim, `perm` the manifold of each entry."""
    keys = torch.where(take, body, _I32_MAX).to(torch.int32)
    keys, perm = torch.sort(keys, dim=-1, stable=True)
    return keys.contiguous(), perm.contiguous()


def color_order(man, bodies, coloring, cfg: SimConfig) -> SlotOrder:
    """The solve's order, from the coloring, before setup: a stable sort of
    the manifolds by (color, smallest dynamic body id), manifolds that are
    not live (color max_colors) last; each slot's manifold, each manifold's
    slot and each color's segment start. Also the side-a and side-b entry
    lists of every live manifold's dynamic bodies, sorted stably by body
    (manifold order within a body): setup's warm start sums every entry,
    the solve's spill color the entries of its own color."""
    K = cfg.max_colors
    color = coloring[0]
    m = color.shape[0]
    dev = color.device
    ab = torch.stack([man.body_a, man.body_b])           # [2, M]
    dyn = (bodies.inv_mass > 0.0)[ab]
    sub = torch.amin(torch.where(dyn, ab, _SUBKEY_BIG), 0)
    col = torch.clamp_max(color, K)
    # (color, sub) as one key; int32 while max_colors < 127
    wide = torch.int64 if K >= 127 else torch.int32
    order = torch.sort(col.to(wide) * (1 << 24) + sub, stable=True).indices
    offsets = torch.searchsorted(
        col[order], torch.arange(K + 1, dtype=col.dtype, device=dev),
        out_int32=True)
    slot = torch.empty(m, dtype=torch.int32, device=dev)
    slot[order] = torch.arange(m, dtype=torch.int32, device=dev)
    keys, perm = body_segments(ab, man.valid & dyn)       # both sides at once
    return SlotOrder(order=order, slot=slot, offsets=offsets,
                     keys_a=keys[0], perm_a=perm[0], keys_b=keys[1],
                     perm_b=perm[1])


def solve_cluster_size() -> int:
    """The thread-block cluster size the solve kernel launches with."""
    return _build.library().lib.nudge_solve_cluster()


def solve_cuda(velw, con, acc, cfg: SimConfig):
    """Run the solve kernel over setup's `PackedConstraints` and work rows
    `acc`, both updated in place. Returns (velw, (λn, λt1, λt2),
    pseudo_acc), the accumulators in manifold order."""
    if cfg.differentiable:
        raise NotImplementedError(
            "differentiable mode has no kernel path yet (ROADMAP Queue 1 "
            "item 5)")
    n = velw.shape[0]
    m = con.rows.shape[1]
    K = cfg.max_colors
    o = con.order
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, t, dt, shape in (
            ("velw", velw, f32, (n, VEL_ROW)),
            ("rows", con.rows, f32, (ROWS, m)),
            ("work", acc, f32, (WORK_ROWS, m)),
            ("offsets", o.offsets, i32, (K + 1,)),
            ("n_colors", con.n_colors, i32, ()),
            ("spill_color", con.spill_color, i32, ()),
            ("slot", o.slot, i32, (m,)), ("keys_a", o.keys_a, i32, (m,)),
            ("perm_a", o.perm_a, i64, (m,)), ("keys_b", o.keys_b, i32, (m,)),
            ("perm_b", o.perm_b, i64, (m,))):
        _build.check_cuda("solve", name, t, dt, shape)
    if velw.data_ptr() % 16:
        raise ValueError("solve kernel: velw needs a 16-byte aligned base "
                         "(it reads and writes each body's row as 16-byte "
                         "words)")
    out = torch.empty((4, m, CONTACT_POINTS), dtype=f32, device=velw.device)
    _build.library().call(
        "nudge_solve", _build.ptr(con.rows), _build.ptr(acc), _build.ptr(velw),
        _build.ptr(out), _build.ptr(o.offsets), _build.ptr(con.n_colors),
        _build.ptr(con.spill_color), _build.ptr(o.slot), _build.ptr(o.keys_a),
        _build.ptr(o.perm_a), _build.ptr(o.keys_b), _build.ptr(o.perm_b), m, K,
        cfg.solver_iters, int(cfg.split_impulse),
        int(cfg.split_impulse and cfg.pseudo_friction),
        _build.stream_of(velw))
    solve.launches += 1
    return velw, (out[0], out[1], out[2]), out[3]


def solve(velw, con, acc, cfg: SimConfig):
    """The iterated solve from warm-started velw. Returns (velw,
    (λn, λt1, λt2), pseudo_acc[M,P])."""
    dev = velw.device
    if dev.type == "cpu":
        return solve_plain(velw, con, acc, cfg)
    if dev.type == "cuda":
        return solve_cuda(velw, con, acc, cfg)
    raise NotImplementedError(f"solve: no kernel for device {dev}")


solve.launches = 0
