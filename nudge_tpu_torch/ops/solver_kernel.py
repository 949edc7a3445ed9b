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
velw and setup's work rows in place, except in the differentiable mode:
when an input requires grad the kernel runs inside `SolveFn` on copies,
recording a tape of each visit, and its backward is csrc/solve_bwd.cu's
reverse sweep, one manifold on two lanes (`solve_backward_cuda`; plain
version `solve_backward_plain`, autograd of the twin).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..config import CONTACT_POINTS, SimConfig
from ..state import flatten
from . import solver
from .segment import entries, segment_sum

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
# each field's first row
ROW_OFFSET = {name: sum(w for _, w in ROW_FIELDS[:k])
              for k, (name, _) in enumerate(ROW_FIELDS)}
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


def _order_args(kernel: str, con, cfg: SimConfig):
    """Pointers to the solve's color segments and body-sorted entries,
    checked."""
    m = con.rows.shape[1]
    K = cfg.max_colors
    o = con.order
    i32, i64 = torch.int32, torch.int64
    for name, t, dt, shape in (
            ("offsets", o.offsets, i32, (K + 1,)),
            ("n_colors", con.n_colors, i32, ()),
            ("spill_color", con.spill_color, i32, ()),
            ("slot", o.slot, i32, (m,)), ("keys_a", o.keys_a, i32, (m,)),
            ("perm_a", o.perm_a, i64, (m,)), ("keys_b", o.keys_b, i32, (m,)),
            ("perm_b", o.perm_b, i64, (m,))):
        _build.check_cuda(kernel, name, t, dt, shape)
    return [_build.ptr(t) for t in (o.offsets, con.n_colors, con.spill_color,
                                    o.slot, o.keys_a, o.perm_a, o.keys_b,
                                    o.perm_b)]


def _check_velw(kernel: str, velw, n: int):
    _build.check_cuda(kernel, "velw", velw, torch.float32, (n, VEL_ROW))
    if velw.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: velw needs a 16-byte aligned "
                         "base (it reads and writes each body's row as "
                         "16-byte words)")


def _solve_launch(velw, con, acc, cfg: SimConfig, tape=None):
    """One launch of the solve kernel, velw and the work rows `acc` updated
    in place; with a `tape` [iters, TAPE_ROWS, M] it records each visit's
    starting state. Returns (velw, accumulators f32[4, M, 4] in manifold
    order)."""
    m = con.rows.shape[1]
    _check_velw("solve", velw, velw.shape[0])
    _build.check_cuda("solve", "rows", con.rows, torch.float32, (ROWS, m))
    _build.check_cuda("solve", "work", acc, torch.float32, (WORK_ROWS, m))
    order_ptrs = _order_args("solve", con, cfg)
    out = torch.empty((4, m, CONTACT_POINTS), dtype=torch.float32,
                      device=velw.device)
    _build.library().call(
        "nudge_solve", _build.ptr(con.rows), _build.ptr(acc), _build.ptr(velw),
        _build.ptr(out), *order_ptrs, m, cfg.max_colors, cfg.solver_iters,
        int(cfg.split_impulse), int(cfg.split_impulse and cfg.pseudo_friction),
        None if tape is None else _build.ptr(tape), _build.stream_of(velw))
    solve.launches += 1
    return velw, out


def solve_cuda(velw, con, acc, cfg: SimConfig):
    """Run the solve kernel over setup's `PackedConstraints` and work rows
    `acc`, both updated in place. Returns (velw, (λn, λt1, λt2),
    pseudo_acc), the accumulators in manifold order. When an input carries
    a gradient (the differentiable mode) the kernel runs inside `SolveFn`:
    on copies of velw and the work rows, with a tape."""
    if torch.is_grad_enabled() and (velw.requires_grad or acc.requires_grad
                                    or con.rows.requires_grad):
        velw, out = SolveFn.apply(velw, con.rows, acc, con, cfg)
    else:
        velw, out = _solve_launch(velw, con, acc, cfg)
    return velw, (out[0], out[1], out[2]), out[3]


# the tape's rows a visit (csrc/common.cuh kTapeRows): both bodies' velw
# rows and the slot's 16 accumulators
TAPE_ROWS = 2 * VEL_ROW + 4 * CONTACT_POINTS


def solve_bwd_cluster_size() -> int:
    """The thread-block cluster size the solve's backward launches with."""
    return _build.library().lib.nudge_solve_bwd_cluster()


def _solve_bwd_launch(rows, tape, order_ptrs, cfg: SimConfig, adj_velw,
                      adj_acc, adj_rows, adj_static, scratch):
    """One launch of the reverse-sweep kernel alone, on checked buffers
    (`solve_backward_cuda` makes them): adj_velw and adj_acc in and out,
    adj_rows and adj_static added into."""
    _build.library().call(
        "nudge_solve_bwd", _build.ptr(rows), _build.ptr(tape),
        _build.ptr(adj_velw), _build.ptr(adj_acc), _build.ptr(adj_rows),
        _build.ptr(adj_static), _build.ptr(scratch), *order_ptrs,
        rows.shape[1], cfg.solver_iters, int(cfg.split_impulse),
        int(cfg.split_impulse and cfg.pseudo_friction),
        _build.stream_of(rows))
    solve_backward_cuda.launches += 1


def solve_backward_cuda(rows, tape, con, cfg: SimConfig, d_velw, d_out):
    """The backward of `_solve_launch` with a tape: from the adjoints of
    the output velw and accumulators (d_out [4, M, 4], manifold order) the
    adjoints of the input velw, rows and work rows. The reverse-sweep
    kernel (csrc/solve_bwd.cu) leaves the adjoint of the static bodies'
    reads in one column a slot; a segment sum adds them per body in a fixed
    order."""
    n = d_velw.shape[0]
    m = rows.shape[1]
    f32 = torch.float32
    dev = rows.device
    _build.check_cuda("solve_bwd", "tape", tape, f32,
                      (cfg.solver_iters, TAPE_ROWS, m))
    _build.check_cuda("solve_bwd", "d_out", d_out, f32, (4, m, CONTACT_POINTS))
    o = con.order
    _build.check_cuda("solve_bwd", "rows", rows, f32, (ROWS, m))
    adj_velw = d_velw.clone()
    _check_velw("solve_bwd", adj_velw, n)
    order_ptrs = _order_args("solve_bwd", con, cfg)
    slot = o.slot.long()
    adj_acc = torch.zeros((4 * CONTACT_POINTS, m), dtype=f32, device=dev)
    adj_acc[:, slot] = d_out.permute(0, 2, 1).reshape(4 * CONTACT_POINTS, m)
    adj_rows = torch.zeros((ROWS, m), dtype=f32, device=dev)
    adj_static = torch.zeros((2 * VEL_ROW, m), dtype=f32, device=dev)
    scratch = torch.empty((4 * VEL_ROW, m), dtype=f32, device=dev)
    _solve_bwd_launch(rows, tape, order_ptrs, cfg, adj_velw, adj_acc,
                      adj_rows, adj_static, scratch)
    # the static sides' reads, summed per body onto adj_velw
    live = torch.arange(m, device=dev) < o.offsets[cfg.max_colors]
    ids = rows[ROW_OFFSET["body_a"]:ROW_OFFSET["body_b"] + 1].view(torch.int32)
    im = rows[ROW_OFFSET["im_a"]:ROW_OFFSET["im_b"] + 1]
    keys, perm = entries(ids.T, (live[None, :] & ~(im > 0.0)).T)
    vals = adj_static.reshape(2, VEL_ROW, m).permute(2, 0, 1).reshape(
        2 * m, VEL_ROW)
    adj_velw = segment_sum(keys, perm, vals.contiguous(), n, adj_velw)
    d_work = torch.cat([adj_acc * live, torch.zeros(
        (WORK_ROWS - 4 * CONTACT_POINTS, m), dtype=f32, device=dev)])
    return adj_velw, adj_rows, d_work


solve_backward_cuda.launches = 0


class SolveFn(torch.autograd.Function):
    """The solve kernel as one autograd node on the card: the forward runs
    `_solve_launch` on copies of velw and the work rows (the kernel writes
    them in place; autograd must not see an input change) with a tape
    sized by capacity, [solver_iters, TAPE_ROWS, M] floats; the backward is
    `solve_backward_cuda`. Inputs with a gradient: velw, the rows, the work
    rows; outputs: velw and the accumulators [4, M, 4]."""

    @staticmethod
    def forward(ctx, velw, rows, work, con, cfg):
        m = rows.shape[1]
        tape = torch.empty((cfg.solver_iters, TAPE_ROWS, m),
                           dtype=torch.float32, device=rows.device)
        velw, out = _solve_launch(velw.clone(), con, work.clone(), cfg, tape)
        saved, ctx.rebuild = flatten((tape, con))
        ctx.save_for_backward(*saved)
        ctx.cfg, ctx.n = cfg, velw.shape[0]
        return velw, out

    @staticmethod
    def backward(ctx, d_velw, d_out):
        tape, con = ctx.rebuild(ctx.saved_tensors)
        rows = con.rows
        n, m = ctx.n, rows.shape[1]
        dev = rows.device
        d_velw = (torch.zeros((n, VEL_ROW), dtype=torch.float32, device=dev)
                  if d_velw is None else d_velw.contiguous())
        d_out = (torch.zeros((4, m, CONTACT_POINTS), dtype=torch.float32,
                             device=dev)
                 if d_out is None else d_out.contiguous())
        d_velw_in, d_rows, d_work = solve_backward_cuda(
            rows, tape, con, ctx.cfg, d_velw, d_out)
        return d_velw_in, d_rows, d_work, None, None


def solve_backward_plain(velw, con: solver.ContactConstraints, acc,
                         cfg: SimConfig, d_velw, d_out):
    """The plain version of the solve's backward: autograd through
    `solve_plain` on the same inputs, from the adjoints of velw and of the
    accumulators (d_out [4, M, 4]). Returns (d velw, {field: adjoint} of
    the constraints' float fields, (d λn, d λt1, d λt2))."""
    fields = [f for f, _ in ROW_FIELDS
              if f not in ("body_a", "body_b", "point_valid")]
    leaves = {f: getattr(con, f).detach().requires_grad_() for f in fields}
    v = velw.detach().requires_grad_()
    a = [x.detach().requires_grad_() for x in acc]
    with torch.enable_grad():
        vout, aout, pout = solve_plain(v, con.replace(**leaves), tuple(a), cfg)
        outs = [vout, *aout, pout]
        gs = [d_velw, d_out[0], d_out[1], d_out[2], d_out[3]]
        got = torch.autograd.grad(outs, [v, *leaves.values(), *a], gs,
                                  allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for g, x in zip(got, [v, *leaves.values(), *a])]
    return got[0], dict(zip(fields, got[1:1 + len(fields)])), tuple(got[-3:])


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
