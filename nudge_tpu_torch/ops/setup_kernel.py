"""Contact-constraint setup: the CUDA kernel's wrapper, and the solve's
packed layout.

Replaces `nudge_tpu/ops/setup_kernel.py: setup_pallas` (kernel body
`_make_setup_kernel`, first half of `setup_solve_fused`). As the TPU
kernel did for its solve, the CUDA kernel (csrc/setup.cu) writes the
constraint rows straight into the solve's color-sorted layout: one thread
per live slot of `solver_kernel.color_order`'s order, every field the
solve reads at `rows[f, slot]` (field-major, `solver_kernel.ROW_FIELDS`),
the warm-started accumulators and the warm-start velocity changes at
`work[f, slot]`. A second kernel adds those changes into each body in a
fixed order (no float atomics) and writes velw.

`setup` returns (constraints, velw, acc) where velw[N,12] holds each body's
v | w | pseudo v | pseudo w with the warm starts applied. It dispatches by
device: CPU tensors go to the plain twin `setup_plain`
(`solver.setup_constraints` + `solver.pseudo_warm_start`), which returns a
manifold-major `ContactConstraints` and (λn, λt1, λt2); CUDA tensors launch
the kernels, or raise, and return a `PackedConstraints` and the work rows.
`pack_constraints`, `unpack_constraints` and `unpack_acc` convert between
the two in plain PyTorch; the comparisons use them, the main path does
not.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..config import CONTACT_POINTS, SimConfig
from ..state import Bodies
from . import solver
from .contacts import Manifolds
from .solver_kernel import (
    ROW_FIELDS, ROWS, VEL_ROW, WORK_ROWS, SlotOrder, color_order, pack_velw,
)


@dataclasses.dataclass
class PackedConstraints:
    """Setup's output on the card: the solve's rows in slot order, plus
    what the step reads in manifold order."""

    rows: torch.Tensor         # f32[ROWS, M] field-major, slot order
    frame: torch.Tensor        # f32[2, M, 3] t1, t2 in manifold order
    n: torch.Tensor            # f32[M, 3] the manifolds' normals
    order: SlotOrder
    color: torch.Tensor        # i32[M]
    n_colors: torch.Tensor     # i32
    valid: torch.Tensor        # bool[M]
    spill_count: torch.Tensor  # i32
    spill_color: torch.Tensor  # i32

    @property
    def t1(self):
        return self.frame[0]

    @property
    def t2(self):
        return self.frame[1]


def pack_constraints(con: solver.ContactConstraints, acc, order: SlotOrder):
    """The plain twin's constraints and accumulators in the kernels' layout:
    (PackedConstraints, work rows), every manifold at its slot."""
    m = con.valid.shape[0]
    cols = []
    for name, width in ROW_FIELDS:
        x = getattr(con, name)
        if name in ("body_a", "body_b"):
            x = x.to(torch.int32).view(torch.float32)
        elif name == "point_valid":
            x = x.to(torch.float32)
        cols.append(x.reshape(m, width))
    idx = order.order
    rows = torch.cat(cols, 1)[idx].T.contiguous()
    acc_n, acc_t1, acc_t2 = acc
    pacc = torch.where(con.point_valid, con.pwarm, 0.0)
    work = torch.zeros((WORK_ROWS, m), dtype=torch.float32,
                       device=rows.device)
    work[:4 * CONTACT_POINTS] = torch.cat(
        [acc_n, acc_t1, acc_t2, pacc], 1)[idx].T
    packed = PackedConstraints(
        rows=rows, frame=torch.stack([con.t1, con.t2]).contiguous(), n=con.n,
        order=order, color=con.color, n_colors=con.n_colors, valid=con.valid,
        spill_count=con.spill_count, spill_color=con.spill_color)
    return packed, work


def unpack_constraints(packed: PackedConstraints) -> solver.ContactConstraints:
    """The packed rows back in manifold order, as the plain twin's
    ContactConstraints. Columns the kernel did not write (manifolds that
    are not live) come back as whatever the buffer held."""
    x = packed.rows[:, packed.order.slot.long()].T.contiguous()
    m = x.shape[0]
    P = CONTACT_POINTS
    kw, off = {}, 0
    for name, width in ROW_FIELDS:
        v = x[:, off:off + width].contiguous()
        off += width
        if name in ("body_a", "body_b"):
            v = v.view(torch.int32).reshape(m)
        elif name == "point_valid":
            v = v != 0.0
        elif width == 1:
            v = v.reshape(m)
        elif width == 3 * P:
            v = v.reshape(m, P, 3)
        kw[name] = v
    return solver.ContactConstraints(
        **kw, color=packed.color, n_colors=packed.n_colors,
        valid=packed.valid, spill_count=packed.spill_count,
        spill_color=packed.spill_color)


def unpack_acc(work, order: SlotOrder):
    """(λn, λt1, λt2) [M,P] each, in manifold order, from the work rows."""
    P = CONTACT_POINTS
    x = work[:3 * P, order.slot.long()]
    return tuple(x[k * P:(k + 1) * P].T.contiguous() for k in range(3))


def setup_plain(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
                coloring=None, pwarm=None):
    """Plain PyTorch twin of the setup kernel."""
    con, b2, acc = solver.setup_constraints(bodies, man, warm, cfg,
                                            coloring=coloring, pwarm=pwarm)
    if cfg.split_impulse:
        pv0, pw0 = solver.pseudo_warm_start(con, bodies.pos.shape[0])
    else:
        pv0 = pw0 = torch.zeros_like(bodies.vel)
    return con, pack_velw(b2.vel, b2.angvel, pv0, pw0), acc


def setup_cuda(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
               coloring=None, pwarm=None, order: SlotOrder = None):
    """The setup kernel and the warm start. Returns (PackedConstraints,
    velw, work rows)."""
    if coloring is None:
        coloring = solver.color_manifolds(man, bodies, cfg)
    if order is None:
        order = color_order(man, bodies, coloring, cfg)
    color, n_colors, relax, spill, spill_color = coloring
    n = bodies.pos.shape[0]
    m = man.valid.shape[0]
    K = cfg.max_colors
    P = CONTACT_POINTS
    dev = bodies.pos.device
    use_pwarm = pwarm is not None and cfg.split_impulse and cfg.warm_start
    if pwarm is None:
        pwarm = torch.zeros((m, P), dtype=torch.float32, device=dev)
    f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool
    ins = [
        ("pos", bodies.pos, f32, (n, 3)), ("quat", bodies.quat, f32, (n, 4)),
        ("vel", bodies.vel, f32, (n, 3)), ("angvel", bodies.angvel, f32, (n, 3)),
        ("inv_mass", bodies.inv_mass, f32, (n,)),
        ("inv_inertia", bodies.inv_inertia, f32, (n, 3)),
        ("body_a", man.body_a, i32, (m,)), ("body_b", man.body_b, i32, (m,)),
        ("normal", man.normal, f32, (m, 3)), ("friction", man.friction, f32, (m,)),
        ("pos_m", man.pos, f32, (m, P, 3)), ("depth", man.depth, f32, (m, P)),
        ("point_valid", man.point_valid, b8, (m, P)),
        ("warm", warm, f32, (m, P, 3)), ("pwarm", pwarm, f32, (m, P)),
        ("relax", relax, f32, (m,)),
        ("order", order.order, i64, (m,)),
        ("offsets", order.offsets, i32, (K + 1,)),
        ("slot", order.slot, i32, (m,)),
        ("keys_a", order.keys_a, i32, (m,)), ("perm_a", order.perm_a, i64, (m,)),
        ("keys_b", order.keys_b, i32, (m,)), ("perm_b", order.perm_b, i64, (m,)),
    ]
    for name, t, dt, shape in ins:
        _build.check_cuda("setup", name, t, dt, shape)

    rows = torch.empty((ROWS, m), dtype=f32, device=dev)
    work = torch.empty((WORK_ROWS, m), dtype=f32, device=dev)
    frame = torch.zeros((2, m, 3), dtype=f32, device=dev)
    velw = torch.empty((n, VEL_ROW), dtype=f32, device=dev)
    consts = [cfg.baumgarte / cfg.dt, cfg.slop, cfg.max_bias_vel,
              cfg.deep_bias_depth, cfg.deep_bias_gate,
              cfg.deep_bias_ungated_depth, cfg.deep_bias_ungated_vel,
              cfg.max_pseudo_vel, cfg.restitution]
    _build.library().call(
        "nudge_setup", *[_build.ptr(t) for _, t, _, _ in ins], K, m, n,
        *consts, int(cfg.split_impulse), int(cfg.warm_start), int(use_pwarm),
        _build.ptr(rows), _build.ptr(work), _build.ptr(frame),
        _build.ptr(velw), _build.stream_of(bodies.pos))
    setup.launches += 1

    con = PackedConstraints(
        rows=rows, frame=frame, n=man.normal, order=order, color=color,
        n_colors=n_colors, valid=man.valid, spill_count=spill,
        spill_color=spill_color)
    return con, velw, work


def setup(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
          coloring=None, pwarm=None, order: SlotOrder = None):
    """Constraint setup with warm starts. Returns (constraints, velw
    f32[N,12], accumulators): on the CPU the twin's ContactConstraints and
    (λn, λt1, λt2) each [M,P]; on the card PackedConstraints and the work
    rows, in the solve's slot order (`order`, computed here when None)."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return setup_plain(bodies, man, warm, cfg, coloring, pwarm)
    if dev.type == "cuda":
        return setup_cuda(bodies, man, warm, cfg, coloring, pwarm, order)
    raise NotImplementedError(f"setup: no kernel for device {dev}")


setup.launches = 0
