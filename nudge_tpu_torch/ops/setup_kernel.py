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
not. On the card the kernels run inside `SetupFn` (a graph only when an
input requires grad: the differentiable mode), whose backward is
csrc/setup.cu's `setup_bwd_kernel`, a reverse pass of the setup math on one
quad of lanes a live slot, and its per-body sums (`setup_backward_cuda`;
plain version `setup_backward_plain`, autograd of the twin).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build, control

from ..config import CONTACT_POINTS, SimConfig
from ..state import Bodies, flatten
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
    # the bodies' inverse masses or inertias carry a gradient: the solve's
    # backward then runs its mass instance (solver_kernel.SolveFn)
    mass_grad: bool = False

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


def _setup_args(bodies: Bodies, man: Manifolds, warm, pwarm, relax,
                order: SlotOrder, cfg: SimConfig):
    """The setup kernels' inputs, checked, in their C order, and the
    constants."""
    n = bodies.pos.shape[0]
    m = man.valid.shape[0]
    K = cfg.max_colors
    P = CONTACT_POINTS
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
    consts = [cfg.baumgarte / cfg.dt, cfg.slop, cfg.max_bias_vel,
              cfg.deep_bias_depth, cfg.deep_bias_gate,
              cfg.deep_bias_ungated_depth, cfg.deep_bias_ungated_vel,
              cfg.max_pseudo_vel, cfg.restitution]
    return {name: t for name, t, _, _ in ins}, consts


def uses_pwarm(pwarm, cfg: SimConfig) -> bool:
    """Whether setup warm-starts the pseudo impulses from `pwarm`."""
    return pwarm is not None and cfg.split_impulse and cfg.warm_start


def _setup_launch(bodies: Bodies, man: Manifolds, warm, pwarm, relax,
                  order: SlotOrder, cfg: SimConfig, use_pwarm: bool):
    """One call of the setup kernels: (rows, work, frame, velw)."""
    ins, consts = _setup_args(bodies, man, warm, pwarm, relax, order, cfg)
    n = bodies.pos.shape[0]
    m = man.valid.shape[0]
    dev = bodies.pos.device
    f32 = torch.float32
    rows = torch.empty((ROWS, m), dtype=f32, device=dev)
    work = torch.empty((WORK_ROWS, m), dtype=f32, device=dev)
    frame = torch.zeros((2, m, 3), dtype=f32, device=dev)
    velw = torch.empty((n, VEL_ROW), dtype=f32, device=dev)
    _build.library().call(
        "nudge_setup", *[_build.ptr(t) for t in ins.values()], cfg.max_colors,
        m, n, *consts, int(cfg.split_impulse), int(cfg.warm_start),
        int(use_pwarm), _build.ptr(rows), _build.ptr(work), _build.ptr(frame),
        _build.ptr(velw), _build.stream_of(bodies.pos))
    setup.launches += 1
    return rows, work, frame, velw


# setup's inputs that carry a gradient, in SetupFn's order; the last three
# (MASS_INPUTS) take the backward kernel's mass instance
GRAD_INPUTS = ("pos", "quat", "vel", "angvel", "normal", "pos_m", "depth",
               "warm", "pwarm", "inv_mass", "inv_inertia", "friction")
MASS_INPUTS = GRAD_INPUTS[-3:]
# the per-body adjoint rows of the backward kernel: pos, quat, vel, angvel;
# the mass instance's also inv_mass and inv_inertia (csrc/setup.cu)
BODY_INPUTS, BODY_INPUTS_MASS = 13, 17


def _grad_inputs(bodies: Bodies, man: Manifolds, warm, pwarm):
    return (bodies.pos, bodies.quat, bodies.vel, bodies.angvel, man.normal,
            man.pos, man.depth, warm, pwarm, bodies.inv_mass,
            bodies.inv_inertia, man.friction)


def _setup_bwd_launch(ins, consts, cfg: SimConfig, use_pwarm: bool, d_rows,
                      d_work, d_frame, d_velw, mass: bool = False):
    """The backward kernel alone: (adj_body f32[2M, 13], the live
    manifolds' body rows, row 2i + side; static_keys i32[2M], the body of a
    live manifold's static side, else INT32_MAX; the adjoints of normal,
    pos, depth, warm and pwarm, every manifold written). With `mass` the
    kernel's mass instance: adj_body rows of 17 (inv_mass and inv_inertia
    after angvel) and, last, the manifolds' friction adjoints f32[M]."""
    m = ins["normal"].shape[0]
    dev = ins["normal"].device
    f32 = torch.float32
    for name, t, shape in (("d_rows", d_rows, (ROWS, m)),
                           ("d_work", d_work, (WORK_ROWS, m)),
                           ("d_frame", d_frame, (2, m, 3)),
                           ("d_velw", d_velw, (ins["pos"].shape[0], VEL_ROW))):
        _build.check_cuda("setup_bwd", name, t, f32, shape)
    P = CONTACT_POINTS
    width = BODY_INPUTS_MASS if mass else BODY_INPUTS
    adj_body = torch.empty((2 * m, width), dtype=f32, device=dev)
    static_keys = torch.empty(2 * m, dtype=torch.int32, device=dev)
    adj = [torch.empty(shape, dtype=f32, device=dev) for shape in
           ((m, 3), (m, P, 3), (m, P), (m, P, 3), (m, P))]
    adj_fric = torch.empty(m, dtype=f32, device=dev) if mass else None
    names = ("pos", "quat", "vel", "angvel", "inv_mass", "inv_inertia",
             "body_a", "body_b", "normal", "friction", "pos_m", "depth",
             "point_valid", "warm", "pwarm", "order", "offsets")
    _build.library().call(
        "nudge_setup_bwd", *[_build.ptr(ins[k]) for k in names],
        cfg.max_colors, m, *consts, int(cfg.split_impulse),
        int(cfg.warm_start), int(use_pwarm), _build.ptr(d_rows),
        _build.ptr(d_work), _build.ptr(d_frame), _build.ptr(d_velw),
        _build.ptr(adj_body), *[_build.ptr(t) for t in adj],
        _build.ptr(static_keys), 0 if adj_fric is None else
        _build.ptr(adj_fric), _build.stream_of(d_rows))
    setup_backward_cuda.launches += 1
    if mass:
        adj.append(adj_fric)
    return adj_body, static_keys, adj


def setup_backward_cuda(bodies: Bodies, man: Manifolds, warm, pwarm, relax,
                        order: SlotOrder, cfg: SimConfig, use_pwarm: bool,
                        d_rows, d_work, d_frame, d_velw, mass: bool = False):
    """The backward of `_setup_launch`: the adjoints of GRAD_INPUTS from
    those of (rows, work, frame, velw), without MASS_INPUTS' unless `mass`.
    The backward kernel (one quad a live slot) writes the manifolds' input
    adjoints and each live manifold's body rows; the per-body sums
    (csrc/setup.cu setup_body_sum_kernel, one warp a body, fixed order)
    walk a dynamic body's rows through the forward's body-sorted lists
    (`order`: live dynamic entries) and a static body's through one stable
    sort of the static-body keys the kernel wrote, the only entries those
    lists do not hold; velw's own adjoint goes to vel and angvel (velw = v
    | w + the warm-start changes). The work rows' scratch part (the
    warm-start changes, which the solve overwrites before it reads them)
    takes no adjoint."""
    ins, consts = _setup_args(bodies, man, warm, pwarm, relax, order, cfg)
    adj_body, static_keys, adj = _setup_bwd_launch(
        ins, consts, cfg, use_pwarm, d_rows, d_work, d_frame, d_velw, mass)
    static_keys, static_perm = torch.sort(static_keys, stable=True)
    n = bodies.pos.shape[0]
    m = man.valid.shape[0]
    widths = (3, 4, 3, 3) + ((1, 3) if mass else ())
    body = [torch.empty((n, w), dtype=torch.float32, device=d_rows.device)
            for w in widths]
    mass_ptrs = [_build.ptr(t) for t in body[4:]] if mass else [0, 0]
    _build.library().call(
        "nudge_setup_body_sum", _build.ptr(bodies.inv_mass),
        *[_build.ptr(ins[k]) for k in ("keys_a", "perm_a", "keys_b",
                                        "perm_b")],
        _build.ptr(static_keys), _build.ptr(static_perm),
        _build.ptr(adj_body), _build.ptr(d_velw), m, n,
        *[_build.ptr(t) for t in body[:4]], *mass_ptrs,
        _build.stream_of(d_rows))
    out = (*body[:4], *adj[:5])
    if mass:
        out += (body[4].reshape(n), body[5], adj[5])
    return out


control.counter(setup_backward_cuda)


class SetupFn(torch.autograd.Function):
    """The setup kernels as one autograd node on the card: the forward is
    `_setup_launch` and saves the tensors its backward reads (an in-place
    write to one before the backward raises), the backward
    `setup_backward_cuda`, its mass instance only when one of MASS_INPUTS
    needs a gradient. Inputs with a gradient: GRAD_INPUTS; outputs: (rows,
    work, frame, velw)."""

    @staticmethod
    def forward(ctx, pos, quat, vel, angvel, normal, mpos, depth, warm, pwarm,
                inv_mass, inv_inertia, friction, bodies, man, relax, order,
                cfg, use_pwarm):
        saved, ctx.rebuild = flatten((bodies, man, warm, pwarm, relax, order))
        ctx.save_for_backward(*saved)
        ctx.cfg, ctx.use_pwarm = cfg, use_pwarm
        return _setup_launch(bodies, man, warm, pwarm, relax, order, cfg,
                             use_pwarm)

    @staticmethod
    def backward(ctx, d_rows, d_work, d_frame, d_velw):
        bodies, man, warm, pwarm, relax, order = ctx.rebuild(
            ctx.saved_tensors)
        n, m = bodies.pos.shape[0], man.valid.shape[0]

        def dense(g, shape):
            return (torch.zeros(shape, dtype=torch.float32,
                                device=bodies.pos.device)
                    if g is None else g.contiguous())

        k = len(GRAD_INPUTS)
        mass = any(ctx.needs_input_grad[k - len(MASS_INPUTS):k])
        grads = setup_backward_cuda(
            bodies, man, warm, pwarm, relax, order, ctx.cfg, ctx.use_pwarm,
            dense(d_rows, (ROWS, m)), dense(d_work, (WORK_ROWS, m)),
            dense(d_frame, (2, m, 3)), dense(d_velw, (n, VEL_ROW)), mass)
        grads += (None,) * (k - len(grads))
        return (*grads, None, None, None, None, None, None)


def setup_backward_plain(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
                         coloring, pwarm, order: SlotOrder, d_rows, d_work,
                         d_frame, d_velw):
    """The plain version of `setup_backward_cuda`: autograd through
    `setup_plain` and `pack_constraints` (the kernel's layout) on the same
    inputs, with the same output adjoints (the work rows' scratch part
    takes none, as in the kernel). Returns the adjoints of GRAD_INPUTS."""
    if pwarm is None:
        pwarm = torch.zeros_like(man.depth)
    leaves = [t.detach().requires_grad_()
              for t in _grad_inputs(bodies, man, warm, pwarm)]
    with torch.enable_grad():
        b2 = bodies.replace(pos=leaves[0], quat=leaves[1], vel=leaves[2],
                            angvel=leaves[3], inv_mass=leaves[9],
                            inv_inertia=leaves[10])
        m2 = man.replace(normal=leaves[4], pos=leaves[5], depth=leaves[6],
                         friction=leaves[11])
        con, velw, acc = setup_plain(b2, m2, leaves[7], cfg, coloring,
                                     leaves[8])
        packed, work = pack_constraints(con, acc, order)
        # without a warm start the accumulators are constants
        outs = [(y, g) for y, g in (
            (packed.rows, d_rows),
            (work[:4 * CONTACT_POINTS], d_work[:4 * CONTACT_POINTS]),
            (packed.frame, d_frame), (velw, d_velw)) if y.requires_grad]
        got = torch.autograd.grad([y for y, _ in outs], leaves,
                                  [g for _, g in outs], allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(got, leaves))


def setup_cuda(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
               coloring=None, pwarm=None, order: SlotOrder = None):
    """The setup kernel and the warm start, as one `SetupFn` node (without
    an input that carries a gradient it builds no graph). Returns
    (PackedConstraints, velw, work rows)."""
    if coloring is None:
        coloring = solver.color_manifolds(man, bodies, cfg)
    if order is None:
        order = color_order(man, bodies, coloring, cfg)
    color, n_colors, relax, spill, spill_color = coloring
    use_pwarm = uses_pwarm(pwarm, cfg)
    if pwarm is None:
        pwarm = torch.zeros(man.depth.shape, dtype=torch.float32,
                            device=bodies.pos.device)
    rows, work, frame, velw = SetupFn.apply(
        *_grad_inputs(bodies, man, warm, pwarm), bodies, man, relax, order,
        cfg, use_pwarm)
    mass_grad = torch.is_grad_enabled() and (bodies.inv_mass.requires_grad or
                                             bodies.inv_inertia.requires_grad)
    con = PackedConstraints(
        rows=rows, frame=frame, n=man.normal, order=order, color=color,
        n_colors=n_colors, valid=man.valid, spill_count=spill,
        spill_color=spill_color, mass_grad=mass_grad)
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


control.counter(setup)
