"""Contact-constraint setup: the CUDA kernel's wrapper.

Replaces `nudge_tpu/ops/setup_kernel.py: setup_pallas` (kernel body
`_make_setup_kernel`, first half of `setup_solve_fused`). The TPU kernel
packed a geometry payload into color-sorted [8,128] groups and gathered body
rows with windowed one-hot matmuls; the CUDA kernel (csrc/setup.cu) runs one
thread per manifold, gathers body state by int32 index, and writes the
constraint rows in the manifold-major layout of the plain twin's
`ContactConstraints`. The warm-start velocity change is written per
manifold and side and added into the bodies by a deterministic per-body
segment sum over a stable sort of the body ids (no float atomics).

`setup` returns (constraints, velw, acc) where velw[N,12] holds each body's
v | w | pseudo v | pseudo w with the warm starts applied. It dispatches by
device: CPU tensors go to the plain twin `setup_plain`
(`solver.setup_constraints` + `solver.pseudo_warm_start`); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import CONTACT_POINTS, SimConfig
from ..state import Bodies
from . import solver
from .contacts import Manifolds

VEL_ROW = 12
_I32_MAX = 2 ** 31 - 1


def pack_velw(vel, angvel, pvel, pang):
    return torch.cat([vel, angvel, pvel, pang], 1).contiguous()


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


def body_segments(body, take):
    """(keys, perm) for a deterministic per-body segment sum: `keys` are the
    body ids of the entries with `take` (INT32_MAX elsewhere) in stable
    sorted order, `perm` the manifold of each entry."""
    keys = torch.where(take, body, _I32_MAX).to(torch.int32)
    keys, perm = torch.sort(keys, stable=True)
    return keys.contiguous(), perm.contiguous()


def segment_apply(lib, state, keys, perm, vals, stride, mode):
    lib.call("nudge_segment_apply", _build.ptr(state), _build.ptr(keys),
             _build.ptr(perm), _build.ptr(vals), keys.shape[0], stride, mode,
             _build.stream_of(state))


def setup_cuda(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
               coloring=None, pwarm=None):
    """The setup kernel plus the two warm-start segment sums."""
    if coloring is None:
        coloring = solver.color_manifolds(man, bodies, cfg)
    color, n_colors, relax, spill, spill_color = coloring
    n = bodies.pos.shape[0]
    m = man.valid.shape[0]
    P = CONTACT_POINTS
    dev = bodies.pos.device
    use_pwarm = pwarm is not None and cfg.split_impulse and cfg.warm_start
    if pwarm is None:
        pwarm = torch.zeros((m, P), dtype=torch.float32, device=dev)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
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
    ]
    for name, t, dt, shape in ins:
        _build.check_cuda("setup", name, t, dt, shape)

    def e(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    o = dict(t1=e(m, 3), t2=e(m, 3), ra=e(m, P, 3), rb=e(m, P, 3),
             jna=e(m, P, 3), jnb=e(m, P, 3), jt1a=e(m, P, 3), jt1b=e(m, P, 3),
             jt2a=e(m, P, 3), jt2b=e(m, P, 3), mn=e(m, P), mt1=e(m, P),
             mt2=e(m, P), bias=e(m, P), pos_bias=e(m, P), pwarm=e(m, P),
             im_a=e(m), im_b=e(m), acc_n=e(m, P), acc_t1=e(m, P),
             acc_t2=e(m, P), delta_a=e(m, VEL_ROW), delta_b=e(m, VEL_ROW))
    lib = _build.library()
    consts = [cfg.baumgarte / cfg.dt, cfg.slop, cfg.max_bias_vel,
              cfg.deep_bias_depth, cfg.deep_bias_gate,
              cfg.deep_bias_ungated_depth, cfg.deep_bias_ungated_vel,
              cfg.max_pseudo_vel, cfg.restitution]
    lib.call("nudge_setup", *[_build.ptr(t) for _, t, _, _ in ins], m,
             *consts, int(cfg.split_impulse), int(cfg.warm_start),
             int(use_pwarm), *[_build.ptr(t) for t in o.values()],
             _build.stream_of(bodies.pos))
    setup.launches += 1

    velw = pack_velw(bodies.vel, bodies.angvel, torch.zeros_like(bodies.vel),
                     torch.zeros_like(bodies.vel))
    dyn = bodies.inv_mass > 0.0
    take_a = man.valid & dyn[man.body_a]
    take_b = man.valid & dyn[man.body_b]
    for body, take, delta in ((man.body_a, take_a, o["delta_a"]),
                              (man.body_b, take_b, o["delta_b"])):
        keys, perm = body_segments(body, take)
        segment_apply(lib, velw, keys, perm, delta, VEL_ROW, 0)

    con = solver.ContactConstraints(
        body_a=man.body_a, body_b=man.body_b, n=man.normal, t1=o["t1"],
        t2=o["t2"], ra=o["ra"], rb=o["rb"], jna=o["jna"], jnb=o["jnb"],
        jt1a=o["jt1a"], jt1b=o["jt1b"], jt2a=o["jt2a"], jt2b=o["jt2b"],
        mn=o["mn"], mt1=o["mt1"], mt2=o["mt2"], bias=o["bias"],
        pos_bias=o["pos_bias"], pwarm=o["pwarm"], mu=man.friction,
        im_a=o["im_a"], im_b=o["im_b"], relax=relax, color=color,
        n_colors=n_colors, point_valid=man.point_valid, valid=man.valid,
        spill_count=spill, spill_color=spill_color,
    )
    return con, velw, (o["acc_n"], o["acc_t1"], o["acc_t2"])


def setup(bodies: Bodies, man: Manifolds, warm, cfg: SimConfig,
          coloring=None, pwarm=None):
    """Constraint setup with warm starts. Returns (ContactConstraints,
    velw f32[N,12], (λn, λt1, λt2) each [M,P])."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return setup_plain(bodies, man, warm, cfg, coloring, pwarm)
    if dev.type == "cuda":
        return setup_cuda(bodies, man, warm, cfg, coloring, pwarm)
    raise NotImplementedError(f"setup: no kernel for device {dev}")


setup.launches = 0
