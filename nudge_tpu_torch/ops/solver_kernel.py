"""The iterated contact solve: the CUDA kernel's wrapper.

Replaces `nudge_tpu/ops/solver_kernel.py: solve_packed` (kernel body
`_solve_kernel`, also reached through `solve_pallas`). The TPU kernel ran
the whole solve as one sequential Pallas grid over color-sorted 1,024-wide
groups. Here manifolds are stably sorted once per step by (color, smallest
dynamic body id), as the TPU kernel's `spatial_subkey` orders them; the
color segments' offsets, the color count and the spill color are read to
the host once per step (the one host sync of the solve), and one C entry
(csrc/solve.cu) enqueues solver_iters x n_colors color passes. The spill
color runs as Jacobi through deterministic per-body segment sums.

`solve` takes and returns velw[N,12] (v | w | pseudo v | pseudo w). It
dispatches by device: CPU tensors go to the plain twin `solve_plain`
(`solver.solve_from`); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..config import CONTACT_POINTS, SimConfig
from . import solver
from .setup_kernel import VEL_ROW, body_segments, pack_velw

_SUBKEY_BIG = (1 << 24) - 1


def solve_plain(velw, con: solver.ContactConstraints, acc, cfg: SimConfig):
    """Plain PyTorch twin of the solve kernel."""
    vel, angvel, acc, (pv, pw), pacc = solver.solve_from(
        velw[:, 0:3], velw[:, 3:6], con, acc,
        (velw[:, 6:9], velw[:, 9:12]), cfg)
    return pack_velw(vel, angvel, pv, pw), acc, pacc


def color_order(con: solver.ContactConstraints, cfg: SimConfig):
    """Stable sort of the manifolds by (color, smallest dynamic body id) and
    the start offset of each color 0..max_colors in that order."""
    K = cfg.max_colors
    dyn_a = con.im_a > 0.0
    dyn_b = con.im_b > 0.0
    sub = torch.minimum(
        torch.where(dyn_a, con.body_a, _SUBKEY_BIG),
        torch.where(dyn_b, con.body_b, _SUBKEY_BIG)).to(torch.int64)
    col = torch.clamp_max(con.color, K).to(torch.int64)
    order = torch.sort(col * (1 << 24) + sub, stable=True).indices
    offsets = torch.searchsorted(
        col[order], torch.arange(K + 1, device=col.device)).to(torch.int32)
    return order.contiguous(), offsets


def solve_cuda(velw, con: solver.ContactConstraints, acc, cfg: SimConfig):
    """Run the solve kernel. Returns (velw, acc, pseudo_acc)."""
    n = velw.shape[0]
    m = con.valid.shape[0]
    P = CONTACT_POINTS
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    rows = [
        ("n", con.n, f32, (m, 3)), ("t1", con.t1, f32, (m, 3)),
        ("t2", con.t2, f32, (m, 3)),
        *[(k, getattr(con, k), f32, (m, P, 3))
          for k in ("ra", "rb", "jna", "jnb", "jt1a", "jt1b", "jt2a", "jt2b")],
        *[(k, getattr(con, k), f32, (m, P))
          for k in ("mn", "mt1", "mt2", "bias", "pos_bias")],
        *[(k, getattr(con, k), f32, (m,))
          for k in ("mu", "im_a", "im_b", "relax")],
        ("point_valid", con.point_valid, b8, (m, P)),
        ("body_a", con.body_a, i32, (m,)), ("body_b", con.body_b, i32, (m,)),
    ]
    for name, t, dt, shape in rows + [("velw", velw, f32, (n, VEL_ROW))]:
        if not t.is_cuda or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"solve kernel: {name} must be a contiguous CUDA "
                             f"{dt} tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if cfg.differentiable:
        raise NotImplementedError(
            "differentiable mode has no kernel path yet (ROADMAP Queue 1 "
            "item 13)")

    order, offsets = color_order(con, cfg)
    spilled = con.valid & (con.color == con.spill_color)
    keys_a, perm_a = body_segments(con.body_a, spilled & (con.im_a > 0.0))
    keys_b, perm_b = body_segments(con.body_b, spilled & (con.im_b > 0.0))
    # the solve's one host read: color offsets, color count, spill color
    # and spill count
    host = torch.cat([offsets, con.n_colors.view(1).to(i32),
                      con.spill_color.view(1).to(i32),
                      con.spill_count.view(1).to(i32)]).cpu().numpy()
    h_offsets = np.ascontiguousarray(host[:cfg.max_colors + 1], np.int32)
    n_colors = max(int(host[-3]), 1)
    spill_color, n_spill = int(host[-2]), int(host[-1])

    velw = velw.clone()
    acc_n, acc_t1, acc_t2 = (x.clone() for x in acc)
    pacc = con.pwarm.clone()
    post = torch.empty((max(m, 1), 2 * VEL_ROW), dtype=f32, device=velw.device)
    lib = _build.library()
    lib.call("nudge_solve", *[_build.ptr(t) for _, t, _, _ in rows],
             _build.ptr(velw), _build.ptr(acc_n), _build.ptr(acc_t1),
             _build.ptr(acc_t2), _build.ptr(pacc), _build.ptr(order),
             h_offsets.ctypes.data, n_colors, spill_color, cfg.solver_iters,
             int(cfg.split_impulse),
             int(cfg.split_impulse and cfg.pseudo_friction),
             _build.ptr(keys_a), _build.ptr(perm_a), _build.ptr(keys_b),
             _build.ptr(perm_b), _build.ptr(post), min(n_spill, m),
             _build.stream_of(velw))
    solve.launches += 1
    return velw, (acc_n, acc_t1, acc_t2), pacc


def solve(velw, con: solver.ContactConstraints, acc, cfg: SimConfig):
    """The iterated solve from warm-started velw. Returns (velw,
    (λn, λt1, λt2), pseudo_acc[M,P])."""
    dev = velw.device
    if dev.type == "cpu":
        return solve_plain(velw, con, acc, cfg)
    if dev.type == "cuda":
        return solve_cuda(velw, con, acc, cfg)
    raise NotImplementedError(f"solve: no kernel for device {dev}")


solve.launches = 0
