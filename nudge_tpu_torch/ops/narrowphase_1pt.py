"""Box-sphere and sphere-sphere narrowphase over candidate pairs: the CUDA
kernel's wrapper.

Replaces `nudge_tpu/ops/narrowphase_kernel.py: pairs_1pt_pallas` (kernel
body `_make_1pt_kernel`, math in `_box_sphere_rows` and
`_sphere_sphere_rows`). The TPU kernel gathered collider rows with one-hot
matmuls from a unified box+sphere table; the CUDA kernel
(csrc/narrowphase_1pt.cu) reads the box-sphere and the sphere-sphere
candidate lists in place as two ranges of one launch, one thread a pair
slot, reads both colliders of a live pair by int32 index and runs
`narrowphase.box_sphere` or `narrowphase.sphere_sphere` in registers.

Pairs carry global collider ids: a box keeps its index, sphere i is
`max_boxes + i` (the box arrays are capacity-sized, so these are the ids of
the contact cache). Each pair yields a one-point manifold: slot 0 holds the
contact, feature id 0; slots 1-3 are empty. A dead pair slot (its
candidate's `valid` false) gets `point_valid` false from the kernel and
nothing else, as box-box's (`narrowphase_kernel`); the twin fills every
field, and the two agree on live slots.

The engine reaches both through `contacts.narrowphase_all`: on the CPU it
joins the twin's slots after box-box's, on the card it hands the kernel the
rows after box-box's of one set of buffers (`out`). `pairs_1pt_adjoint_cuda`
launches the backward kernel of the differentiable mode
(`contacts.NarrowphaseFn`).
"""

from __future__ import annotations

import torch

from .. import _build, control

from ..state import Boxes, Spheres
from . import narrowphase as nps
from .broadphase import CandidatePairs, WorldColliders
from .narrowphase_kernel import (
    SLOTS, adjoint_ins, check_slots, combine_friction, empty_slots,
)

POINTS = nps.BOX_BOX_POINTS


def _stream(bs: CandidatePairs, ss: CandidatePairs, nb: int):
    """Global ids and liveness of the bs pairs followed by the ss pairs."""
    ga = torch.cat([bs.a, nb + ss.a]).to(torch.int32)
    gb = (nb + torch.cat([bs.b, ss.b])).to(torch.int32)
    return ga, gb, torch.cat([bs.valid, ss.valid])


def _slot0(x):
    """[P,...] -> [P,POINTS,...] with x in slot 0 and zeros elsewhere."""
    out = torch.zeros((x.shape[0], POINTS) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    out[:, 0] = x
    return out


def pairs_1pt_slots_plain(bx: Boxes, sp: Spheres, wc: WorldColliders,
                          bs: CandidatePairs, ss: CandidatePairs):
    """Per-pair one-point manifold slots with the plain PyTorch twins."""
    a, b = bs.a.to(torch.int64), bs.b.to(torch.int64)
    c, d = ss.a.to(torch.int64), ss.b.to(torch.int64)
    m_bs = nps.box_sphere(bx.half[a], wc.box_quat[a], wc.box_pos[a],
                          sp.radius[b], wc.sph_pos[b])
    m_ss = nps.sphere_sphere(sp.radius[c], wc.sph_pos[c], sp.radius[d],
                             wc.sph_pos[d])
    ga, gb, live = _stream(bs, ss, bx.half.shape[0])

    def cat(key):
        return torch.cat([m_bs[key], m_ss[key]])

    depth = cat("depth")
    return dict(
        body_a=torch.cat([bx.body[a], sp.body[c]]),
        body_b=torch.cat([sp.body[b], sp.body[d]]),
        ga=ga, gb=gb,
        normal=cat("normal"),
        friction=torch.cat([combine_friction(bx.friction[a], sp.friction[b]),
                            combine_friction(sp.friction[c], sp.friction[d])]),
        pos=_slot0(cat("pos")),
        depth=_slot0(depth),
        feat=torch.zeros((depth.shape[0], POINTS), dtype=torch.int32,
                         device=depth.device),
        point_valid=_slot0(cat("valid") & live),
    )


def pairs_1pt_slots_cuda(bx: Boxes, sp: Spheres, wc: WorldColliders,
                         bs: CandidatePairs, ss: CandidatePairs,
                         out: dict = None):
    """Per-pair one-point manifold slots from the CUDA kernel, the
    box-sphere rows then the sphere-sphere rows, into `out` where given
    (row views of `contacts.narrowphase_all`'s joined buffers), else into
    new buffers."""
    nb, ns = bx.half.shape[0], sp.radius.shape[0]
    n_bs, n_ss = bs.a.shape[0], ss.a.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ins = dict(half=(bx.half, f32, (nb, 3)),
               box_quat=(wc.box_quat, f32, (nb, 4)),
               box_pos=(wc.box_pos, f32, (nb, 3)),
               box_friction=(bx.friction, f32, (nb,)),
               box_body=(bx.body, i32, (nb,)),
               radius=(sp.radius, f32, (ns,)),
               sph_pos=(wc.sph_pos, f32, (ns, 3)),
               sph_friction=(sp.friction, f32, (ns,)),
               sph_body=(sp.body, i32, (ns,)),
               bs_a=(bs.a, i32, (n_bs,)), bs_b=(bs.b, i32, (n_bs,)),
               bs_valid=(bs.valid, b8, (n_bs,)),
               ss_a=(ss.a, i32, (n_ss,)), ss_b=(ss.b, i32, (n_ss,)),
               ss_valid=(ss.valid, b8, (n_ss,)))
    for name, (t, dt, shape) in ins.items():
        _build.check_cuda("pairs_1pt", name, t, dt, shape)
    rows = n_bs + n_ss
    if out is None:
        out = empty_slots(rows, bx.half.device)
    else:
        check_slots("pairs_1pt", out, rows)
    if rows:
        _build.library().call(
            "nudge_pairs_1pt", *[_build.ptr(t) for t, _, _ in ins.values()],
            nb, n_bs, n_ss, *[_build.ptr(out[k]) for k in SLOTS],
            _build.stream_of(bx.half))
        pairs_1pt_slots_cuda.launches += 1
    return out


control.counter(pairs_1pt_slots_cuda)


def pairs_1pt_adjoint_cuda(bx: Boxes, sp: Spheres, wc: WorldColliders,
                           bs: CandidatePairs, ss: CandidatePairs, g_pos,
                           g_depth, g_normal, out=None, g_friction=None,
                           out_shape=None):
    """The backward kernel: the pose adjoint rows f32[P_bs + P_ss, 14] of
    the live box-sphere then sphere-sphere pair rows (side a's position
    and, for a box, quaternion; side b's position; zeros elsewhere), from
    the rows' pos, depth and normal adjoints (None: zero), into `out` where
    given, else into new rows. With `out_shape` ([rows, SHAPE_INPUTS]) the
    shape instance also writes the half-extent, radius and friction
    adjoints of each live row, the frictions through `g_friction` (None:
    zero). A dead row is left as it was, as box-box's
    (`narrowphase_kernel.box_box_adjoint_cuda`)."""
    nb, ns = bx.half.shape[0], sp.radius.shape[0]
    n_bs, n_ss = bs.a.shape[0], ss.a.shape[0]
    rows = n_bs + n_ss
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ins = dict(half=(bx.half, f32, (nb, 3)),
               box_quat=(wc.box_quat, f32, (nb, 4)),
               box_pos=(wc.box_pos, f32, (nb, 3)),
               box_friction=(bx.friction, f32, (nb,)),
               radius=(sp.radius, f32, (ns,)),
               sph_pos=(wc.sph_pos, f32, (ns, 3)),
               sph_friction=(sp.friction, f32, (ns,)),
               bs_a=(bs.a, i32, (n_bs,)), bs_b=(bs.b, i32, (n_bs,)),
               bs_valid=(bs.valid, b8, (n_bs,)),
               ss_a=(ss.a, i32, (n_ss,)), ss_b=(ss.b, i32, (n_ss,)),
               ss_valid=(ss.valid, b8, (n_ss,)))
    for name, (t, dt, shape) in ins.items():
        _build.check_cuda("pairs_1pt_bwd", name, t, dt, shape)
    g_ptrs, out, shape_ptr = adjoint_ins(
        "pairs_1pt_bwd", rows, g_pos, g_depth, g_normal, g_friction, out,
        out_shape, bx.half.device)
    if rows:
        _build.library().call("nudge_pairs_1pt_bwd",
                              *[_build.ptr(t) for t, _, _ in ins.values()],
                              n_bs, n_ss, *g_ptrs, _build.ptr(out), shape_ptr,
                              _build.stream_of(bx.half))
        pairs_1pt_adjoint_cuda.launches += 1
    return out


control.counter(pairs_1pt_adjoint_cuda)
