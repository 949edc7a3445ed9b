"""Box-sphere and sphere-sphere narrowphase over candidate pairs: the CUDA
kernel's wrapper.

Replaces `nudge_tpu/ops/narrowphase_kernel.py: pairs_1pt_pallas` (kernel
body `_make_1pt_kernel`, math in `_box_sphere_rows` and
`_sphere_sphere_rows`). The TPU kernel gathered collider rows with one-hot
matmuls from a unified box+sphere table; the CUDA kernel
(csrc/narrowphase_1pt.cu) runs one thread per pair of the concatenated
box-sphere + sphere-sphere stream, reads both colliders by int32 index and
runs `narrowphase.box_sphere` or `narrowphase.sphere_sphere` in registers.

Pairs carry global collider ids: a box keeps its index, sphere i is
`max_boxes + i` (the box arrays are capacity-sized, so these are the ids of
the contact cache). Each pair yields a one-point manifold: slot 0 holds the
contact, feature id 0; slots 1-3 are empty.

`pairs_1pt_slots` dispatches by device: CPU tensors go to the plain twin
`pairs_1pt_slots_plain`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .. import _build
from ..state import Boxes, Spheres
from . import narrowphase as nps
from .broadphase import CandidatePairs, WorldColliders
from .narrowphase_kernel import combine_friction

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
                         bs: CandidatePairs, ss: CandidatePairs):
    """Per-pair one-point manifold slots from the CUDA kernel."""
    nb, ns = bx.half.shape[0], sp.radius.shape[0]
    ga, gb, live = _stream(bs, ss, nb)
    p = ga.shape[0]
    f32, i32 = torch.float32, torch.int32
    ins = dict(half=(bx.half, f32, (nb, 3)),
               box_quat=(wc.box_quat, f32, (nb, 4)),
               box_pos=(wc.box_pos, f32, (nb, 3)),
               box_friction=(bx.friction, f32, (nb,)),
               box_body=(bx.body, i32, (nb,)),
               radius=(sp.radius, f32, (ns,)),
               sph_pos=(wc.sph_pos, f32, (ns, 3)),
               sph_friction=(sp.friction, f32, (ns,)),
               sph_body=(sp.body, i32, (ns,)),
               ga=(ga, i32, (p,)), gb=(gb, i32, (p,)),
               live=(live, torch.bool, (p,)))
    for name, (t, dt, shape) in ins.items():
        _build.check_cuda("pairs_1pt", name, t, dt, shape)
    dev = bx.half.device
    out = dict(
        normal=torch.empty((p, 3), dtype=f32, device=dev),
        friction=torch.empty((p,), dtype=f32, device=dev),
        body_a=torch.empty((p,), dtype=i32, device=dev),
        body_b=torch.empty((p,), dtype=i32, device=dev),
        pos=torch.empty((p, POINTS, 3), dtype=f32, device=dev),
        depth=torch.empty((p, POINTS), dtype=f32, device=dev),
        feat=torch.empty((p, POINTS), dtype=i32, device=dev),
        point_valid=torch.empty((p, POINTS), dtype=torch.bool, device=dev),
    )
    if p:
        _build.library().call(
            "nudge_pairs_1pt", *[_build.ptr(t) for t, _, _ in ins.values()],
            nb, p, *[_build.ptr(t) for t in out.values()],
            _build.stream_of(bx.half))
        pairs_1pt_slots.launches += 1
    out["ga"] = ga
    out["gb"] = gb
    return out


def pairs_1pt_slots(bx: Boxes, sp: Spheres, wc: WorldColliders,
                    bs: CandidatePairs, ss: CandidatePairs):
    """Manifold slot dict for every box-sphere pair, then every
    sphere-sphere pair (the fields of `box_box_slots`)."""
    dev = bx.half.device
    if dev.type == "cpu":
        return pairs_1pt_slots_plain(bx, sp, wc, bs, ss)
    if dev.type == "cuda":
        return pairs_1pt_slots_cuda(bx, sp, wc, bs, ss)
    raise NotImplementedError(f"pairs_1pt: no kernel for device {dev}")


pairs_1pt_slots.launches = 0
