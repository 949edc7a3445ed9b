"""Box-box narrowphase over candidate pairs: the CUDA kernel's wrapper.

Replaces `nudge_tpu/ops/narrowphase_kernel.py: box_box_pallas` (kernel body
`_make_np_kernel`, math in `_box_box_rows`). The TPU kernel gathers collider
rows with one-hot matmuls from a resident table and carries ids as f32; the
CUDA kernel (csrc/narrowphase.cu) runs one thread per candidate pair, reads
both boxes' half extents, world quat and position, friction and body by
int32 index, and runs `narrowphase.box_box` in registers.

`box_box_slots` dispatches by device: CPU tensors go to the plain twin
`box_box_slots_plain` (which calls `narrowphase.box_box`); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .. import _build
from ..state import Boxes
from . import narrowphase as nps
from .broadphase import CandidatePairs, WorldColliders

POINTS = nps.BOX_BOX_POINTS


def combine_friction(fa, fb):
    """Geometric-mean material combine."""
    return torch.sqrt(torch.clamp_min(fa * fb, 0.0))


def box_box_slots_plain(bx: Boxes, wc: WorldColliders, bb: CandidatePairs):
    """Per-pair manifold slots with the plain PyTorch twin."""
    a = bb.a.to(torch.int64)
    b = bb.b.to(torch.int64)
    man = nps.box_box(bx.half[a], wc.box_quat[a], wc.box_pos[a],
                      bx.half[b], wc.box_quat[b], wc.box_pos[b])
    return dict(
        body_a=bx.body[a], body_b=bx.body[b],
        ga=bb.a.to(torch.int32), gb=bb.b.to(torch.int32),
        normal=man["normal"],
        friction=combine_friction(bx.friction[a], bx.friction[b]),
        pos=man["pos"], depth=man["depth"], feat=man["feat"],
        point_valid=man["valid"] & bb.valid[:, None],
    )


def _check(t, dtype, shape, name):
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"box_box kernel: {name} must be a contiguous CUDA "
                         f"{dtype} tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def box_box_slots_cuda(bx: Boxes, wc: WorldColliders, bb: CandidatePairs):
    """Per-pair manifold slots from the CUDA kernel."""
    nb = bx.half.shape[0]
    p = bb.a.shape[0]
    ins = dict(half=(bx.half, torch.float32, (nb, 3)),
               quat=(wc.box_quat, torch.float32, (nb, 4)),
               pos=(wc.box_pos, torch.float32, (nb, 3)),
               friction=(bx.friction, torch.float32, (nb,)),
               body=(bx.body, torch.int32, (nb,)),
               a=(bb.a, torch.int32, (p,)), b=(bb.b, torch.int32, (p,)),
               valid=(bb.valid, torch.bool, (p,)))
    for name, (t, dt, shape) in ins.items():
        _check(t, dt, shape, name)
    lib = _build.library()
    dev = bx.half.device
    out = dict(
        normal=torch.empty((p, 3), dtype=torch.float32, device=dev),
        friction=torch.empty((p,), dtype=torch.float32, device=dev),
        body_a=torch.empty((p,), dtype=torch.int32, device=dev),
        body_b=torch.empty((p,), dtype=torch.int32, device=dev),
        pos=torch.empty((p, POINTS, 3), dtype=torch.float32, device=dev),
        depth=torch.empty((p, POINTS), dtype=torch.float32, device=dev),
        feat=torch.empty((p, POINTS), dtype=torch.int32, device=dev),
        point_valid=torch.empty((p, POINTS), dtype=torch.bool, device=dev),
    )
    lib.call("nudge_box_box",
             *[_build.ptr(t) for t, _, _ in ins.values()], p,
             *[_build.ptr(out[k]) for k in ("normal", "friction", "body_a",
                                             "body_b", "pos", "depth", "feat",
                                             "point_valid")],
             _build.stream_of(bx.half))
    box_box_slots.launches += 1
    out["ga"] = bb.a
    out["gb"] = bb.b
    return out


def box_box_slots(bx: Boxes, wc: WorldColliders, bb: CandidatePairs):
    """Manifold slot dict for every candidate box-box pair (fields body_a,
    body_b, ga, gb, normal, friction, pos, depth, feat, point_valid)."""
    dev = bx.half.device
    if dev.type == "cpu":
        return box_box_slots_plain(bx, wc, bb)
    if dev.type == "cuda":
        return box_box_slots_cuda(bx, wc, bb)
    raise NotImplementedError(f"box_box: no kernel for device {dev}")


box_box_slots.launches = 0
