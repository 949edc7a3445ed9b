"""Box-box narrowphase over candidate pairs: the CUDA kernel's wrapper.

Replaces `nudge_tpu/ops/narrowphase_kernel.py: box_box_pallas` (kernel body
`_make_np_kernel`, math in `_box_box_rows`). The TPU kernel gathers collider
rows with one-hot matmuls from a resident table and carries ids as f32; the
CUDA kernel (csrc/narrowphase.cu) runs one thread per live candidate pair,
reads both boxes' half extents, world quat and position, friction and body
by int32 index, and runs `narrowphase.box_box` in registers.

A dead pair slot (`bb.valid` false) gets `point_valid` false from the
kernel and nothing else: its other fields are left as `torch.empty` made
them, since `contacts.compact_manifolds` reads no other field of a slot
without a valid point. A live slot gets its whole row, its collider ids
(`ga`, `gb`) too. The twin fills every field; the two agree on live slots.

`box_box_slots` dispatches by device: CPU tensors go to the plain twin
`box_box_slots_plain` (which calls `narrowphase.box_box`); CUDA tensors
launch the kernel or raise. `box_box_adjoint_cuda` launches the backward
kernel of the differentiable mode (`contacts.NarrowphaseFn`).
"""

from __future__ import annotations

import torch

from .. import _build, control

from ..state import Boxes
from . import narrowphase as nps
from .broadphase import CandidatePairs, WorldColliders

POINTS = nps.BOX_BOX_POINTS
CANDIDATES = 24      # clip candidates of the face case


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


# the manifold slot fields, in the kernels' order of output arguments: the
# shape of one pair slot's row, and the type
_F32, _I32 = torch.float32, torch.int32
SLOTS = dict(normal=((3,), _F32), friction=((), _F32), body_a=((), _I32),
             body_b=((), _I32), pos=((POINTS, 3), _F32),
             depth=((POINTS,), _F32), feat=((POINTS,), _I32),
             point_valid=((POINTS,), torch.bool), ga=((), _I32),
             gb=((), _I32))


def empty_slots(p: int, device) -> dict:
    """Uninitialised manifold slot buffers for `p` pair slots."""
    return {k: torch.empty((p,) + row, dtype=dt, device=device)
            for k, (row, dt) in SLOTS.items()}


def _align(row, dt) -> int:
    """The store width a kernel may use for a slot row of this shape and
    type: 16 bytes where the row is whole 16-byte words, else 4."""
    nbytes = dt.itemsize
    for n in row:
        nbytes *= n
    return 16 if nbytes % 16 == 0 else 4


def check_slots(kernel: str, out: dict, p: int):
    """Raise unless `out` holds slot buffers of `empty_slots`' fields for
    `p` pair slots, or views of such rows, each base aligned to the stores
    of its row (pos, depth and feat as 16-byte words)."""
    for k, (row, dt) in SLOTS.items():
        t = out[k]
        _build.check_cuda(kernel, k, t, dt, (p,) + row)
        if t.data_ptr() % _align(row, dt):
            raise ValueError(f"{kernel} kernel: out[{k!r}] needs a "
                             f"{_align(row, dt)}-byte aligned base")


def box_box_slots_cuda(bx: Boxes, wc: WorldColliders, bb: CandidatePairs,
                       out: dict = None):
    """Per-pair manifold slots from the CUDA kernel, into `out` where given
    (row views of the buffers `contacts.narrowphase_all` joins the pair
    classes in), else into new buffers."""
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
        _build.check_cuda("box_box", name, t, dt, shape)
    if out is None:
        out = empty_slots(p, bx.half.device)
    else:
        check_slots("box_box", out, p)
    _build.library().call(
        "nudge_box_box", *[_build.ptr(t) for t, _, _ in ins.values()], p,
        *[_build.ptr(out[k]) for k in SLOTS], _build.stream_of(bx.half))
    box_box_slots.launches += 1
    return out


# the pose inputs of a pair slot, in the backward kernel's order: box a's
# world position and quaternion, then box b's (csrc/narrowphase.cu)
POSE_INPUTS = 14
# the shape inputs of a pair slot, in the backward kernels' shape rows: side
# a's half extents (3), friction and radius, then side b's; a box's radius
# and a sphere's half extents are zero columns
SHAPE_INPUTS = 10
SHAPE_COLUMNS = SHAPE_INPUTS // 2


def _check_rows(kernel: str, name: str, t, p: int, width: int):
    _build.check_cuda(kernel, name, t, torch.float32, (p, width))
    if t.data_ptr() % 8:
        raise ValueError(f"{kernel} kernel: {name} needs an 8-byte aligned "
                         "base")


def adjoint_ins(kernel: str, p: int, g_pos, g_depth, g_normal, g_friction,
                out, out_shape, device):
    """The output adjoints' pointers (0 for None: a zero adjoint), the
    [p, POSE_INPUTS] adjoint rows `out` (new rows where None) and the
    pointer to the [p, SHAPE_INPUTS] shape rows `out_shape` (0 for None:
    the kernels' pose-only instance) of a narrowphase backward kernel,
    checked: the kernels store a row as 8-byte words."""
    ptrs = []
    for name, g, row in (("g_pos", g_pos, (POINTS, 3)),
                         ("g_depth", g_depth, (POINTS,)),
                         ("g_normal", g_normal, (3,)),
                         ("g_friction", g_friction, ())):
        if g is not None:
            _build.check_cuda(kernel, name, g, torch.float32, (p,) + row)
        ptrs.append(0 if g is None else _build.ptr(g))
    if out is None:
        out = torch.empty((p, POSE_INPUTS), dtype=torch.float32, device=device)
    _check_rows(kernel, "out", out, p, POSE_INPUTS)
    if out_shape is not None:
        _check_rows(kernel, "out_shape", out_shape, p, SHAPE_INPUTS)
    shape_ptr = 0 if out_shape is None else _build.ptr(out_shape)
    return ptrs, out, shape_ptr


def box_box_adjoint_cuda(bx: Boxes, wc: WorldColliders, bb: CandidatePairs,
                         g_pos, g_depth, g_normal, out=None, g_friction=None,
                         out_shape=None):
    """The backward kernel: the pose adjoint rows f32[P, 14] of the live
    pair slots, from the slots' pos, depth and normal adjoints (None: zero),
    into `out` where given (rows of `contacts._backward_kernels`' joined
    buffer), else into new rows. With `out_shape` ([P, SHAPE_INPUTS]) the
    kernel's shape instance also writes each live slot's half-extent and
    friction adjoints there, the frictions through the slots' friction
    adjoint `g_friction` (None: zero). A dead slot's rows are left as they
    were: `contacts.collider_entries` gives them the key the segment sum
    skips. The per-box sums are `contacts.narrowphase_backward_cuda`'s."""
    nb = bx.half.shape[0]
    p = bb.a.shape[0]
    f32 = torch.float32
    ins = dict(half=(bx.half, f32, (nb, 3)), quat=(wc.box_quat, f32, (nb, 4)),
               pos=(wc.box_pos, f32, (nb, 3)),
               friction=(bx.friction, f32, (nb,)),
               a=(bb.a, torch.int32, (p,)), b=(bb.b, torch.int32, (p,)),
               valid=(bb.valid, torch.bool, (p,)))
    for name, (t, dt, shape) in ins.items():
        _build.check_cuda("box_box_bwd", name, t, dt, shape)
    g_ptrs, out, shape_ptr = adjoint_ins(
        "box_box_bwd", p, g_pos, g_depth, g_normal, g_friction, out,
        out_shape, bx.half.device)
    _build.library().call("nudge_box_box_bwd",
                          *[_build.ptr(t) for t, _, _ in ins.values()], p,
                          *g_ptrs, _build.ptr(out), shape_ptr,
                          _build.stream_of(bx.half))
    box_box_adjoint_cuda.launches += 1
    return out


control.counter(box_box_adjoint_cuda)


def first_max_model(x):
    """The kernel's first-max over the CANDIDATES values of each row of x
    [P, 24], in its order: a scan from candidate 0 that takes a later
    candidate only if its value is strictly greater. Equal to torch.argmax
    (the twin's rule) for ordered values; with a NaN the scan keeps
    candidate 0 if it is NaN and never takes a later NaN, while
    torch.argmax takes the first NaN. A model for the tests only."""
    best = x[:, 0]
    idx = torch.zeros(x.shape[0], dtype=torch.int64)
    for k in range(1, x.shape[1]):
        take = x[:, k] > best
        best = torch.where(take, x[:, k], best)
        idx = torch.where(take, k, idx)
    return idx


def box_box_slots(bx: Boxes, wc: WorldColliders, bb: CandidatePairs):
    """Manifold slot dict for every candidate box-box pair (fields body_a,
    body_b, ga, gb, normal, friction, pos, depth, feat, point_valid)."""
    dev = bx.half.device
    if dev.type == "cpu":
        return box_box_slots_plain(bx, wc, bb)
    if dev.type == "cuda":
        return box_box_slots_cuda(bx, wc, bb)
    raise NotImplementedError(f"box_box: no kernel for device {dev}")


control.counter(box_box_slots)
