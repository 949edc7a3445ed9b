"""Fixed-order segment sums: the CUDA kernel's wrapper and its plain twin.

The backward kernels (narrowphase, setup, the solve) write one adjoint row
per item: a pair's pose inputs, a manifold's body inputs, a slot's reads of
static bodies. A body or collider is in many items, so its adjoint is the
sum of their rows. `entries` sorts the rows' keys stably once, and
`segment_sum` adds the rows of each key in that order (csrc/segment.cu: one
warp an output row, one lane a column, no float atomics), so a backward
repeats bit for bit and equals the plain sequential `index_add_` of
`segment_sum_plain`.

`segment_sum` dispatches by device: CPU tensors go to the plain twin, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .. import _build, control


_I32_MAX = 2 ** 31 - 1


def entries(keys, take):
    """(sorted keys i32[E], perm i64[E]) for a segment sum over the flat
    `keys` (the output row of each source row): rows without `take` get
    INT32_MAX and add nothing; the sort is stable, so each key's rows stay
    in source order."""
    k = torch.where(take, keys, _I32_MAX).to(torch.int32).reshape(-1)
    k, perm = torch.sort(k, stable=True)
    return k.contiguous(), perm.contiguous()


def segment_sum_plain(keys, perm, vals, n_out: int, init=None):
    """out[r] = init[r] (or 0) + Σ vals[perm[e]] over the entries e with
    keys[e] == r, in entry order (a sequential index_add on the CPU)."""
    live = keys < n_out
    out = (torch.zeros((n_out, vals.shape[1]), dtype=vals.dtype,
                       device=vals.device) if init is None else init.clone())
    return out.index_add_(0, keys[live].to(torch.int64), vals[perm[live]])


def segment_sum_cuda(keys, perm, vals, n_out: int, init=None):
    """The segment-sum kernel: a new [n_out, W] tensor."""
    n_entries, width = keys.shape[0], vals.shape[1]
    _build.check_cuda("segment_sum", "keys", keys, torch.int32, (n_entries,))
    _build.check_cuda("segment_sum", "perm", perm, torch.int64, (n_entries,))
    _build.check_cuda("segment_sum", "vals", vals, torch.float32,
                      (vals.shape[0], width))
    if init is None:
        out = torch.empty((n_out, width), dtype=torch.float32,
                          device=vals.device)
    else:
        _build.check_cuda("segment_sum", "init", init, torch.float32,
                          (n_out, width))
        out = init.clone()
    _build.library().call("nudge_segment_sum", _build.ptr(keys),
                          _build.ptr(perm), _build.ptr(vals), n_entries, n_out,
                          width, int(init is not None), _build.ptr(out),
                          _build.stream_of(vals))
    segment_sum.launches += 1
    return out


def segment_sum(keys, perm, vals, n_out: int, init=None):
    """Per-key sums of `vals`' rows in `entries` order: [n_out, W]."""
    dev = vals.device
    if dev.type == "cpu":
        return segment_sum_plain(keys, perm, vals, n_out, init)
    if dev.type == "cuda":
        return segment_sum_cuda(keys, perm, vals, n_out, init)
    raise NotImplementedError(f"segment_sum: no kernel for device {dev}")


control.counter(segment_sum)
