"""Checkpoint / resume (PyTorch port of `nudge_tpu.utils.checkpoint`).

A SimState saves to one .npz whose keys are the state's field paths joined
by "/" (`bodies/pos`, `bp/anchor_pos`, `step_count`, ...), the same keys
the JAX package writes, so a checkpoint it saved restores here. Restoring
a checkpoint this package saved is bitwise: stepping on from it gives the
same trajectory.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

_SEP = "/"


def _flatten(obj, prefix=""):
    """{path: tensor} over a dataclass tree of tensors, in field order."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(_flatten(v, key + _SEP))
        else:
            out[key] = v
    return out


def save(path: str, state) -> None:
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)   # np.savez won't create dirs
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in _flatten(state).items()})


def _rebuild(obj, values, prefix=""):
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        kw[f.name] = (_rebuild(v, values, key + _SEP)
                      if dataclasses.is_dataclass(v) else values[key])
    return dataclasses.replace(obj, **kw)


def restore(path: str, like, strict: bool = True):
    """Load a checkpoint into a state shaped like `like` (a template state
    of the same config, whose device the result takes). Keys the port does
    not model (the JAX persistent broadphase's tight-list memo) are
    ignored. A field missing from the file raises KeyError, or with
    strict=False keeps the template's value."""
    p = str(path)
    data = np.load(p if p.endswith(".npz") else p + ".npz")
    values = {}
    for key, ref in _flatten(like).items():
        if key not in data:
            if not strict:
                values[key] = ref
                continue
            raise KeyError(f"checkpoint missing field {key}")
        arr = data[key]
        if arr.shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint field {key} has shape {arr.shape}, state expects "
                f"{tuple(ref.shape)} (different SimConfig capacities?)")
        values[key] = torch.from_numpy(np.array(arr, copy=True)).to(
            device=ref.device, dtype=ref.dtype)
    return _rebuild(like, values)
