"""The reference's data: plain records of tensors, read from the program's
state by field name.

The reference imports nothing of the program. It reads a state the way
the check hands it over: nested objects whose fields are tensors (the
program's dataclasses), walked by `dataclasses.fields` and copied into
`Rec`s. The configuration is the run's numbers, read the same way.
"""

from __future__ import annotations

import dataclasses
import types

import torch

CONTACT_POINTS = 4


class Rec(types.SimpleNamespace):
    """A record of named fields; `replace` returns a copy with some changed."""

    def replace(self, **kw) -> "Rec":
        out = Rec(**vars(self))
        for k, v in kw.items():
            setattr(out, k, v)
        return out


def from_fields(obj):
    """`obj` (nested dataclasses of tensors) as nested `Rec`s of the same
    tensors (not copied)."""
    if dataclasses.is_dataclass(obj):
        return Rec(**{f.name: from_fields(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def leaves(rec, prefix: str = ""):
    """[(dotted name, tensor)] of a nested record, in field order."""
    out = []
    for name, v in vars(rec).items():
        key = f"{prefix}{name}"
        if isinstance(v, Rec):
            out += leaves(v, key + ".")
        elif isinstance(v, torch.Tensor):
            out.append((key, v))
    return out


def config(cfg) -> Rec:
    """The run's configuration as a `Rec` of its numbers (a dataclass or a
    dict), with the pair slot count the broadphase derives from them."""
    kw = (dict(cfg) if isinstance(cfg, dict)
          else {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    c = Rec(**kw)
    c.total_pairs = (c.max_box_box_pairs + c.max_box_sphere_pairs
                     + c.max_sphere_sphere_pairs)
    return c


def detached(rec) -> Rec:
    """`rec` with every tensor detached from autograd."""
    return Rec(**{k: detached(v) if isinstance(v, Rec)
                  else v.detach() if isinstance(v, torch.Tensor) else v
                  for k, v in vars(rec).items()})


def with_grad(rec, names) -> tuple:
    """(`rec` with the leaves named in `names` replaced by fresh copies that
    require grad, {name: that copy})."""
    made = {}

    def walk(r, prefix):
        out = {}
        for k, v in vars(r).items():
            key = prefix + k
            if isinstance(v, Rec):
                v = walk(v, key + ".")
            elif key in names:
                v = made[key] = v.detach().clone().requires_grad_()
            out[k] = v
        return Rec(**out)

    return walk(rec, ""), made
