"""What every call of a traffic mix does besides the program's work: the
gates a call must pass and the readback that ends it."""

from __future__ import annotations

import dataclasses

import torch


def finite(state) -> torch.Tensor:
    b = state.bodies
    return torch.stack([torch.isfinite(t).all()
                        for t in (b.pos, b.quat, b.vel, b.angvel)]).all()


def gates(metrics, state) -> torch.Tensor:
    """[overflow, non-finite state, max depth >= 0.5] of a call."""
    return torch.stack([metrics.overflow.any(), ~finite(state),
                        (metrics.max_depth >= 0.5).any()])


def read_back(metrics, flags):
    """The call's metrics and gate flags to the host in one copy; returns
    whether a gate failed."""
    rows = [t.reshape(-1).to(torch.float32) for t in vars(metrics).values()]
    host = torch.cat(rows + [flags.to(torch.float32)]).cpu()
    return bool(host[-flags.numel():].any())


def sync(state):
    """Wait for the device that holds `state` (nothing on the CPU)."""
    if state.bodies.pos.is_cuda:
        torch.cuda.synchronize(state.bodies.pos.device)


def leaves(tree) -> list:
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            out += leaves(getattr(tree, f.name))
        return out
    return [tree] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, it):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return next(it) if isinstance(tree, torch.Tensor) else tree


class Slot:
    """A state-shaped buffer made at set-up, into which the window copies a
    state the check will read: what the window keeps then takes the same
    memory whichever call the seed picks."""

    def __init__(self, like):
        self.state = _rebuild(like, iter([torch.empty_like(t)
                                          for t in leaves(like)]))

    def keep(self, state):
        torch._foreach_copy_(leaves(self.state), leaves(state))
        return self.state
