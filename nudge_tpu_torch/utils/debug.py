"""Debug-mode invariants (PyTorch port of `nudge_tpu.utils.debug`).

The analog of a data race in this engine is a scatter conflict: two
manifolds of one color writing the same dynamic body. These helpers return
values for tests and debug runs; assert on them host-side."""

from __future__ import annotations

import torch


def coloring_conflicts(con, bodies) -> torch.Tensor:
    """Number of (color, dynamic body) slots written more than once over the
    valid manifolds (i64 0-d tensor). Must be 0 except in the spill color.
    `con` needs color, body_a, body_b and valid; pass the bodies the solve
    saw (sleepers static) to check the solve's own invariant. Counts are an
    integer bincount, so the result is the same on every device."""
    dyn = bodies.inv_mass > 0.0
    n = bodies.pos.shape[0]
    color = con.color.to(torch.int64)
    size = (int(torch.amax(color)) + 1) * n
    keys = []
    for body in (con.body_a, con.body_b):
        b = body.to(torch.int64)
        take = con.valid & dyn[b]
        keys.append(torch.where(take, color * n + b, size))
    counts = torch.bincount(torch.cat(keys), minlength=size + 1)[:size]
    return torch.sum(torch.clamp_min(counts - 1, 0))


def finite_state(state) -> bool:
    """True iff all body state is finite (NaN guard)."""
    b = state.bodies
    return all(bool(torch.isfinite(x).all())
               for x in (b.pos, b.quat, b.vel, b.angvel))
