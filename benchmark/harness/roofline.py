"""Peaks of one H100 and the work of the contact solve, counted from the
problem's live counts.

The least time the card could take for a kernel's work is the larger of
its bytes over HBM's bandwidth and its float operations over the float32
peak outside the tensor cores (NVIDIA H100 SXM data sheet, 700 W): a
roofline share is that bound over the measured device time.

The solve's work is what the problem needs, whatever implements it:
each input byte read once and each output byte written once, counted
from the live manifolds and their live points, the dynamic bodies and
the sweeps. The per-item sizes below are the rows a sequential-impulse
solve needs (contact frames, lever arms, inverse-inertia products,
effective masses and biases), re-based from the port's `chip_smoke.py`
(`SOLVE_BYTES_PER_MANIFOLD` 556 + 64 + 4 B and `SOLVE_OPS_PER_MANIFOLD`
750 a sweep for a manifold of 4 points) onto live points, so that a
change that re-lays out the rows, fuses setup into the solve or skips
dead slots leaves the count as it is.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# per live point: n-row lever arms ra, rb (6), the six I^-1 (r x d) rows
# (18), three effective masses, bias, pseudo bias and warm pseudo impulse
# (6) = 30 floats in; the four accumulators (normal, two tangents,
# pseudo) in and out
SOLVE_BYTES_PER_POINT = 30 * 4 + 2 * 4 * 4
# per live manifold: normal and two tangents (9), friction, two inverse
# masses and the relaxation (4) and the two body ids (2), 4 B each
SOLVE_BYTES_PER_MANIFOLD = 15 * 4
# per dynamic body: linear, angular and the two pseudo velocities (12
# floats) in and out
SOLVE_BYTES_PER_BODY = 2 * 12 * 4
# per live point and sweep: the normal, two friction and pseudo updates
# with their clamps and the velocity changes of both bodies
SOLVE_OPS_PER_POINT_SWEEP = 750 / 4
# a gradient needs the forward once and its adjoint: at most a small
# multiple of the forward's operations (Griewank and Walther, Evaluating
# Derivatives, ch. 4); the bound takes three times
BWD_OPS_FACTOR = 3


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, "bytes" | "operations") of work that moves `n_bytes` and
    does `n_ops` float operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def solve_work(points: int, manifolds: int, bodies: int, sweeps: int):
    """(bytes, operations) of one solve over these live counts."""
    n_bytes = (points * SOLVE_BYTES_PER_POINT
               + manifolds * SOLVE_BYTES_PER_MANIFOLD
               + bodies * SOLVE_BYTES_PER_BODY)
    return n_bytes, points * sweeps * SOLVE_OPS_PER_POINT_SWEEP


def share_pct(bound_ms: float, device_ms: float) -> float:
    """The bound over the measured time, in percent."""
    return 100.0 * bound_ms / device_ms
