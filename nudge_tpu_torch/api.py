"""nudge-parity functional API (PyTorch port of `nudge_tpu.api`).

The reference exposes seven free functions over caller-owned state
(`nudge.h`, SURVEY.md §8); the same seven entry points, with the same
pipeline semantics, map onto the port's ops:

    reference (nudge.h)                      here
    ------------------------------------    ------------------------------
    collide(active, contacts, ...)           collide(state, cfg)
    read_cached_impulses(cache, contacts)    read_cached_impulses(...)
    setup_contact_constraints(...)           setup_contact_constraints(...)
    apply_impulses(constraints, bodies)      apply_impulses(...)
    update_cached_impulses(...)              update_cached_impulses(...)
    write_cached_impulses(cache, ...)        write_cached_impulses(...)
    advance(active, bodies, dt)              advance(state-parts, cfg)

Setup and the solve go through the kernels' wrappers, so on CUDA tensors
they launch the setup and solve kernels, on CPU tensors the plain twins.
On the card the constraints are setup's `PackedConstraints` (the solve's
color-sorted rows) and the accumulators carry setup's work rows, in the
slot order `solver_kernel.color_order` computes from the coloring, as
`engine.step` does. Like the reference, setup colors the manifolds afresh
when no coloring is given; `engine.step` with `persistent_coloring=True`
colors through the cache instead (`solver.color_manifolds_cached`), so to
reproduce its step bit for bit pass that coloring, or run the engine with
`persistent_coloring=False`. No function changes its inputs. For the fused
one-call-per-step path use `engine.step`.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import SimConfig
from .mathx import cross, quat_rotate, quat_rotate_inv
from .ops import cache as _cache
from .ops import setup_kernel, solver_kernel
from .ops.contacts import Manifolds, collide as _collide
from .ops.integrate import advance as _advance, apply_gravity
from .ops.solver import accumulated_world_impulse
from .state import Bodies, ContactCache, SimState, SleepState

__all__ = [
    "collide", "read_cached_impulses", "setup_contact_constraints",
    "apply_impulses", "update_cached_impulses", "write_cached_impulses",
    "advance", "apply_gravity",
    "apply_impulse", "apply_force", "wake",
]


@dataclasses.dataclass
class Accumulators:
    """The impulse state from setup to the solve, the role it plays inside
    the reference's opaque ContactConstraintData."""

    acc: object            # the warm-started impulses: (λn, λt1, λt2) [M,P]
    #                        each from the twin, setup's work rows on the card
    pseudo: torch.Tensor   # f32[N,6] warm-started pseudo velocities v | w


def collide(state: SimState, cfg: SimConfig):
    """Broadphase + narrowphase + compaction (reference: nudge::collide).
    Returns (Manifolds, BPCache): store the cache back via
    state.replace(bp=...) to carry the persistent broadphase."""
    return _collide(state, cfg)


def read_cached_impulses(cache: ContactCache, contacts: Manifolds):
    """Warm-start payload per contact point: (impulses f32[M,P,3], pseudo
    f32[M,P]), zeros on a miss; pass the pseudo part to
    setup_contact_constraints as pwarm."""
    return _cache.read_cached_impulses(cache, contacts)


def setup_contact_constraints(bodies: Bodies, contacts: Manifolds, impulses,
                              cfg: SimConfig, pwarm=None, coloring=None):
    """Constraint data with the warm-start impulses applied. Returns
    (constraints, bodies, Accumulators). With sleeping on, zero the inverse
    mass and inertia of sleeping bodies first, as engine.step does."""
    con, velw, acc = setup_kernel.setup(bodies, contacts, impulses, cfg,
                                        coloring=coloring, pwarm=pwarm)
    return con, _with_velocities(bodies, velw), Accumulators(
        acc, velw[:, 6:12].contiguous())


def apply_impulses(constraints, bodies: Bodies, accumulators: Accumulators,
                   cfg: SimConfig):
    """The iterated impulse solve (`cfg.solver_iters` sweeps). Returns
    (Bodies, (λn, λt1, λt2), (pseudo_vel, pseudo_angvel), pseudo_acc): the
    pseudo pair is the split-impulse position correction
    (integrate.apply_position_correction), pseudo_acc feeds
    write_cached_impulses."""
    p = accumulators.pseudo
    velw = solver_kernel.pack_velw(bodies.vel, bodies.angvel, p[:, 0:3],
                                   p[:, 3:6])
    acc = accumulators.acc
    if isinstance(acc, torch.Tensor):   # the kernel updates its rows in place
        acc = acc.clone()
    velw, acc, pseudo_acc = solver_kernel.solve(velw, constraints, acc, cfg)
    return (_with_velocities(bodies, velw), acc,
            (velw[:, 6:9], velw[:, 9:12]), pseudo_acc)


def update_cached_impulses(constraints, accumulators):
    """Accumulated impulses as world-space vectors f32[M,P,3]."""
    return accumulated_world_impulse(constraints, accumulators)


def write_cached_impulses(contacts: Manifolds, impulse_world,
                          pseudo_acc=None) -> ContactCache:
    """New warm-start cache from this frame's contacts."""
    return _cache.write_cached_impulses(contacts, impulse_world, pseudo_acc)


def advance(bodies: Bodies, sleep: SleepState, cfg: SimConfig) -> Bodies:
    """Symplectic Euler position/orientation update (reference: advance)."""
    return _advance(bodies, sleep, cfg)


def _with_velocities(bodies: Bodies, velw) -> Bodies:
    return bodies.replace(vel=velw[:, 0:3].contiguous(),
                          angvel=velw[:, 3:6].contiguous())


# --- actuation helpers (functional analog of caller-owned momentum) --------
#
# The reference's BodyMomentum arrays are caller-owned (nudge.h, SURVEY
# C1): users actuate by writing velocities between calls. These return
# updated copies instead; each takes a batch too (a leading scene axis on
# every leaf, `impulse` [3] or [scenes, 3]).


def apply_impulse(bodies: Bodies, body, impulse, point=None) -> Bodies:
    """Apply a world-space impulse to `body`, at world `point` if given
    (adding the r x J angular impulse through the world-space inverse
    inertia), else at the center of mass. Static bodies (inv_mass 0) are
    unaffected. With sleeping on, pair it with `wake`."""
    dev = bodies.vel.device
    impulse = torch.as_tensor(impulse, dtype=torch.float32, device=dev)
    vel = bodies.vel.clone()
    vel[..., body, :] += impulse * bodies.inv_mass[..., body, None]
    angvel = bodies.angvel
    if point is not None:
        point = torch.as_tensor(point, dtype=torch.float32, device=dev)
        L = cross(point - bodies.pos[..., body, :], impulse)
        q = bodies.quat[..., body, :]
        angvel = angvel.clone()
        # zero inertia rows (statics) contribute nothing
        angvel[..., body, :] += quat_rotate(
            q, bodies.inv_inertia[..., body, :] * quat_rotate_inv(q, L))
    return bodies.replace(vel=vel, angvel=angvel)


def apply_force(bodies: Bodies, body, force, cfg: SimConfig,
                point=None) -> Bodies:
    """One step's worth of a constant world-space force: the impulse
    `force * cfg.dt` (as gravity enters in apply_gravity)."""
    force = torch.as_tensor(force, dtype=torch.float32,
                            device=bodies.vel.device)
    return apply_impulse(bodies, body, force * cfg.dt, point=point)


def wake(state: SimState, body) -> SimState:
    """Wake `body`: reset its idle counter and set it awake. The island
    propagation of the next step wakes the sleepers it touches."""
    idle = state.sleep.idle.clone()
    awake = state.sleep.awake.clone()
    idle[..., body] = 0
    awake[..., body] = True
    return state.replace(sleep=state.sleep.replace(idle=idle, awake=awake))
