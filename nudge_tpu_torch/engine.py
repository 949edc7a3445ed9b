"""The simulation step: collide -> warm start -> setup -> solve -> advance
(PyTorch port of `nudge_tpu.engine`).

`step` runs on whatever device the state lives on: on CUDA tensors both
narrowphases, the fresh coloring's claim rounds, setup and solve go
through the hand-written kernels (the solve in one launch, with no host
read), on CPU tensors through their plain twins. `simulate` is a Python
loop over steps.

It runs boxes and spheres, with the cached or the fresh coloring, with or
without sleeping and the persistent broadphase (together: the reference
mode of the JAX bench). The reference's two `lax.cond`s that depend only
on the state a step starts from (any dynamic body awake: step or park;
`persistent_bp.needs_rebuild`: fat rebuild or reuse) are Python branches
here, on flags read to the host in one transfer per step.

The differentiable mode (`cfg.differentiable`): `step` and `simulate` build
an autograd graph from whatever state tensors require grad, as the
reference's jax.grad reverses its step. No stage takes a gradient out of
the graph: it flows through the narrowphase geometry, the cache's warm
impulses, setup, the solve, advance and the split-impulse fix; the integer
stages (broadphase, coloring, the solve's order) carry none, as in the
reference. On the CPU the graph runs through the plain twins, with the
reference's static `solver_iters * max_colors` sweep (ops/solver.py). On
the card the kernels run inside autograd Functions whose backward is a
kernel too (the narrowphases, setup, the solve; the solve keeps its
dynamic color count, since the passes of unused colors are exact no-ops,
and records a tape of each visit). Without a gradient to build, the mode's
forward is the normal one, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import SimConfig
from .mathx import dot
from .ops import setup_kernel, solver_kernel
from .ops.cache import read_cached_impulses, write_cached_impulses
from .ops.contacts import collide
from .ops.integrate import advance, apply_gravity, apply_position_correction
from .ops.persistent_bp import needs_rebuild
from .ops.sleeping import update_sleep
from .ops.solver import (
    accumulated_world_impulse, color_manifolds, color_manifolds_cached,
)
from .state import SimState

@dataclasses.dataclass
class StepMetrics:
    """Per-step observability (0-d tensors, or [steps] when stacked)."""

    contact_count: torch.Tensor   # i32
    max_depth: torch.Tensor       # f32 max penetration this step
    spill_count: torch.Tensor     # i32 manifolds past the coloring budget
    overflow: torch.Tensor        # bool any capacity exceeded
    awake_count: torch.Tensor     # i32 dynamic awake bodies
    kinetic_energy: torch.Tensor  # f32 Σ ½|v|²/inv_mass over dynamic bodies
    overflow_bits: torch.Tensor   # i32 attribution (Manifolds.overflow_bits)
    manifold_demand: torch.Tensor  # i32 manifolds wanted
    pair_demand: torch.Tensor     # i32 candidate pairs wanted


def step(state: SimState, cfg: SimConfig):
    """One simulation step. Returns (new_state, StepMetrics).

    With sleeping on, a scene whose every dynamic body is asleep skips the
    whole contact pipeline (the park): nothing inside the engine can wake
    an all-asleep scene, so the skip is exact."""
    rebuild = None
    if cfg.sleeping or cfg.persistent_broadphase:
        flags = []
        if cfg.sleeping:
            flags.append(torch.any(state.sleep.awake & state.bodies.dynamic))
        if cfg.persistent_broadphase:
            flags.append(needs_rebuild(state, cfg))
        host = torch.stack(flags).tolist()       # one host read for both
        if cfg.sleeping and not host[0]:
            return _step_parked(state)
        if cfg.persistent_broadphase:
            rebuild = host[-1]
    return _step_active(state, cfg, rebuild)


def _step_parked(state: SimState):
    """All-asleep fast path: state unchanged except the step counter, and
    all-zero metrics."""
    step.parked += 1
    dev = state.device
    z_i = torch.zeros((), dtype=torch.int32, device=dev)
    z_f = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = StepMetrics(
        contact_count=z_i, max_depth=z_f, spill_count=z_i,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        awake_count=z_i, kinetic_energy=z_f, overflow_bits=z_i,
        manifold_demand=z_i, pair_demand=z_i)
    return state.replace(step_count=state.step_count + 1), metrics


def _step_active(state: SimState, cfg: SimConfig, rebuild):
    bodies = apply_gravity(state.bodies, state.sleep, cfg)
    contacts, bp = collide(state, cfg, rebuild=rebuild)
    warm, pwarm = read_cached_impulses(state.cache, contacts, cfg)
    if cfg.sleeping:
        # sleepers are static for coloring, setup and solve, so the solver
        # never writes velocity into them; true mass comes back before
        # advance
        im0, ii0 = bodies.inv_mass, bodies.inv_inertia
        asleep = ~state.sleep.awake
        bodies = bodies.replace(
            inv_mass=torch.where(asleep, 0.0, im0),
            inv_inertia=torch.where(asleep[:, None], 0.0, ii0))
    if cfg.persistent_coloring:
        coloring, colors = color_manifolds_cached(contacts, bodies, cfg,
                                                  state.colors)
    else:
        coloring, colors = color_manifolds(contacts, bodies, cfg), state.colors
    # the solve's color-sorted order, from the coloring; setup writes the
    # solve's rows in it on the card (the CPU twins keep manifold order)
    order = solver_kernel.color_order(contacts, bodies, coloring, cfg)
    con, velw, acc = setup_kernel.setup(bodies, contacts, warm, cfg,
                                        coloring=coloring, pwarm=pwarm,
                                        order=order)
    velw, acc, pseudo_acc = solver_kernel.solve(velw, con, acc, cfg)
    bodies = bodies.replace(vel=velw[:, 0:3].contiguous(),
                            angvel=velw[:, 3:6].contiguous())
    cache = write_cached_impulses(contacts, accumulated_world_impulse(con, acc),
                                  pseudo_acc)
    if cfg.sleeping:
        bodies = bodies.replace(inv_mass=im0, inv_inertia=ii0)

    bodies = advance(bodies, state.sleep, cfg)
    if cfg.split_impulse:
        bodies = apply_position_correction(
            bodies, (velw[:, 6:9], velw[:, 9:12]), state.sleep, cfg)
    sleep = state.sleep
    if cfg.sleeping:
        # the wake gate's "fast" mask is taken from the state the step
        # started from (pre-gravity, pre-solve); wake_factor hysteresis keeps
        # settled jigglers from re-waking their sleeping neighbours
        wf2 = cfg.wake_factor ** 2
        v0, w0 = state.bodies.vel, state.bodies.angvel
        fast0 = ((dot(v0, v0) > wf2 * cfg.sleep_lin_vel ** 2)
                 | (dot(w0, w0) > wf2 * cfg.sleep_ang_vel ** 2))
        sleep, bodies = update_sleep(bodies, contacts, state.sleep, cfg,
                                     fast=fast0)

    new_state = state.replace(bodies=bodies, cache=cache, sleep=sleep, bp=bp,
                              colors=colors, step_count=state.step_count + 1)
    dyn = bodies.dynamic
    ke = 0.5 * torch.sum(torch.where(
        dyn, dot(bodies.vel, bodies.vel) / torch.clamp_min(bodies.inv_mass,
                                                            1e-12), 0.0))
    metrics = StepMetrics(
        contact_count=contacts.contact_count,
        max_depth=torch.amax(torch.where(contacts.point_valid, contacts.depth,
                                         0.0)),
        spill_count=con.spill_count,
        overflow=contacts.overflow,
        awake_count=torch.sum((dyn & sleep.awake).to(torch.int32)),
        kinetic_energy=ke,
        overflow_bits=contacts.overflow_bits,
        manifold_demand=contacts.count,
        pair_demand=contacts.pair_demand,
    )
    return new_state, metrics


step.parked = 0


def simulate(state: SimState, cfg: SimConfig, steps: int):
    """Run `steps` steps. Returns (state, StepMetrics with [steps] fields)."""
    per_step = []
    for _ in range(steps):
        state, m = step(state, cfg)
        per_step.append(m)
    stacked = {f.name: torch.stack([getattr(m, f.name) for m in per_step])
               for f in dataclasses.fields(StepMetrics)}
    return state, StepMetrics(**stacked)


def step_jit(state: SimState, cfg: SimConfig):
    """The reference's jitted single step; PyTorch runs eagerly."""
    return step(state, cfg)
