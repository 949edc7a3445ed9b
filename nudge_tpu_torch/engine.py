"""The simulation step: collide -> warm start -> setup -> solve -> advance
(PyTorch port of `nudge_tpu.engine`).

`step` runs on whatever device the state lives on: on CUDA tensors the
narrowphase, setup and solve go through the hand-written kernels, on CPU
tensors through their plain twins. `simulate` is a Python loop over steps.

This slice runs the engine's default path with every body awake; sleeping,
the persistent broadphase, spheres and the differentiable mode raise
NotImplementedError instead of running a partial path.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import SimConfig
from .ops import setup_kernel, solver_kernel
from .ops.cache import read_cached_impulses, write_cached_impulses
from .ops.contacts import collide
from .ops.integrate import advance, apply_gravity, apply_position_correction
from .ops.solver import (
    accumulated_world_impulse, color_manifolds, color_manifolds_cached,
)
from .state import SimState

_NOT_YET = {
    "sleeping": "ROADMAP Queue 1 item 9",
    "persistent_broadphase": "ROADMAP Queue 1 item 9",
    "differentiable": "ROADMAP Queue 1 item 13",
}


def check_supported(cfg: SimConfig):
    for knob, where in _NOT_YET.items():
        if getattr(cfg, knob):
            raise NotImplementedError(
                f"SimConfig.{knob}=True is not ported yet ({where})")
    if cfg.max_spheres > 0:
        raise NotImplementedError(
            "sphere colliders are not ported yet (ROADMAP Queue 1 item 10)")


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
    """One simulation step. Returns (new_state, StepMetrics)."""
    check_supported(cfg)
    bodies = apply_gravity(state.bodies, state.sleep, cfg)
    contacts = collide(state, cfg)
    warm, pwarm = read_cached_impulses(state.cache, contacts, cfg)
    if cfg.persistent_coloring:
        coloring, colors = color_manifolds_cached(contacts, bodies, cfg,
                                                  state.colors)
    else:
        coloring, colors = color_manifolds(contacts, bodies, cfg), state.colors
    con, velw, acc = setup_kernel.setup(bodies, contacts, warm, cfg,
                                        coloring=coloring, pwarm=pwarm)
    velw, acc, pseudo_acc = solver_kernel.solve(velw, con, acc, cfg)
    bodies = bodies.replace(vel=velw[:, 0:3].contiguous(),
                            angvel=velw[:, 3:6].contiguous())
    cache = write_cached_impulses(contacts, accumulated_world_impulse(con, acc),
                                  pseudo_acc)

    bodies = advance(bodies, state.sleep, cfg)
    if cfg.split_impulse:
        bodies = apply_position_correction(
            bodies, (velw[:, 6:9], velw[:, 9:12]), state.sleep, cfg)

    new_state = state.replace(bodies=bodies, cache=cache, colors=colors,
                              step_count=state.step_count + 1)
    dyn = bodies.dynamic
    v = bodies.vel
    v2 = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
    ke = 0.5 * torch.sum(torch.where(
        dyn, v2 / torch.clamp_min(bodies.inv_mass, 1e-12), 0.0))
    metrics = StepMetrics(
        contact_count=contacts.contact_count,
        max_depth=torch.amax(torch.where(contacts.point_valid, contacts.depth,
                                         0.0)),
        spill_count=con.spill_count,
        overflow=contacts.overflow,
        awake_count=torch.sum((dyn & state.sleep.awake).to(torch.int32)),
        kinetic_energy=ke,
        overflow_bits=contacts.overflow_bits,
        manifold_demand=contacts.count,
        pair_demand=contacts.pair_demand,
    )
    return new_state, metrics


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
