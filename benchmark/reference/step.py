"""One step of the engine in plain PyTorch: gravity, collide, the cache's
warm starts, the cached coloring, setup, the solve, the cache write,
advance and the split-impulse position fix, with the step's metrics.

A frozen copy of the port's plain twins in the port's order (its eager
step on the CPU), for what the benchmark's cells run: box scenes with the
grid broadphase, the cached coloring and split impulse, sleeping and the
persistent broadphase off. It runs on whatever device its inputs are on.

`step(state, cfg, low=None, solve64=False)` takes the program's state as
a `tree.Rec`. With `low` (a dtype such as torch.bfloat16) it is the
check's control: the same step with the state and every stage's floats
stored in `low` (rounded there and back at each stage boundary), the step
that a change storing them in that precision would take. With `solve64`
the solve runs in float64 on the float32 inputs, its outputs rounded back
to float32: autograd through the float32 solve loses about a percent of
the velocities' adjoint at the 20,480 pile to cancellation, through the
float64 one it does not, so a vector-Jacobian product takes it.
"""

from __future__ import annotations

import torch

from . import cache, collide, solver
from .mathx import dot, quat_integrate
from .tree import Rec


def _round(rec, low):
    """`rec` with every float tensor field rounded to `low` and back."""
    if low is None:
        return rec
    out = {}
    for k, v in vars(rec).items():
        if isinstance(v, Rec):
            v = _round(v, low)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            v = v.to(low).to(v.dtype)
        out[k] = v
    return Rec(**out)


def _rounded(values, low):
    if low is None:
        return values
    return tuple(v.to(low).to(v.dtype) for v in values)


def _cast(values, dtype):
    return tuple(v.to(dtype) for v in values)


def _solve(bodies, con, acc, pseudo0, cfg, solve64: bool):
    """The solve's sweeps (float64 inside with `solve64`); float32 out."""
    if not solve64:
        return solver.solve_from(bodies.vel, bodies.angvel, con, acc,
                                 pseudo0, cfg)
    f64 = torch.float64
    con64 = Rec(**{k: v.to(f64) if isinstance(v, torch.Tensor)
                   and v.is_floating_point() else v
                   for k, v in vars(con).items()})
    vel, angvel, acc, pseudo, pacc = solver.solve_from(
        bodies.vel.to(f64), bodies.angvel.to(f64), con64,
        _cast(acc, f64), _cast(pseudo0, f64), cfg)
    f32 = torch.float32
    return (vel.to(f32), angvel.to(f32), _cast(acc, f32), _cast(pseudo, f32),
            pacc.to(f32))


def apply_gravity(bodies, sleep, cfg):
    """v += g·dt on dynamic awake bodies."""
    g = torch.tensor(cfg.gravity, dtype=torch.float32,
                     device=bodies.vel.device)
    move = ((bodies.inv_mass > 0.0) & sleep.awake)[:, None]
    return bodies.replace(
        vel=torch.where(move, bodies.vel + g * cfg.dt, bodies.vel))


def apply_position_correction(bodies, pseudo, sleep, cfg):
    """Split impulse: the solver's pseudo velocities integrated into the
    pose only."""
    pv, pw = pseudo
    move = ((bodies.inv_mass > 0.0) & sleep.awake)[:, None]
    pos = torch.where(move, bodies.pos + pv * cfg.dt, bodies.pos)
    quat = torch.where(move, quat_integrate(bodies.quat, pw, cfg.dt),
                       bodies.quat)
    return bodies.replace(pos=pos, quat=quat)


def advance(bodies, sleep, cfg):
    """x += v·dt; q = normalize(q + ½·dt·ω⊗q) on dynamic awake bodies, after
    clamping the speed to cfg.max_lin_vel when that is > 0."""
    move = ((bodies.inv_mass > 0.0) & sleep.awake)[:, None]
    vel = bodies.vel
    if cfg.max_lin_vel > 0.0:
        ss = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2]
        speed = torch.sqrt(torch.clamp_min(ss, 1e-12))
        scale = torch.clamp_max(
            torch.div(torch.full_like(speed, cfg.max_lin_vel), speed),
            1.0)[:, None]
        vel = torch.where(move, vel * scale, vel)
        bodies = bodies.replace(vel=vel)
    pos = torch.where(move, bodies.pos + vel * cfg.dt, bodies.pos)
    quat = torch.where(
        move, quat_integrate(bodies.quat, bodies.angvel, cfg.dt), bodies.quat)
    return bodies.replace(pos=pos, quat=quat)


def step(state, cfg, low=None, solve64=False):
    """One step from `state`. Returns (state, metrics), both `Rec`s; the
    state holds the fields the step writes (bodies, cache, colors,
    step_count) and the metrics those of the program's StepMetrics."""
    if cfg.sleeping or not cfg.persistent_coloring or not cfg.split_impulse:
        raise NotImplementedError("the reference steps with sleeping off, "
                                  "the cached coloring and split impulse")
    state = _round(state, low)
    bodies = apply_gravity(state.bodies, state.sleep, cfg)
    man = _round(collide.collide(state, cfg), low)
    warm, pwarm = _rounded(cache.read_cached_impulses(state.cache, man), low)
    coloring, colors = solver.color_manifolds_cached(man, bodies, cfg,
                                                     state.colors)
    con, bodies, acc = solver.setup_constraints(bodies, man, warm, cfg,
                                                coloring=coloring,
                                                pwarm=pwarm)
    pseudo0 = solver.pseudo_warm_start(con, bodies.pos.shape[0])
    con, bodies = _round(con, low), _round(bodies, low)
    acc, pseudo0 = _rounded(acc, low), _rounded(pseudo0, low)
    vel, angvel, acc, pseudo, pacc = _solve(bodies, con, acc, pseudo0, cfg,
                                            solve64)
    vel, angvel, pacc = _rounded((vel, angvel, pacc), low)
    acc, pseudo = _rounded(acc, low), _rounded(pseudo, low)
    bodies = bodies.replace(vel=vel, angvel=angvel)
    new_cache = cache.write_cached_impulses(
        man, solver.accumulated_world_impulse(con, acc), pacc)
    bodies = advance(bodies, state.sleep, cfg)
    bodies = _round(apply_position_correction(bodies, pseudo, state.sleep,
                                              cfg), low)

    dyn = bodies.inv_mass > 0.0
    ke = 0.5 * torch.sum(torch.where(
        dyn, dot(bodies.vel, bodies.vel) / torch.clamp_min(bodies.inv_mass,
                                                            1e-12), 0.0))
    i32 = torch.int32
    metrics = Rec(
        contact_count=torch.sum(man.point_valid.to(i32)).to(i32),
        max_depth=torch.amax(torch.where(man.point_valid, man.depth, 0.0)),
        spill_count=con.spill_count.to(i32),
        overflow=man.overflow,
        awake_count=torch.sum((dyn & state.sleep.awake).to(i32)).to(i32),
        kinetic_energy=ke,
        overflow_bits=man.overflow_bits.to(i32),
        manifold_demand=man.count.to(i32),
        pair_demand=man.pair_demand.to(i32),
    )
    out = state.replace(bodies=bodies, cache=new_cache, colors=colors,
                        step_count=state.step_count + 1)
    return out, metrics
