"""Symplectic Euler integration (PyTorch port of `nudge_tpu.ops.integrate`).

Every body slot is advanced under a mask (dynamic AND awake).
"""

from __future__ import annotations

import torch

from .. import control
from ..config import SimConfig
from ..mathx import quat_integrate
from ..state import Bodies, SleepState


def apply_gravity(bodies: Bodies, sleep: SleepState, cfg: SimConfig) -> Bodies:
    """v += g·dt on dynamic awake bodies (before the solve, so resting
    contacts cancel gravity each frame)."""
    g = control.constant(cfg.gravity, torch.float32, bodies.vel.device)
    move = (bodies.dynamic & sleep.awake)[:, None]
    return bodies.replace(
        vel=torch.where(move, bodies.vel + g * cfg.dt, bodies.vel))


def apply_position_correction(bodies: Bodies, pseudo, sleep: SleepState,
                              cfg: SimConfig) -> Bodies:
    """Split-impulse position fixup: integrate the solver's pseudo velocities
    into pose only; momentum is untouched."""
    pv, pw = pseudo
    move = (bodies.dynamic & sleep.awake)[:, None]
    pos = torch.where(move, bodies.pos + pv * cfg.dt, bodies.pos)
    quat = torch.where(move, quat_integrate(bodies.quat, pw, cfg.dt),
                       bodies.quat)
    return bodies.replace(pos=pos, quat=quat)


def advance(bodies: Bodies, sleep: SleepState, cfg: SimConfig) -> Bodies:
    """x += v·dt; q = normalize(q + ½·dt·ω⊗q) on dynamic awake bodies, after
    clamping the speed to cfg.max_lin_vel when that is > 0."""
    move = (bodies.dynamic & sleep.awake)[:, None]
    vel = bodies.vel
    if cfg.max_lin_vel > 0.0:
        ss = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2]
        speed = torch.sqrt(torch.clamp_min(ss, 1e-12))
        # torch.div, not `float / tensor`: the latter is a reciprocal times
        # the scalar and rounds differently from the reference's division
        scale = torch.clamp_max(
            torch.div(torch.full_like(speed, cfg.max_lin_vel), speed),
            1.0)[:, None]
        vel = torch.where(move, vel * scale, vel)
        bodies = bodies.replace(vel=vel)
    pos = torch.where(move, bodies.pos + vel * cfg.dt, bodies.pos)
    quat = torch.where(
        move, quat_integrate(bodies.quat, bodies.angvel, cfg.dt), bodies.quat)
    return bodies.replace(pos=pos, quat=quat)
