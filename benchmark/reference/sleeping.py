"""Sleeping of the reference step: idle counters, islands that fall
asleep together, the wake gate and its flood, the kill plane, the parked
pairs. A frozen copy of the port's plain `update_sleep`.

Bodies whose velocity stays below the sleep thresholds for `sleep_frames`
steps become candidates; an island of touching candidates falls asleep
together; contacts between two sleepers are parked, so a touch from a
fast awake body wakes the whole island at once. The `awake` mask gates
gravity, integration and the broadphase's filters.

Translation notes against the port: each of its three `control.cond`s
(the asleep flood when some body is a candidate, the wake flood when some
body was woken, the parked pairs' rebuild when some body fell asleep or
woke) is a Python branch on the predicate read to the host, as the port's
eager step takes it.
"""

from __future__ import annotations

import torch

from .collide import compact_mask
from .mathx import dot

_BIG = 2 ** 31 - 1


def _scatter(x, idx, vals, how):
    return x.scatter_reduce(0, idx, vals, how, include_self=True)


def asleep_flood(lbl, ba, bb, edge, sweeps: int):
    """`sweeps` rounds of min-label propagation over the live contact edges
    between two dynamic bodies: wakefulness (-1) spreads through islands."""
    for _ in range(sweeps):
        thru_a = torch.where(edge, lbl[ba], _BIG)
        thru_b = torch.where(edge, lbl[bb], _BIG)
        lbl = _scatter(_scatter(lbl, bb, thru_a, "amin"), ba, thru_b, "amin")
    return lbl


def wake_flood(w, pa, pb, parked_live, sweeps: int):
    """`sweeps` rounds of wake-flag propagation over the parked pairs
    (int32 flags, 0 or 1)."""
    for _ in range(sweeps):
        wa = torch.where(parked_live, w[pa], 0)
        wb = torch.where(parked_live, w[pb], 0)
        w = _scatter(_scatter(w, pb, wa, "amax"), pa, wb, "amax")
    return w


def rebuild_pairs(pairs, asleep, ba, bb, live):
    """Parked pairs still fully asleep (in list order), then this step's live
    contacts whose two bodies are asleep (in manifold order), compacted to
    the list's capacity with -1 padding."""
    pa, pb = pairs[:, 0], pairs[:, 1]
    parked_live = pa >= 0
    keep_old = (parked_live & asleep[torch.clamp_min(pa, 0).long()]
                & asleep[torch.clamp_min(pb, 0).long()])
    new_pair = live & asleep[ba] & asleep[bb]
    cand_a = torch.cat([torch.where(keep_old, pa, -1),
                        torch.where(new_pair, ba.to(torch.int32), -1)])
    cand_b = torch.cat([torch.where(keep_old, pb, -1),
                        torch.where(new_pair, bb.to(torch.int32), -1)])
    sel, valid, _ = compact_mask(cand_a >= 0, pairs.shape[0])
    return torch.stack([torch.where(valid, cand_a[sel], -1),
                        torch.where(valid, cand_b[sel], -1)],
                       dim=-1).to(torch.int32)


def update_sleep(bodies, man, sleep, cfg, fast):
    """Post-solve sleep bookkeeping. Returns (sleep, bodies); bodies that
    fall asleep have their velocities zeroed. `fast` is the mask of bodies
    moving above the wake thresholds at the step's start (before gravity
    and the solve), which gates waking."""
    dyn = bodies.inv_mass > 0.0
    awake = sleep.awake
    ba, bb = man.body_a.long(), man.body_b.long()
    live = man.valid

    # idle counting
    slow = ((dot(bodies.vel, bodies.vel) < cfg.sleep_lin_vel ** 2)
            & (dot(bodies.angvel, bodies.angvel) < cfg.sleep_ang_vel ** 2))
    idle = torch.where(awake, torch.where(slow, sleep.idle + 1, 0), sleep.idle)
    candidate = dyn & awake & (idle >= cfg.sleep_frames)

    # falling asleep: only whole islands of candidates; awake dynamic
    # non-candidates flood -1 through live contacts between dynamic bodies
    lbl = torch.where(dyn & awake & ~candidate, -1, 0).to(torch.int32)
    lbl = torch.where(dyn, lbl, _BIG)
    edge = live & dyn[ba] & dyn[bb]
    if bool(torch.any(candidate)):
        lbl = asleep_flood(lbl, ba, bb, edge, cfg.island_sweeps)
    falls_asleep = candidate & ~(lbl < 0)
    awake = awake & ~falls_asleep

    # waking: a live contact from a fast awake body touches a sleeper, and
    # the flag floods its island through the parked pairs
    moving = dyn & awake & fast
    woken = torch.zeros(dyn.shape, dtype=torch.int32, device=dyn.device)
    woken = _scatter(woken, bb, (live & moving[ba] & ~awake[bb]
                                 & dyn[bb]).to(torch.int32), "amax")
    woken = _scatter(woken, ba, (live & moving[bb] & ~awake[ba]
                                 & dyn[ba]).to(torch.int32), "amax")
    pa, pb = sleep.pairs[:, 0], sleep.pairs[:, 1]
    wake_flag = woken
    if bool(torch.any(woken > 0)):
        wake_flag = wake_flood(woken, torch.clamp_min(pa, 0).long(),
                               torch.clamp_min(pb, 0).long(), pa >= 0,
                               cfg.island_sweeps)
    wake_flag = (wake_flag > 0) & dyn & ~awake
    awake = awake | wake_flag
    idle = torch.where(wake_flag | falls_asleep, 0, idle)

    # kill plane: bodies below it have left the world; force-sleep, never
    # wake
    if cfg.kill_plane_y > -1e8:
        below = dyn & (bodies.pos[:, 1] < cfg.kill_plane_y)
        falls_asleep = falls_asleep | (below & awake)
        awake = awake & ~below

    # parked pairs: rebuilt only on a step where a body fell asleep or woke
    pairs = sleep.pairs
    if bool(torch.any(falls_asleep) | torch.any(wake_flag)):
        pairs = rebuild_pairs(pairs, dyn & ~awake, ba, bb, live)

    fz = falls_asleep[:, None]
    bodies = bodies.replace(vel=torch.where(fz, 0.0, bodies.vel),
                            angvel=torch.where(fz, 0.0, bodies.angvel))
    return sleep.replace(idle=idle, awake=awake, pairs=pairs), bodies


def wake_fast(vel, angvel, cfg):
    """The wake gate's `fast` mask: moving above `wake_factor` times the
    sleep thresholds (hysteresis: settled jigglers do not re-wake their
    sleeping neighbours)."""
    wf2 = cfg.wake_factor ** 2
    return ((dot(vel, vel) > wf2 * cfg.sleep_lin_vel ** 2)
            | (dot(angvel, angvel) > wf2 * cfg.sleep_ang_vel ** 2))
