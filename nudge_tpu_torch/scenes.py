"""Host-side scene construction (PyTorch port of `nudge_tpu.scenes`).

A numpy builder assembles bodies and colliders exactly as the JAX package's
does (same RNG draws, same sizing heuristics, bit for bit) and `finalize`
ships the padded arrays to one torch device. No random numbers are drawn
after construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SimConfig
from .state import (
    Bodies, Boxes, SimState, SleepState, Spheres, empty_cache,
    empty_color_cache,
)


def box_inertia_inv(mass: float, half: np.ndarray) -> np.ndarray:
    """Inverse diagonal inertia of a solid box with half extents `half`."""
    hx, hy, hz = half
    ix = mass / 3.0 * (hy * hy + hz * hz)
    iy = mass / 3.0 * (hx * hx + hz * hz)
    iz = mass / 3.0 * (hx * hx + hy * hy)
    return 1.0 / np.array([ix, iy, iz], np.float32)


def sphere_inertia_inv(mass: float, radius: float) -> np.ndarray:
    i = 0.4 * mass * radius * radius
    return np.full(3, 1.0 / i, np.float32)


class SceneBuilder:
    """Accumulates bodies/colliders in numpy; `finalize(cfg)` pads to the
    config's static capacities and returns a device SimState."""

    def __init__(self):
        self.pos, self.quat, self.vel, self.angvel = [], [], [], []
        self.inv_mass, self.inv_inertia = [], []
        self.box_body, self.box_half, self.box_lpos, self.box_lquat = [], [], [], []
        self.box_friction, self.box_tag = [], []
        self.sph_body, self.sph_radius, self.sph_lpos = [], [], []
        self.sph_friction, self.sph_tag = [], []
        self.connections = []

    # -- bodies ------------------------------------------------------------
    def add_body(self, pos, quat=(0, 0, 0, 1), vel=(0, 0, 0), angvel=(0, 0, 0),
                 inv_mass=0.0, inv_inertia=(0, 0, 0)) -> int:
        idx = len(self.pos)
        self.pos.append(np.asarray(pos, np.float32))
        self.quat.append(np.asarray(quat, np.float32))
        self.vel.append(np.asarray(vel, np.float32))
        self.angvel.append(np.asarray(angvel, np.float32))
        self.inv_mass.append(np.float32(inv_mass))
        self.inv_inertia.append(np.asarray(inv_inertia, np.float32))
        return idx

    # -- colliders ---------------------------------------------------------
    def attach_box(self, body: int, half, lpos=(0, 0, 0), lquat=(0, 0, 0, 1),
                   friction=None, tag=0) -> int:
        idx = len(self.box_body)
        self.box_body.append(body)
        self.box_half.append(np.asarray(half, np.float32))
        self.box_lpos.append(np.asarray(lpos, np.float32))
        self.box_lquat.append(np.asarray(lquat, np.float32))
        self.box_friction.append(-1.0 if friction is None else float(friction))
        self.box_tag.append(tag)
        return idx

    def attach_sphere(self, body: int, radius, lpos=(0, 0, 0),
                      friction=None, tag=0) -> int:
        idx = len(self.sph_body)
        self.sph_body.append(body)
        self.sph_radius.append(np.float32(radius))
        self.sph_lpos.append(np.asarray(lpos, np.float32))
        self.sph_friction.append(-1.0 if friction is None else float(friction))
        self.sph_tag.append(tag)
        return idx

    # -- convenience: body + collider in one call ---------------------------
    def add_box(self, half, pos, quat=(0, 0, 0, 1), mass=1.0, vel=(0, 0, 0),
                angvel=(0, 0, 0), friction=None, tag=0) -> int:
        half = np.asarray(half, np.float32)
        body = self.add_body(pos, quat, vel, angvel, 1.0 / mass,
                             box_inertia_inv(mass, half))
        self.attach_box(body, half, friction=friction, tag=tag)
        return body

    def add_sphere(self, radius, pos, mass=1.0, vel=(0, 0, 0), angvel=(0, 0, 0),
                   friction=None, tag=0) -> int:
        body = self.add_body(pos, (0, 0, 0, 1), vel, angvel, 1.0 / mass,
                             sphere_inertia_inv(mass, radius))
        self.attach_sphere(body, radius, friction=friction, tag=tag)
        return body

    def add_static_box(self, half, pos, quat=(0, 0, 0, 1), friction=None,
                       tag=0) -> int:
        body = self.add_body(pos, quat)
        self.attach_box(body, half, friction=friction, tag=tag)
        return body

    def connect(self, body_a: int, body_b: int):
        """Suppress contacts between two bodies (BodyConnections, SURVEY C14)."""
        self.connections.append((body_a, body_b))

    # -- sizing ------------------------------------------------------------
    @property
    def num_bodies(self):
        return len(self.pos)

    def auto_config(self, pairs_per_box: float = 8.0, **overrides) -> SimConfig:
        """A SimConfig sized for this scene with headroom. Pair/contact caps
        scale with collider counts (dense-pile heuristic)."""
        nb, nbx, nsp = len(self.pos), len(self.box_body), len(self.sph_body)

        def cap(x, lo=16):
            x = max(int(x), lo)
            return -(-x // 8) * 8  # round up to 8

        n_small = nbx + nsp <= 64
        bb = cap(nbx * (nbx - 1) // 2 if n_small else nbx * pairs_per_box)
        bs = cap(nbx * nsp if n_small else (nbx + nsp) * pairs_per_box / 2,
                 lo=8 if nsp else 0) if nsp else 0
        ss = cap(nsp * (nsp - 1) // 2 if n_small else nsp * pairs_per_box / 2,
                 lo=8 if nsp else 0) if nsp else 0
        kw = dict(
            max_bodies=cap(nb, lo=8),
            max_boxes=cap(nbx, lo=8),
            max_spheres=cap(nsp, lo=0) if nsp else 0,
            max_box_box_pairs=bb,
            max_box_sphere_pairs=bs,
            max_sphere_sphere_pairs=ss,
            max_manifolds=bb + bs + ss,
            max_connections=len(self.connections),
        )
        kw.update(overrides)
        if "grid_table_dims" not in kw and self.pos:
            # The dense grid table must cover the spawn footprint, or
            # out-of-extent colliders pile into border cells. Estimate the
            # runtime cell size from the builder's geometry and grow the
            # table beyond the default only when the footprint needs it.
            # The estimate uses the half-diagonal, which overestimates the
            # grid's cell; it is kept bit for bit equal to the JAX package's
            # so both size their tables the same.
            halfdiags = [float(np.linalg.norm(h_)) for h_ in self.box_half]
            halfdiags += [float(r) for r in self.sph_radius]
            if halfdiags:
                med = float(np.median(halfdiags))
                non_big = [h_ for h_ in halfdiags if h_ <= 2.0 * med]
                cell_est = 2.0 * (max(non_big) if non_big else med)
                cell_est = max(cell_est, 1e-3)
                pos = np.asarray(self.pos, np.float32)
                span = pos.max(axis=0) - pos.min(axis=0)
                dims0 = SimConfig().grid_table_dims
                # slack 1.15 + 4 cells: cell_est excludes the AABB margin so
                # it already underestimates the runtime cell (overestimating
                # need); the mean-anchored re-base + border clamping degrade
                # gracefully for small residual excursions
                need = [int(np.ceil(s / cell_est * 1.15)) + 4 for s in span]
                dims = tuple(
                    min(1024, -(-max(d, n_) // 8) * 8)
                    for d, n_ in zip(dims0, need))
                if dims != dims0:
                    kw["grid_table_dims"] = dims
        if "max_lin_vel" not in kw:
            # tunneling armor (SimConfig.max_lin_vel): 1.25x the larger of
            # the scene's free-fall ceiling and its fastest spawned body —
            # never touches legitimate motion (projectiles included); the
            # 20 m/s floor keeps small scenes unaffected. NOTE this
            # auto-clamp is momentum-affecting for bodies driven above the
            # bound mid-simulation; pass max_lin_vel=0.0 to disable.
            g = float(np.linalg.norm(kw.get("gravity", (0.0, -9.81, 0.0))))
            h = max((p[1] for p in self.pos), default=0.0) + 2.0
            v0 = max((float(np.linalg.norm(v)) for v in self.vel), default=0.0)
            kw["max_lin_vel"] = max(20.0, 1.25 * float(np.sqrt(2 * g * h)),
                                    1.25 * v0)

        # Scale-derived stabilization family: the SimConfig defaults were
        # tuned on 0.5 m boxes at dt=1/60
        # under 9.81 gravity. Lengths (slop, margins, deep-bias depths)
        # scale with the scene's characteristic DYNAMIC collider size L;
        # velocity knobs scale with the per-step gravity kick g*dt (the
        # creep/jitter unit the comments in config.py reason in); the
        # pseudo cap is a position-correction RATE and scales as L/dt.
        # At (L=0.5, dt=1/60, g=9.81) every derived value equals the tuned
        # default bit-for-bit (scales evaluate to exactly 1.0). Explicit
        # overrides always win.
        dyn_sizes = [float(np.min(np.abs(h_))) for bi, h_ in
                     zip(self.box_body, self.box_half)
                     if self.inv_mass[bi] > 0.0]
        dyn_sizes += [float(r) for bi, r in
                      zip(self.sph_body, self.sph_radius)
                      if self.inv_mass[bi] > 0.0]
        if dyn_sizes:
            dflt = SimConfig()
            L = float(np.median(dyn_sizes))
            dt = float(kw.get("dt", dflt.dt))
            g = float(np.linalg.norm(kw.get("gravity", dflt.gravity)))
            s_len = L / 0.5
            # zero-g scenes fall back to the position rate for velocity
            # knobs (nothing creeps under load without gravity, but the
            # caps must stay finite and nonzero)
            s_vel = (g * dt) / (9.81 / 60.0) if g > 0 else \
                s_len * (1.0 / 60.0) / dt
            s_rate = s_len * (1.0 / 60.0) / dt
            derived = dict(
                slop=dflt.slop * s_len,
                aabb_margin=dflt.aabb_margin * s_len,
                rebuild_margin=dflt.rebuild_margin * s_len,
                deep_bias_depth=dflt.deep_bias_depth * s_len,
                deep_bias_ungated_depth=dflt.deep_bias_ungated_depth * s_len,
                deep_bias_gate=dflt.deep_bias_gate * s_vel,
                deep_bias_ungated_vel=dflt.deep_bias_ungated_vel * s_vel,
                max_bias_vel=dflt.max_bias_vel * s_vel,
                max_pseudo_vel=dflt.max_pseudo_vel * s_rate,
                sleep_lin_vel=dflt.sleep_lin_vel * s_vel,
                sleep_ang_vel=dflt.sleep_ang_vel * s_vel / s_len,
            )
            for k, v in derived.items():
                kw.setdefault(k, v)
        if "kill_plane_y" not in kw and self.inv_mass:
            # Kill plane below the scene's static geometry: a dynamic body
            # that ends up under every static collider has left the world
            # (tunneled through / off the ground) — force-sleep it and
            # remove it from the broadphase (broadphase.dead_mask) before
            # it drags the grid's mean anchor away from the live scene.
            # Only derived when static colliders exist: the static
            # floor defines "below the world"; pure-dynamic scenes
            # (ballistics tests) keep the plane off.
            def _rot_y_row(q):      # row y of the rotation matrix of quat q
                x, y, z, w = (float(v) for v in q)
                return np.array([2 * (x * y + z * w),
                                 1 - 2 * (x * x + z * z),
                                 2 * (y * z - x * w)])

            static_bottoms = []
            for i, (bi, half, lp, lq) in enumerate(zip(
                    self.box_body, self.box_half, self.box_lpos,
                    self.box_lquat)):
                if self.inv_mass[bi] == 0.0:
                    # vertical AABB extent at spawn orientation (statics
                    # never move): e_y = |R_y·| · half
                    qb = self.quat[bi]
                    xb, yb, zb, wb = (float(v) for v in qb)
                    xl, yl, zl, wl = (float(v) for v in lq)
                    q = (wb * xl + xb * wl + yb * zl - zb * yl,
                         wb * yl - xb * zl + yb * wl + zb * xl,
                         wb * zl + xb * yl - yb * xl + zb * wl,
                         wb * wl - xb * xl - yb * yl - zb * zl)
                    ext = float(np.abs(_rot_y_row(q)) @ np.abs(half))
                    static_bottoms.append(
                        float(self.pos[bi][1] + lp[1]) - ext)
            for bi, r, lp in zip(self.sph_body, self.sph_radius,
                                 self.sph_lpos):
                if self.inv_mass[bi] == 0.0:
                    static_bottoms.append(
                        float(self.pos[bi][1] + lp[1]) - float(r))
            if static_bottoms:
                kw["kill_plane_y"] = min(static_bottoms) - 4.0
        return SimConfig(**kw)

    # -- finalize ----------------------------------------------------------
    def finalize(self, cfg: SimConfig, device="cpu") -> SimState:
        """Pad to the config's capacities and build a SimState on `device`."""
        nb, nbx, nsp = len(self.pos), len(self.box_body), len(self.sph_body)
        if nb > cfg.max_bodies:
            raise ValueError(f"{nb} bodies > capacity {cfg.max_bodies}")
        if nbx > cfg.max_boxes:
            raise ValueError(f"{nbx} boxes > capacity {cfg.max_boxes}")
        if nsp > cfg.max_spheres and nsp > 0:
            raise ValueError(f"{nsp} spheres > capacity {cfg.max_spheres}")

        def pad(rows, n, fill, width=None):
            rows = np.asarray(rows, np.float32) if rows else \
                np.zeros((0,) if width is None else (0, width), np.float32)
            shape = (n,) + rows.shape[1:]
            out = np.full(shape, fill, rows.dtype)
            out[: len(rows)] = rows
            return out

        def padi(rows, n, fill=-1):
            out = np.full((n,) + np.shape(rows)[1:] if rows else (n,), fill,
                          np.int32)
            if rows:
                out[: len(rows)] = np.asarray(rows, np.int32)
            return out

        quat_pad = pad(self.quat, cfg.max_bodies, 0.0, width=4)
        quat_pad[nb:, 3] = 1.0
        lquat_pad = pad(self.box_lquat, cfg.max_boxes, 0.0, width=4)
        lquat_pad[nbx:, 3] = 1.0

        def frict(vals, n):
            f = pad(vals, n, cfg.friction)
            f[f < 0] = cfg.friction
            return f

        ns = max(cfg.max_spheres, 1)
        nc = cfg.max_connections
        conn = np.full((nc, 2), -1, np.int32)
        if self.connections:
            conn[: len(self.connections)] = np.asarray(self.connections, np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return SimState(
            bodies=Bodies(
                pos=t(pad(self.pos, cfg.max_bodies, 0.0, width=3)),
                quat=t(quat_pad),
                vel=t(pad(self.vel, cfg.max_bodies, 0.0, width=3)),
                angvel=t(pad(self.angvel, cfg.max_bodies, 0.0, width=3)),
                inv_mass=t(pad(self.inv_mass, cfg.max_bodies, 0.0)),
                inv_inertia=t(pad(self.inv_inertia, cfg.max_bodies, 0.0,
                                  width=3)),
            ),
            boxes=Boxes(
                body=t(padi(self.box_body, cfg.max_boxes)),
                half=t(pad(self.box_half, cfg.max_boxes, 1.0, width=3)),
                lpos=t(pad(self.box_lpos, cfg.max_boxes, 0.0, width=3)),
                lquat=t(lquat_pad),
                friction=t(frict(self.box_friction, cfg.max_boxes)),
                tag=t(padi(self.box_tag, cfg.max_boxes, 0)),
            ),
            spheres=Spheres(
                body=t(padi(self.sph_body, ns)),
                radius=t(pad(self.sph_radius, ns, 1.0)),
                lpos=t(pad(self.sph_lpos, ns, 0.0, width=3)),
                friction=t(frict(self.sph_friction, ns)),
                tag=t(padi(self.sph_tag, ns, 0)),
            ),
            cache=empty_cache(cfg, device),
            sleep=SleepState(
                idle=t(np.zeros((cfg.max_bodies,), np.int32)),
                awake=t(np.ones((cfg.max_bodies,), bool)),
                pairs=t(np.full((cfg.max_manifolds, 2), -1, np.int32)),
            ),
            colors=empty_color_cache(cfg, device),
            connections=t(conn),
            step_count=t(np.zeros((), np.int32)),
        )


# ---------------------------------------------------------------------------
# Canonical benchmark scenes (BASELINE.md configs 1 and 4)
# ---------------------------------------------------------------------------

# Thick slab, top face at y=0. The thickness is tunneling armor: a
# collapsing tall pile ejects boxes above free-fall speed, and a fast box
# driven past a thin slab's center plane flips the SAT normal and is
# expelled downward. With a 10-deep slab the flip plane is unreachable.
# 60 wide so the containment walls of the largest pile (ext+wt ~= 50.3 at
# 20,480 bodies) stand fully on the slab.
GROUND_HALF = (60.0, 10.0, 60.0)


def _ground(b: SceneBuilder, friction=0.8):
    return b.add_static_box(GROUND_HALF, (0.0, -GROUND_HALF[1], 0.0),
                            friction=friction)


def scene_single_box(drop_height: float = 2.0):
    """BASELINE config 1: one unit box dropped on static ground."""
    b = SceneBuilder()
    _ground(b)
    b.add_box((0.5, 0.5, 0.5), (0.0, drop_height, 0.0))
    return b


def scene_pile(n_bodies: int, sphere_frac: float = 0.0, half: float = 0.5,
               seed: int = 0, spacing: float = 1.15, walls: bool = None):
    """BASELINE configs 3 & 4: jittered grid of falling bodies above ground.
    sphere_frac > 0 mixes spheres in (config 3). `walls` (default: on iff
    spheres are present OR the pile is big) rings the pile with four static
    walls: rigid spheres have no rolling resistance, so on an open slab
    they roll off the edge and free-fall forever; and a TALL collapse
    (20,480 = 26 layers) launches ballistic box ejecta that clear the slab
    edge ~34m away. Walls are sized to the ejecta ceiling: the speed clamp
    (SimConfig.max_lin_vel, 1.25x free fall) bounds ballistic height by
    vcap^2/2g, and the walls top out above it, thick enough (2m half) that
    a clamped body cannot cross one in a step."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    _ground(b)
    side = int(np.ceil(n_bodies ** (1 / 3)))
    d = 2 * half * spacing
    if walls is None:
        walls = sphere_frac > 0 or n_bodies >= 4096
    count = 0
    for iy in range(side * 2):
        for ix in range(side):
            for iz in range(side):
                if count >= n_bodies:
                    break
                p = (
                    (ix - (side - 1) / 2) * d + rng.uniform(-0.1, 0.1) * half,
                    half * 1.5 + iy * d,
                    (iz - (side - 1) / 2) * d + rng.uniform(-0.1, 0.1) * half,
                )
                if rng.uniform() < sphere_frac:
                    b.add_sphere(half * 0.9, p)
                else:
                    q = np.concatenate([rng.uniform(-0.05, 0.05, 3), [1.0]])
                    q /= np.linalg.norm(q)
                    b.add_box((half, half, half), p, quat=q)
                count += 1
    if walls:
        # appended AFTER the pile so dynamic-body indices are unchanged
        ext = max(side * d * 1.5, 12 * half)   # footprint + scatter margin
        # wall half-height covers the ballistic ceiling of clamp-limited
        # ejecta: vcap = 1.25*sqrt(2g(ymax+2)) (auto_config's max_lin_vel),
        # ceiling = vcap^2/2g = 1.5625*(ymax+2); walls top out at 2*wh above
        # it. Thick (2m half) so a clamped body cannot tunnel a wall in one
        # 1/60 step (0.53m at vcap~32).
        ymax = half * 1.5 + (-(-n_bodies // (side * side)) - 1) * d + half
        wh = max(4 * half, side * d * 0.5, 0.79 * (ymax + 2.0) + 1.0)
        wt = max(half, 2.0)
        for sx, sz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            b.add_static_box(
                (wt if sx else ext + 2 * wt, wh, wt if sz else ext + 2 * wt),
                (sx * (ext + wt), wh, sz * (ext + wt)))
    return b
