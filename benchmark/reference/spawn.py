"""The spawn scenes rebuilt from the seed, to check the program's start.

`pile(n, seed, cfg)` is BASELINE config 4's pile: `n` boxes of half
extent 0.5 on a jittered grid (spacing 1.15 box widths) above a static
slab, walled when n >= 4096. `pile_chunks(n_chunks, scenes, n, seed,
cfg, device)` is config 5's stack: chunks of `scenes` such piles tiled 20
m apart, the chunks decorrelated by a jitter drawn on the device from a
`torch.Generator` seeded `seed + 1`. Both give the bodies' and boxes'
arrays padded to the configuration's capacities: {name: tensor}, named
as the program's state names them ("bodies.pos", "boxes.half", ...),
with a leading chunk axis for the stack.

The draws follow the published scene's order (numpy's default_rng: x
and z jitter, then a quaternion jitter, a body at a time, layer by
layer), so the program's start must match them bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

GROUND_HALF = (60.0, 10.0, 60.0)


def _box_inv_inertia(mass: float, half) -> np.ndarray:
    hx, hy, hz = half
    ix = mass / 3.0 * (hy * hy + hz * hz)
    iy = mass / 3.0 * (hx * hx + hz * hz)
    iz = mass / 3.0 * (hx * hx + hy * hy)
    return 1.0 / np.array([ix, iy, iz], np.float32)


class _Scene:
    def __init__(self):
        self.rows = []      # (pos, quat, inv_mass, inv_inertia, half, friction)

    def box(self, half, pos, quat=(0, 0, 0, 1), static=False, friction=-1.0):
        half = np.asarray(half, np.float32)
        inv_i = np.zeros(3, np.float32) if static \
            else _box_inv_inertia(1.0, half)
        self.rows.append((np.asarray(pos, np.float32),
                          np.asarray(quat, np.float32),
                          np.float32(0.0 if static else 1.0), inv_i, half,
                          friction))

    def pile(self, rng, n, side, d, half, ox=0.0, oz=0.0):
        count = 0
        for iy in range(side * 2):
            for ix in range(side):
                for iz in range(side):
                    if count >= n:
                        return
                    p = (ox + (ix - (side - 1) / 2) * d
                         + rng.uniform(-0.1, 0.1) * half,
                         half * 1.5 + iy * d,
                         oz + (iz - (side - 1) / 2) * d
                         + rng.uniform(-0.1, 0.1) * half)
                    rng.uniform()    # the sphere draw (no spheres here)
                    q = np.concatenate([rng.uniform(-0.05, 0.05, 3), [1.0]])
                    q /= np.linalg.norm(q)
                    self.box((half, half, half), p, quat=q)
                    count += 1

    def arrays(self, cfg, device) -> dict:
        nb, nbx = cfg.max_bodies, cfg.max_boxes
        n = len(self.rows)
        pos = np.zeros((nb, 3), np.float32)
        quat = np.zeros((nb, 4), np.float32)
        quat[:, 3] = 1.0
        inv_mass = np.zeros(nb, np.float32)
        inv_inertia = np.zeros((nb, 3), np.float32)
        body = np.full(nbx, -1, np.int32)
        half = np.ones((nbx, 3), np.float32)
        lquat = np.zeros((nbx, 4), np.float32)
        lquat[:, 3] = 1.0
        friction = np.full(nbx, cfg.friction, np.float32)
        for i, (p, q, im, ii, h, f) in enumerate(self.rows):
            pos[i], quat[i], inv_mass[i], inv_inertia[i] = p, q, im, ii
            body[i], half[i] = i, h
            friction[i] = cfg.friction if f < 0 else f
        out = {"bodies.pos": pos, "bodies.quat": quat,
               "bodies.vel": np.zeros((nb, 3), np.float32),
               "bodies.angvel": np.zeros((nb, 3), np.float32),
               "bodies.inv_mass": inv_mass, "bodies.inv_inertia": inv_inertia,
               "boxes.body": body, "boxes.half": half,
               "boxes.lpos": np.zeros((nbx, 3), np.float32),
               "boxes.lquat": lquat, "boxes.friction": friction}
        assert n <= nb
        return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def pile(n: int, seed: int, cfg, device) -> dict:
    """BASELINE config 4's pile of `n` boxes from `seed`."""
    rng = np.random.default_rng(seed)
    half = 0.5
    s = _Scene()
    s.box(GROUND_HALF, (0.0, -GROUND_HALF[1], 0.0), static=True,
          friction=0.8)
    side = int(np.ceil(n ** (1 / 3)))
    d = 2 * half * 1.15
    s.pile(rng, n, side, d, half)
    if n >= 4096:
        # four static walls around the pile, appended after it, tall and
        # thick enough for the ejecta of the collapse
        ext = max(side * d * 1.5, 12 * half)
        ymax = half * 1.5 + (-(-n // (side * side)) - 1) * d + half
        wh = max(4 * half, side * d * 0.5, 0.79 * (ymax + 2.0) + 1.0)
        wt = max(half, 2.0)
        for sx, sz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            s.box((wt if sx else ext + 2 * wt, wh, wt if sz else ext + 2 * wt),
                  (sx * (ext + wt), wh, sz * (ext + wt)), static=True)
    return s.arrays(cfg, device)


def pile_chunks(n_chunks: int, scenes: int, n: int, seed: int, cfg,
                device) -> dict:
    """Config 5's stack: `n_chunks` copies of one chunk of `scenes` piles
    of `n` boxes, jittered apart on `device`."""
    rng = np.random.default_rng(seed)
    half, spacing = 0.5, 20.0
    s = _Scene()
    side_sc = int(np.ceil(np.sqrt(scenes)))
    gh = (side_sc * spacing / 2 + 50, 10.0, side_sc * spacing / 2 + 50)
    s.box(gh, (0.0, -gh[1], 0.0), static=True, friction=0.8)
    side = int(np.ceil(n ** (1 / 3)))
    d = 2 * half * 1.15
    for k in range(scenes):
        s.pile(rng, n, side, d, half,
               ox=(k % side_sc - (side_sc - 1) / 2) * spacing,
               oz=(k // side_sc - (side_sc - 1) / 2) * spacing)
    one = s.arrays(cfg, device)
    n_dyn = len(s.rows) - 1
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)

    def uniform(shape, lim):
        u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
        return u * (2 * lim) - lim

    dx = uniform((n_chunks, n_dyn), 0.05)
    dz = uniform((n_chunks, n_dyn), 0.05)
    dq = uniform((n_chunks, n_dyn, 3), 0.02)
    out = {k: v.unsqueeze(0).expand((n_chunks,) + tuple(v.shape)).clone()
           for k, v in one.items()}
    dyn = slice(1, 1 + n_dyn)
    pos, quat = out["bodies.pos"], out["bodies.quat"]
    pos[:, dyn, 0] += dx
    pos[:, dyn, 2] += dz
    quat[:, dyn, 0:3] += dq
    qn = quat[:, dyn]
    norm = torch.sqrt(qn[..., 0] * qn[..., 0] + qn[..., 1] * qn[..., 1]
                      + qn[..., 2] * qn[..., 2] + qn[..., 3] * qn[..., 3])
    quat[:, dyn] = qn / norm[..., None]
    return out
