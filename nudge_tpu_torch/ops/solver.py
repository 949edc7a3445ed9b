"""Warm-started sequential-impulse contact solver over colored manifolds
(PyTorch port of `nudge_tpu.ops.solver`).

Manifolds are greedily colored so that no color touches a dynamic body
twice; the solve runs colors in order (Gauss-Seidel), manifolds of a color
in parallel, and the <= 4 points of a manifold in sequence. Manifolds past
the color budget go to the spill color with 1/degree under-relaxation;
inside the spill color a dynamic body may repeat, and `solve` runs it as
Jacobi exactly as the reference does: every manifold reads the pre-pass
velocities, then the side-a changes are added, then each side-b change is
taken against the velocities that already hold the side-a changes.

`setup_constraints` and `solve` are the plain twins of the CUDA setup and
solve kernels (ops/setup_kernel.py, ops/solver_kernel.py). The claim rounds
of both colorings, fresh and cached, go through `ops/coloring_kernel.py`:
one kernel launch on the card, the reference's loop on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import control
from ..config import CONTACT_POINTS, SimConfig
from ..mathx import cross, dot, orthonormal_basis, quat_rotate, quat_rotate_inv
from ..state import Bodies, ColorCache
from .coloring_kernel import color_rounds, color_rounds_cached
from .coloring_kernel import round_hash  # noqa: F401  (re-exported)
from .contacts import Manifolds


def _i64(x):
    return x.to(torch.int64)


def _inv_inertia_apply(quat, inv_inertia_diag, v):
    """World-space I⁻¹·v for a diagonal body-frame inverse inertia."""
    return quat_rotate(quat, inv_inertia_diag * quat_rotate_inv(quat, v))


@dataclasses.dataclass
class ContactConstraints:
    """Per-manifold-point solve data. P = CONTACT_POINTS."""

    body_a: torch.Tensor     # i32[M]
    body_b: torch.Tensor     # i32[M]
    n: torch.Tensor          # f32[M,3]
    t1: torch.Tensor         # f32[M,3]
    t2: torch.Tensor         # f32[M,3]
    ra: torch.Tensor         # f32[M,P,3]
    rb: torch.Tensor         # f32[M,P,3]
    jna: torch.Tensor        # f32[M,P,3] I⁻¹(r×d) for d in (n, t1, t2)
    jnb: torch.Tensor
    jt1a: torch.Tensor
    jt1b: torch.Tensor
    jt2a: torch.Tensor
    jt2b: torch.Tensor
    mn: torch.Tensor         # f32[M,P] effective masses
    mt1: torch.Tensor
    mt2: torch.Tensor
    bias: torch.Tensor       # f32[M,P] target separating velocity
    pos_bias: torch.Tensor   # f32[M,P] pseudo-velocity target
    pwarm: torch.Tensor      # f32[M,P] warm pseudo impulses
    mu: torch.Tensor         # f32[M]
    im_a: torch.Tensor       # f32[M]
    im_b: torch.Tensor
    relax: torch.Tensor      # f32[M]
    color: torch.Tensor      # i32[M]
    n_colors: torch.Tensor   # i32 colors used
    point_valid: torch.Tensor  # bool[M,P]
    valid: torch.Tensor      # bool[M]
    spill_count: torch.Tensor  # i32
    spill_color: torch.Tensor  # i32 label of the spill color (-1 if none)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _color_sums(idx, vals, n_bins):
    """Per-bin float sums. On the CPU a sequential index_add (the order the
    reference's scatter-add takes); on the GPU one masked reduction per bin,
    which is deterministic where atomics would not be."""
    if vals.device.type == "cpu":
        return torch.zeros(n_bins, dtype=vals.dtype,
                           device=vals.device).index_add_(0, _i64(idx), vals)
    bins = torch.arange(n_bins, device=vals.device)
    return torch.where(idx[None, :] == bins[:, None], vals[None, :],
                       0.0).sum(1)


def order_colors_by_height(color, man: Manifolds, cfg: SimConfig):
    """Relabel colors so the color sweep runs bottom-up (mean contact height
    along -gravity, ascending); empty colors last, parked sentinel fixed."""
    K = cfg.max_colors
    dev = color.device
    g = control.constant(cfg.gravity, torch.float32, dev)
    up = -g / torch.clamp_min(torch.sqrt(dot(g, g)), 1e-9)
    h = man.pos[..., 0] * up[0] + man.pos[..., 1] * up[1] \
        + man.pos[..., 2] * up[2]
    hv = torch.where(man.point_valid, h, 0.0)
    pvf = man.point_valid.to(torch.float32)
    y = (((hv[:, 0] + hv[:, 1]) + hv[:, 2]) + hv[:, 3]) / torch.clamp_min(
        ((pvf[:, 0] + pvf[:, 1]) + pvf[:, 2]) + pvf[:, 3], 1.0)
    ok = man.valid & (color >= 0) & (color < K)
    idx = torch.where(ok, color, K)
    csum = _color_sums(idx, torch.where(ok, y, 0.0), K + 1)
    ccnt = _color_sums(idx, ok.to(torch.float32), K + 1)
    mean = torch.where(ccnt[:K] > 0, csum[:K] / torch.clamp_min(ccnt[:K], 1.0),
                       float("inf"))
    order = torch.sort(mean, stable=True).indices
    rank = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(K, dtype=torch.int32, device=dev)
    rank[K].fill_(K)
    return rank[_i64(torch.clamp(color, 0, K))]


def _spill_relax(man, color, dyn_a, dyn_b, n_bodies, cfg):
    """Park invalid manifolds at color max_colors; send still-uncolored ones
    to the spill color max_colors-1 with 1/degree under-relaxation."""
    spilled = man.valid & (color < 0)
    color = torch.where(spilled, cfg.max_colors - 1, color)
    color = torch.where(man.valid, color, cfg.max_colors).to(torch.int32)
    deg = torch.zeros(n_bodies, dtype=torch.int32, device=color.device)
    deg.index_add_(0, _i64(man.body_a), (spilled & dyn_a).to(torch.int32))
    deg.index_add_(0, _i64(man.body_b), (spilled & dyn_b).to(torch.int32))
    mdeg = torch.maximum(torch.where(dyn_a, deg[man.body_a], 0),
                         torch.where(dyn_b, deg[man.body_b], 0))
    relax = torch.where(
        spilled, 1.0 / torch.clamp_min(mdeg.to(torch.float32), 1.0), 1.0)
    return color, relax, spilled


def _finish(color, spilled, man, relax, cfg):
    color = order_colors_by_height(color, man, cfg)
    n_used = torch.amax(torch.where(man.valid, color, -1)) + 1
    spill_color = torch.amax(torch.where(spilled, color, -1))
    return (color, n_used.to(torch.int32), relax,
            torch.sum(spilled.to(torch.int32)), spill_color.to(torch.int32))


def color_manifolds(man: Manifolds, bodies: Bodies, cfg: SimConfig):
    """Greedy Luby coloring by iterated scatter-min claims
    (`coloring_kernel.color_rounds`), then the spill handling and the
    height relabel. Returns (color[M], n_colors, relax[M], spill_count,
    spill_color)."""
    n_bodies = bodies.pos.shape[0]
    dyn = bodies.inv_mass > 0.0
    dyn_a, dyn_b = dyn[man.body_a], dyn[man.body_b]
    color = color_rounds(man.body_a, man.body_b, man.valid, dyn, n_bodies,
                         cfg.max_colors)
    color, relax, spilled = _spill_relax(man, color, dyn_a, dyn_b, n_bodies,
                                         cfg)
    return _finish(color, spilled, man, relax, cfg)


def color_manifolds_cached(man: Manifolds, bodies: Bodies, cfg: SimConfig,
                           ccache: ColorCache):
    """Incremental coloring: join last frame's colors by (ga, gb), then run
    claim rounds only for new manifolds (`coloring_kernel.
    color_rounds_cached`), in which a manifold takes no color that one of
    its dynamic bodies holds from the cache. On the card the rounds are one
    kernel launch that builds a per-body mask of the cached colors and then
    only reads it; on the CPU the reference's loop with its forbidden-color
    table. Returns ((color, n_colors, relax, spill_count, spill_color),
    ColorCache)."""
    from .cache import _join, join_i32

    n_bodies = bodies.pos.shape[0]
    K = cfg.max_colors
    dyn = bodies.inv_mass > 0.0
    dyn_a, dyn_b = dyn[man.body_a], dyn[man.body_b]
    dev = dyn.device
    m = man.ga.shape[0]
    bits = dyn_a.to(torch.int32) + 2 * dyn_b.to(torch.int32)
    n_gids = cfg.max_boxes + cfg.max_spheres
    if n_gids * n_gids < 2 ** 30 - 1 and K < 255:
        hitp = join_i32(
            ccache.ga * n_gids + ccache.gb,
            (ccache.color + 1) | (ccache.dynbits << 8),
            ccache.valid,
            torch.where(man.valid, man.ga * n_gids + man.gb, 0),
            man.valid)
        hit = (hitp & 255).to(torch.float32)
        cached_bits = hitp >> 8
    else:
        zc = torch.zeros(ccache.ga.shape[0], dtype=torch.int32, device=dev)
        zm = torch.zeros(m, dtype=torch.int32, device=dev)
        payload = torch.stack([ccache.color.to(torch.float32) + 1.0,
                               ccache.dynbits.to(torch.float32),
                               torch.zeros_like(zc, dtype=torch.float32)], -1)
        joined = _join(ccache.ga, ccache.gb, zc, payload, ccache.valid,
                       man.ga, man.gb, zm, man.valid)
        hit = joined[:, 0]
        cached_bits = joined[:, 1].to(torch.int32)
    fresh = (bits & ~cached_bits) == 0
    color = torch.where(man.valid & (hit > 0.5) & fresh,
                        hit.to(torch.int32) - 1, -1).to(torch.int32)

    color = color_rounds_cached(man.body_a, man.body_b, man.valid, dyn, color,
                                n_bodies, K)

    color, relax, spilled = _spill_relax(man, color, dyn_a, dyn_b, n_bodies,
                                         cfg)
    new_cache = ColorCache(
        ga=man.ga, gb=man.gb,
        # stable labels (before the height rank) so joins do not churn
        color=torch.where(man.valid, color, 0),
        # spilled manifolds retry a proper color next frame
        valid=man.valid & ~spilled,
        dynbits=bits,
    )
    return _finish(color, spilled, man, relax, cfg), new_cache


def setup_constraints(bodies: Bodies, man: Manifolds,
                      warm_impulse: torch.Tensor, cfg: SimConfig,
                      coloring=None, pwarm=None):
    """Contact frames, effective masses and biases; warm-start impulses
    projected onto the new frames and applied to body momentum.
    Returns (constraints, bodies, (λn, λt1, λt2) each [M,P])."""
    ba, bb_ = man.body_a, man.body_b
    n = man.normal
    t1, t2 = orthonormal_basis(n)
    ra = man.pos - bodies.pos[ba][:, None, :]
    rb = man.pos - bodies.pos[bb_][:, None, :]
    im_a = bodies.inv_mass[ba]
    im_b = bodies.inv_mass[bb_]
    qa, qb = bodies.quat[ba], bodies.quat[bb_]
    ii_a, ii_b = bodies.inv_inertia[ba], bodies.inv_inertia[bb_]

    def eff(d):
        dP = d[:, None, :]
        rna = cross(ra, dP)
        rnb = cross(rb, dP)
        ja = _inv_inertia_apply(qa[:, None, :], ii_a[:, None, :], rna)
        jb = _inv_inertia_apply(qb[:, None, :], ii_b[:, None, :], rnb)
        k = im_a[:, None] + im_b[:, None] + dot(rna, ja) + dot(rnb, jb)
        m = torch.where(k > 0.0, 1.0 / torch.clamp_min(k, 1e-12), 0.0)
        return ja, jb, m

    jna, jnb, mn = eff(n)
    jt1a, jt1b, mt1 = eff(t1)
    jt2a, jt2b, mt2 = eff(t2)

    bod = cfg.baumgarte / cfg.dt
    baum = torch.clamp_max(bod * torch.clamp_min(man.depth - cfg.slop, 0.0),
                           cfg.max_bias_vel)
    need_vn0 = cfg.restitution > 0.0 or (
        cfg.split_impulse and cfg.deep_bias_gate >= 0.0)
    if need_vn0:
        vrel0 = ((bodies.vel[bb_][:, None] + cross(bodies.angvel[bb_][:, None],
                                                   rb))
                 - (bodies.vel[ba][:, None] + cross(bodies.angvel[ba][:, None],
                                                    ra)))
        vn0 = dot(vrel0, n[:, None])
    if cfg.split_impulse:
        bias = torch.clamp_max(
            bod * torch.clamp_min(man.depth - cfg.deep_bias_depth, 0.0),
            cfg.max_bias_vel)
        if cfg.deep_bias_gate >= 0.0:
            bias = torch.minimum(
                bias, torch.clamp_min(-vn0 - cfg.deep_bias_gate, 0.0))
            bias = torch.maximum(bias, torch.clamp_max(
                bod * torch.clamp_min(man.depth - cfg.deep_bias_ungated_depth,
                                      0.0),
                cfg.deep_bias_ungated_vel))
        pos_bias = torch.clamp_max(
            bod * torch.clamp_min(man.depth - cfg.slop, 0.0),
            cfg.max_pseudo_vel)
    else:
        bias = baum
        pos_bias = torch.zeros_like(baum)
    if cfg.restitution > 0.0:
        bias = torch.maximum(
            bias, cfg.restitution * torch.clamp_min(-vn0 - 1.0, 0.0))

    if coloring is None:
        coloring = color_manifolds(man, bodies, cfg)
    color, n_colors, relax, spill, spill_color = coloring

    if pwarm is None or not (cfg.split_impulse and cfg.warm_start):
        pwarm = torch.zeros_like(mn)
    con = ContactConstraints(
        body_a=ba, body_b=bb_, n=n, t1=t1, t2=t2, ra=ra, rb=rb,
        jna=jna, jnb=jnb, jt1a=jt1a, jt1b=jt1b, jt2a=jt2a, jt2b=jt2b,
        mn=mn, mt1=mt1, mt2=mt2, bias=bias, pos_bias=pos_bias,
        pwarm=torch.where(man.point_valid, pwarm, 0.0),
        mu=man.friction, im_a=im_a, im_b=im_b, relax=relax, color=color,
        n_colors=n_colors, point_valid=man.point_valid, valid=man.valid,
        spill_count=spill, spill_color=spill_color,
    )

    pv = man.point_valid
    if cfg.warm_start:
        acc_n = torch.clamp_min(dot(warm_impulse, n[:, None]), 0.0)
        bound = man.friction[:, None] * acc_n
        acc_t1 = torch.minimum(torch.maximum(dot(warm_impulse, t1[:, None]),
                                             -bound), bound)
        acc_t2 = torch.minimum(torch.maximum(dot(warm_impulse, t2[:, None]),
                                             -bound), bound)
        acc_n = torch.where(pv, acc_n, 0.0)
        acc_t1 = torch.where(pv, acc_t1, 0.0)
        acc_t2 = torch.where(pv, acc_t2, 0.0)
    else:
        acc_n = torch.zeros_like(mn)
        acc_t1 = torch.zeros_like(mn)
        acc_t2 = torch.zeros_like(mn)

    bodies = _apply_manifold_impulses(bodies, con, acc_n, acc_t1, acc_t2)
    return con, bodies, (acc_n, acc_t1, acc_t2)


def _sum_points(x):
    """Σ over the point axis (dim 1), in point order."""
    s = x[:, 0]
    for p in range(1, x.shape[1]):
        s = s + x[:, p]
    return s


def _apply_manifold_impulses(bodies, con, ln, lt1, lt2):
    """Add each manifold's summed point impulses to its bodies (side a then
    side b, manifold order)."""
    pv = con.point_valid
    ln = torch.where(pv, ln, 0.0)
    lt1 = torch.where(pv, lt1, 0.0)
    lt2 = torch.where(pv, lt2, 0.0)
    P = (_sum_points(ln)[:, None] * con.n + _sum_points(lt1)[:, None] * con.t1
         + _sum_points(lt2)[:, None] * con.t2)
    dw_a = _sum_points(ln[..., None] * con.jna + lt1[..., None] * con.jt1a
                       + lt2[..., None] * con.jt2a)
    dw_b = _sum_points(ln[..., None] * con.jnb + lt1[..., None] * con.jt1b
                       + lt2[..., None] * con.jt2b)
    a, b = _i64(con.body_a), _i64(con.body_b)
    vel = bodies.vel.index_add(0, a, -P * con.im_a[:, None])
    vel = vel.index_add(0, b, P * con.im_b[:, None])
    angvel = bodies.angvel.index_add(0, a, -dw_a)
    angvel = angvel.index_add(0, b, dw_b)
    return bodies.replace(vel=vel, angvel=angvel)


def pseudo_warm_start(con: ContactConstraints, n_bodies: int):
    """Pseudo velocities consistent with the warm pseudo accumulators
    (pacc0 = pwarm on valid points): the split-impulse counterpart of the
    momentum warm start. Returns (pseudo_vel, pseudo_angvel) [N,3]."""
    pacc0 = torch.where(con.point_valid, con.pwarm, 0.0)
    zero = torch.zeros((n_bodies, 3), dtype=torch.float32,
                       device=pacc0.device)
    Pp = _sum_points(pacc0)[:, None] * con.n
    pdw_a = _sum_points(pacc0[..., None] * con.jna)
    pdw_b = _sum_points(pacc0[..., None] * con.jnb)
    a, b = _i64(con.body_a), _i64(con.body_b)
    pvel0 = zero.index_add(0, a, -Pp * con.im_a[:, None]).index_add(
        0, b, Pp * con.im_b[:, None])
    pang0 = zero.index_add(0, a, -pdw_a).index_add(0, b, pdw_b)
    return pvel0, pang0


def solve(bodies: Bodies, con: ContactConstraints, acc, cfg: SimConfig):
    """Iterated impulse solve: solver_iters sweeps over the colors in order.
    Under split impulse a pseudo-velocity normal solve runs in the same
    sweeps against `pos_bias`, warm-started from `con.pwarm`.
    Returns (bodies, acc, (pseudo_vel, pseudo_angvel), pseudo_acc[M,P])."""
    n = bodies.pos.shape[0]
    if cfg.split_impulse:
        pseudo0 = pseudo_warm_start(con, n)
    else:
        z = torch.zeros_like(bodies.vel)
        pseudo0 = (z, z)
    vel, angvel, acc, pseudo, pacc = solve_from(
        bodies.vel, bodies.angvel, con, acc, pseudo0, cfg)
    return bodies.replace(vel=vel, angvel=angvel), acc, pseudo, pacc


def solve_from(vel, angvel, con: ContactConstraints, acc, pseudo0,
               cfg: SimConfig):
    """The sweeps of `solve` from given velocities and initial pseudo
    velocities (the setup kernel produces both, warm starts applied).
    Returns (vel, angvel, acc, (pseudo_vel, pseudo_angvel), pseudo_acc)."""
    acc_n, acc_t1, acc_t2 = acc
    if cfg.differentiable:
        n_colors = cfg.max_colors
    else:
        n_colors = max(int(con.n_colors), 1)
    split = cfg.split_impulse
    pfric = split and cfg.pseudo_friction
    a, b = _i64(con.body_a), _i64(con.body_b)
    pvel, pang = pseudo0
    pacc = torch.where(con.point_valid, con.pwarm, 0.0)
    pvf = con.point_valid.to(torch.float32)

    for i in range(cfg.solver_iters * n_colors):
        c = i % n_colors
        mask = con.valid & (con.color == c)
        relax = torch.where(mask, con.relax, 0.0)
        va, vb, wa, wb = vel[a], vel[b], angvel[a], angvel[b]
        pva, pvb, pwa, pwb = pvel[a], pvel[b], pang[a], pang[b]
        dlns, dlt1s, dlt2s, dlps = [], [], [], []
        for p in range(CONTACT_POINTS):
            pm = relax * pvf[:, p]
            vrel = vb + cross(wb, con.rb[:, p]) - va - cross(wa, con.ra[:, p])
            vn = dot(vrel, con.n)
            dln = (con.bias[:, p] - vn) * con.mn[:, p]
            new_n = torch.clamp_min(acc_n[:, p] + dln, 0.0)
            dln = pm * (new_n - acc_n[:, p])
            bound = con.mu * (acc_n[:, p] + dln
                              + (pacc[:, p] if pfric else 0.0))
            vt1 = dot(vrel, con.t1)
            new_t1 = torch.minimum(torch.maximum(
                acc_t1[:, p] - vt1 * con.mt1[:, p], -bound), bound)
            dlt1 = pm * (new_t1 - acc_t1[:, p])
            vt2 = dot(vrel, con.t2)
            new_t2 = torch.minimum(torch.maximum(
                acc_t2[:, p] - vt2 * con.mt2[:, p], -bound), bound)
            dlt2 = pm * (new_t2 - acc_t2[:, p])

            Pimp = (dln[:, None] * con.n + dlt1[:, None] * con.t1
                    + dlt2[:, None] * con.t2)
            va = va - Pimp * con.im_a[:, None]
            vb = vb + Pimp * con.im_b[:, None]
            wa = wa - (dln[:, None] * con.jna[:, p]
                       + dlt1[:, None] * con.jt1a[:, p]
                       + dlt2[:, None] * con.jt2a[:, p])
            wb = wb + (dln[:, None] * con.jnb[:, p]
                       + dlt1[:, None] * con.jt1b[:, p]
                       + dlt2[:, None] * con.jt2b[:, p])
            dlns.append(dln)
            dlt1s.append(dlt1)
            dlt2s.append(dlt2)

            if split:
                pvrel = (pvb + cross(pwb, con.rb[:, p])
                         - pva - cross(pwa, con.ra[:, p]))
                pvn = dot(pvrel, con.n)
                dlp = (con.pos_bias[:, p] - pvn) * con.mn[:, p]
                new_p = torch.clamp_min(pacc[:, p] + dlp, 0.0)
                dlp = pm * (new_p - pacc[:, p])
                dlps.append(pacc[:, p] + dlp)
                Pp = dlp[:, None] * con.n
                pva = pva - Pp * con.im_a[:, None]
                pvb = pvb + Pp * con.im_b[:, None]
                pwa = pwa - dlp[:, None] * con.jna[:, p]
                pwb = pwb + dlp[:, None] * con.jnb[:, p]

        acc_n = acc_n + torch.stack(dlns, 1)
        acc_t1 = acc_t1 + torch.stack(dlt1s, 1)
        acc_t2 = acc_t2 + torch.stack(dlt2s, 1)
        if split:
            pacc = torch.stack(dlps, 1)

        # one scatter per manifold side: the net velocity change; side b
        # reads the velocities that already hold side a's changes
        mcol = mask[:, None]
        vel = vel.index_add(0, a, torch.where(mcol, va - vel[a], 0.0))
        vel = vel.index_add(0, b, torch.where(mcol, vb - vel[b], 0.0))
        angvel = angvel.index_add(0, a, torch.where(mcol, wa - angvel[a], 0.0))
        angvel = angvel.index_add(0, b, torch.where(mcol, wb - angvel[b], 0.0))
        if split:
            pvel = pvel.index_add(0, a, torch.where(mcol, pva - pvel[a], 0.0))
            pvel = pvel.index_add(0, b, torch.where(mcol, pvb - pvel[b], 0.0))
            pang = pang.index_add(0, a, torch.where(mcol, pwa - pang[a], 0.0))
            pang = pang.index_add(0, b, torch.where(mcol, pwb - pang[b], 0.0))
    return vel, angvel, (acc_n, acc_t1, acc_t2), (pvel, pang), pacc


def accumulated_world_impulse(con: ContactConstraints, acc) -> torch.Tensor:
    """Accumulated (λn, λt1, λt2) as world impulse vectors f32[M,P,3]."""
    acc_n, acc_t1, acc_t2 = acc
    return (acc_n[..., None] * con.n[:, None]
            + acc_t1[..., None] * con.t1[:, None]
            + acc_t2[..., None] * con.t2[:, None])
