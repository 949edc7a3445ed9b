"""The plain versions behind the backward kernels, on the CPU: autograd of
each kernel's twin (the narrowphases, setup, the solve) against
torch.autograd.gradcheck's central differences in float64 on tiny scenes,
and the fixed-order segment sum that adds the kernels' adjoint rows per
body and per collider against a plain sum. The kernels themselves are
held to these plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py phase 18); the tests marked gpu below hold setup's and the
solve's backward kernels to them case by case (split impulse on and off,
pseudo friction off, no warm start, a forced spill color, manifolds with
fewer than 4 valid points, friction clamps at their bound; a static side
in every case), also their mass instances (the inverse masses', inertias'
and friction's adjoints), and the narrowphase kernels' shape instances
against autograd of the joined twins. They skip without a card; on one,
with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_backward.py
"""

import pytest
import torch

from nudge_tpu_torch import engine, scenes
from nudge_tpu_torch.mathx import quat_from_axis_angle
from nudge_tpu_torch.ops import broadphase, cache, contacts, integrate
from nudge_tpu_torch.ops import narrowphase, narrowphase_1pt, narrowphase_kernel
from nudge_tpu_torch.ops import segment, setup_kernel, solver, solver_kernel
from nudge_tpu_torch.ops.broadphase import CandidatePairs
from nudge_tpu_torch.state import flatten

f64 = torch.float64


def _gradcheck(fn, inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def _q(axis, angle):
    return quat_from_axis_angle(torch.tensor(axis), torch.tensor(angle))


def _pairs(a, b, valid):
    return CandidatePairs(a=torch.tensor(a, dtype=torch.int32),
                          b=torch.tensor(b, dtype=torch.int32),
                          valid=torch.tensor(valid, dtype=torch.bool),
                          count=torch.tensor(len(a)))


def test_segment_sum_is_the_plain_sum():
    """entries' stable sort keeps each key's rows in source order, and the
    segment sum of the rows equals index_add in that order, bit for bit,
    with and without a starting value; rows without `take` add nothing."""
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 9, (40,), generator=g).to(torch.int32)
    take = torch.rand(40, generator=g) > 0.25
    vals = torch.randn((40, 5), generator=g)
    k, perm = segment.entries(keys, take)
    assert torch.equal(k[k < 9], torch.sort(keys[take]).values)
    for key in range(9):
        rows = perm[k == key]
        assert torch.equal(rows, torch.sort(rows).values)   # source order
    init = torch.randn((9, 5), generator=g)
    for start in (None, init):
        got = segment.segment_sum(k, perm, vals, 9, start)
        want = (torch.zeros((9, 5)) if start is None else start.clone())
        for e in range(40):            # the plain sum, in source order
            if take[e]:
                want[keys[e]] += vals[e]
        assert torch.equal(got, want)


def test_collider_entries_sum_each_pairs_sides():
    """The narrowphase backward's bookkeeping: row 2r + side of pair row r
    (box-box, box-sphere, sphere-sphere rows in narrowphase_all's order)
    adds into that side's collider (a box by its index, sphere i as nb +
    i), live pairs only."""
    nb = 3
    bb = _pairs([0, 1, 2], [1, 2, 0], [True, True, False])
    bs = _pairs([2, 0], [1, 0], [True, True])
    ss = _pairs([0], [1], [True])
    keys, perm = contacts.collider_entries(bb, bs, ss, nb)
    n = 6
    rows = torch.zeros((2 * n, 7))
    rows[:, 0] = torch.arange(2 * n, dtype=torch.float32)
    got = segment.segment_sum(keys, perm, rows, nb + 2)[:, 0]
    # each collider adds the rows of its pairs' sides: row 2r is side a of
    # pair row r, 2r + 1 side b
    want = torch.zeros(nb + 2)
    sides = [(0, 1), (1, 2), (2, 0), (2, nb + 1), (0, nb + 0),
             (nb + 0, nb + 1)]
    live = [True, True, False, True, True, True]
    for r, (ca, cb) in enumerate(sides):
        if live[r]:
            want[ca] += 2 * r
            want[cb] += 2 * r + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("spheres", [False, True])
def test_dead_pair_rows_are_never_read(spheres):
    """The narrowphase backward kernels write no adjoint row of a dead pair
    slot: collider_entries gives a dead pair's rows INT32_MAX, so the
    per-collider sums are the same, bit for bit, whatever such a row holds
    (NaN, huge values, infinities) as with zeros. Without sphere pairs the
    entries come from the box-box pairs alone, equal to the joined ones."""
    nb, ns = 4, 2
    bb = _pairs([0, 1, 2, 3, 0], [1, 2, 3, 0, 2],
                [True, False, True, False, True])
    if spheres:
        bs = _pairs([2, 3], [0, 1], [False, True])
        ss = _pairs([0], [1], [False])
    else:
        bs = ss = _pairs([], [], [])
    keys, perm = contacts.collider_entries(bb, bs, ss, nb)
    joined = segment.entries(
        torch.stack([torch.cat([bb.a, bs.a, nb + ss.a]),
                     torch.cat([bb.b, nb + bs.b, nb + ss.b])], 1),
        torch.cat([bb.valid, bs.valid, ss.valid])[:, None].expand(-1, 2))
    assert torch.equal(keys, joined[0]) and torch.equal(perm, joined[1])
    live = torch.cat([bb.valid, bs.valid, ss.valid])
    rows = torch.randn((live.shape[0], 14),
                       generator=torch.Generator().manual_seed(1))
    clean = torch.where(live[:, None], rows, 0.0)
    want = segment.segment_sum(keys, perm, clean.reshape(-1, 7), nb + ns)
    for garbage in (float("nan"), 1e30, -float("inf")):
        dirty = torch.where(live[:, None], rows, garbage)
        got = segment.segment_sum(keys, perm, dirty.reshape(-1, 7), nb + ns)
        assert torch.equal(got, want), garbage


# Box pairs at the edge case's clamp corner, in float64: box A axis-aligned
# at the origin, B turned by a quaternion of dyadic components (not unit:
# its matrix has R[2][2] = 0 exactly, so the edge pair (2, 2) has b_dd = 0
# and s_par = min(max(r12[2], -ha_2), ha_2)), placed so that r12[2] is
# exactly -ha_2 or +ha_2 (found by a search over B's z; A's z edge then
# ends at the closest point).
EDGE_TIES = {
    "at -ha": ([0.5, 0.5, 0.25, 0.625], [0.3, 1.0, -0.3875]),
    "at +ha": ([-0.5, 0.5, -0.25, 0.625], [-0.3, 1.0, 0.3875]),
}


@pytest.mark.parametrize("case", list(EDGE_TIES))
def test_box_box_twin_gradient_at_the_edge_clamp(case):
    """The corner rule the box-box backward kernel copies: at s_par =
    ±ha_i exactly, torch.maximum / torch.minimum give the clamped
    parameter half of its gradient, so the twin's gradient is the mean of
    the two one-sided gradients (B moved along z by ±1e-7: clamped on one
    side, free on the other), which differ."""
    q, p = EDGE_TIES[case]
    ha = torch.tensor([[0.5, 0.5, 0.5]], dtype=f64)
    hb = torch.tensor([[0.4, 0.3, 0.5]], dtype=f64)
    qa = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=f64)
    pa = torch.zeros((1, 3), dtype=f64)
    qb = torch.tensor([q], dtype=f64)
    g = torch.Generator().manual_seed(3)
    w = [torch.randn(s, generator=g, dtype=f64) for s in ((1, 4, 3), (1, 4),
                                                          (1, 3))]

    def grad(dz):
        pb = torch.tensor([p], dtype=f64)
        pb[0, 2] += dz
        xs = [x.clone().requires_grad_() for x in (qa, pa, qb, pb)]
        o = narrowphase.box_box(ha, xs[0], xs[1], hb, xs[2], xs[3])
        # the edge case, edge pair (2, 2), touching
        assert (int(o["feat"][0, 0]) - 1024) // 16 == 2 * 3 + 2
        assert bool(o["valid"][0, 0])
        loss = sum((x * y).sum() for x, y in
                   zip((o["pos"], o["depth"], o["normal"]), w))
        return torch.cat([t.reshape(-1) for t in
                          torch.autograd.grad(loss, xs)])

    at, up, down = grad(0.0), grad(1e-7), grad(-1e-7)
    big = float(at.abs().max())
    assert float((up - down).abs().max()) > 1e-2 * big
    assert float((at - 0.5 * (up + down)).abs().max()) < 1e-5 * big


def test_box_sphere_twin_gradient_at_its_corners():
    """The corner rules the one-point backward kernel copies, on the twin
    in float64 with the box axis-aligned at the origin: a sphere centre on
    the x face plane (ctr_x = h_x) and outside in y takes half of the
    clamp's gradient in x (minimum's tie) and none in y (clamped); a
    centre inside with ctr_k = 0 on the least-penetrated face k gets no
    depth gradient along k (torch.abs's 0 at 0)."""
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=f64)
    pa = torch.zeros((1, 3), dtype=f64)

    def jac(h, r, pb):
        def fn(pb):
            o = narrowphase.box_sphere(torch.tensor([h], dtype=f64), q, pa,
                                       torch.tensor([r], dtype=f64), pb)
            return o["pos"][0], o["depth"], o["normal"][0]
        return torch.autograd.functional.jacobian(
            fn, torch.tensor([pb], dtype=f64))

    # on the face plane: cl = (0.5 [tie], 0.5 [clamped], 0.1), dl = (0,
    # 0.3, 0), dist 0.3, normal (0, 1, 0)
    d_pos, d_depth, d_normal = jac([0.5, 0.5, 0.5], 0.4, [0.5, 0.8, 0.1])
    eye = torch.eye(3, dtype=f64)
    assert torch.allclose(d_pos[:, 0], torch.diag(torch.tensor(
        [0.5, 0.0, 1.0], dtype=f64)), atol=1e-12)
    assert torch.allclose(d_depth[0, 0], -eye[1], atol=1e-12)
    assert torch.allclose(d_normal[:, 0], torch.diag(torch.tensor(
        [0.5 / 0.3, 0.0, 0.0], dtype=f64)), atol=1e-12)
    # inside, on the least-penetrated face's centre plane: fp = (0.2, 0.4,
    # 0.4), k = 0, ctr_0 = 0
    d_pos, d_depth, d_normal = jac([0.2, 0.5, 0.5], 0.3, [0.0, 0.1, -0.1])
    assert torch.equal(d_depth[0, 0], torch.zeros(3, dtype=f64))
    assert torch.allclose(d_pos[:, 0], torch.diag(torch.tensor(
        [0.0, 1.0, 1.0], dtype=f64)), atol=1e-12)
    assert torch.equal(d_normal[:, 0], torch.zeros((3, 3), dtype=f64))


def _box_pairs():
    """Two box pairs in float64: a tilted box resting on a face (face
    case) and one crossing an edge of the other (edge case)."""
    ha = torch.tensor([[0.5, 0.5, 0.5], [0.5, 0.4, 0.6]], dtype=f64)
    hb = torch.tensor([[0.4, 0.3, 0.5], [0.5, 0.5, 0.5]], dtype=f64)
    qa = torch.stack([_q([0.0, 1.0, 0.0], 0.1),
                      _q([1.0, 0.0, 0.0], 0.0)]).to(f64)
    qb = torch.stack([_q([0.3, 1.0, 0.2], 0.3),
                      _q([1.0, 0.0, 1.0], 0.7)]).to(f64)
    pa = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype=f64)
    pb = torch.tensor([[0.1, 0.78, -0.05], [0.02, 0.95, 0.6]], dtype=f64)
    return ha, qa, pa, hb, qb, pb


def test_box_box_twin_backward_matches_central_differences():
    ha, qa, pa, hb, qb, pb = _box_pairs()
    out = narrowphase.box_box(ha, qa, pa, hb, qb, pb)
    # one face-case and one edge-case pair, both touching
    assert out["feat"][0, 0] < 1024 <= out["feat"][1, 0]
    assert bool(out["valid"].any(1).all())

    def fn(qa, pa, qb, pb):
        o = narrowphase.box_box(ha, qa, pa, hb, qb, pb)
        return o["pos"], o["depth"], o["normal"]

    _gradcheck(fn, [x.clone().requires_grad_() for x in (qa, pa, qb, pb)])


def test_one_point_twin_backward_matches_central_differences():
    h = torch.tensor([[0.5, 0.4, 0.6], [0.5, 0.5, 0.5]], dtype=f64)
    q = torch.stack([_q([0.2, 1.0, 0.1], 0.4),
                     _q([1.0, 0.0, 0.0], 0.2)]).to(f64)
    pa = torch.zeros((2, 3), dtype=f64)
    r = torch.tensor([0.3, 0.4], dtype=f64)
    # one centre outside the box, one inside it
    pb = torch.tensor([[0.3, 0.65, 0.1], [0.1, 0.2, -0.1]], dtype=f64)

    def box_sphere(q, pa, pb):
        o = narrowphase.box_sphere(h, q, pa, r, pb)
        return o["pos"], o["depth"], o["normal"]

    def sphere_sphere(pa, pb):
        o = narrowphase.sphere_sphere(r, pa, r.flip(0), pb)
        return o["pos"], o["depth"], o["normal"]

    _gradcheck(box_sphere, [x.clone().requires_grad_() for x in (q, pa, pb)])
    _gradcheck(sphere_sphere, [pa.clone().requires_grad_(),
                               pb.clone().requires_grad_()])


def test_box_box_twin_shape_backward_matches_central_differences():
    """The box-box twin's gradient with respect to both boxes' half
    extents (the face case's reference rectangle, depth and incident quad;
    the edge case's edges, their clamps and separation) and of the pair
    friction with respect to both frictions."""
    ha, qa, pa, hb, qb, pb = _box_pairs()

    def fn(ha, hb):
        o = narrowphase.box_box(ha, qa, pa, hb, qb, pb)
        return o["pos"], o["depth"], o["normal"]

    _gradcheck(fn, [ha.clone().requires_grad_(), hb.clone().requires_grad_()])
    fr = torch.tensor([0.3, 0.8], dtype=f64)
    _gradcheck(narrowphase_kernel.combine_friction,
               [fr.clone().requires_grad_(), fr.flip(0).requires_grad_()])


def test_one_point_twin_shape_backward_matches_central_differences():
    """The one-point twins' gradients with respect to the box's half
    extents (a centre outside the box: the clamp's bounds; inside: the
    least-penetrated face) and the radii."""
    h = torch.tensor([[0.5, 0.4, 0.6], [0.5, 0.5, 0.5]], dtype=f64)
    q = torch.stack([_q([0.2, 1.0, 0.1], 0.4),
                     _q([1.0, 0.0, 0.0], 0.2)]).to(f64)
    pa = torch.zeros((2, 3), dtype=f64)
    r = torch.tensor([0.3, 0.4], dtype=f64)
    pb = torch.tensor([[0.3, 0.65, 0.1], [0.1, 0.2, -0.1]], dtype=f64)
    qs = torch.tensor([[0.3, 0.2, 0.1], [0.0, 0.5, 0.2]], dtype=f64)

    def box_sphere(h, r):
        o = narrowphase.box_sphere(h, q, pa, r, pb)
        return o["pos"], o["depth"], o["normal"]

    def sphere_sphere(ra, rb):
        o = narrowphase.sphere_sphere(ra, pa, rb, qs)
        return o["pos"], o["depth"], o["normal"]

    _gradcheck(box_sphere, [h.clone().requires_grad_(),
                            r.clone().requires_grad_()])
    _gradcheck(sphere_sphere, [r.clone().requires_grad_(),
                               r.flip(0).requires_grad_()])


def _step_inputs(n=6, steps=25, **cfg_kw):
    """What a step of a small pressed pile hands setup and the solve."""
    b = scenes.scene_pile(n, seed=2)
    cfg = b.auto_config(**cfg_kw)
    st, _ = engine.simulate(b.finalize(cfg, device="cpu"), cfg, steps)
    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = contacts.collide(st, cfg)
    warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
    col, _ = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    assert int(man.valid.sum()) >= 2
    return cfg, bodies, man, warm, pwarm, col


def _valid_only(cfg, bodies, man, warm, pwarm, col):
    """The valid manifolds only (no slot of constants), in float64, with
    nonzero warm starts off the clamps' corners."""
    keep = man.valid
    man = man.replace(**{f: getattr(man, f)[keep] for f in (
        "body_a", "body_b", "ga", "gb", "normal", "friction", "pos", "depth",
        "feat", "point_valid", "valid")})
    bodies = bodies.replace(**{f: getattr(bodies, f).to(f64) for f in (
        "pos", "quat", "vel", "angvel", "inv_mass", "inv_inertia")})
    man = man.replace(normal=man.normal.to(f64), pos=man.pos.to(f64),
                      depth=man.depth.to(f64), friction=man.friction.to(f64))
    col = (col[0][keep], col[1], col[2][keep].to(f64), col[3], col[4])
    return (cfg, bodies, man, (warm[keep] + 0.05).to(f64),
            (pwarm[keep] + 0.05).to(f64), col)


def test_setup_twin_backward_matches_central_differences():
    """setup_plain's inputs with a gradient (setup_kernel.GRAD_INPUTS) in
    float64, with restitution on (the relative velocity enters the bias).
    The split-impulse part builds its pseudo velocities in float32
    (solver.pseudo_warm_start), so it is checked by
    test_setup_twin_split_backward_matches_central_differences."""
    cfg, bodies, man, warm, pwarm, col = _valid_only(*_step_inputs(
        split_impulse=False, restitution=0.4))

    def fn(pos, quat, vel, angvel, normal, mpos, depth, w):
        b2 = bodies.replace(pos=pos, quat=quat, vel=vel, angvel=angvel)
        m2 = man.replace(normal=normal, pos=mpos, depth=depth)
        con, velw, acc = setup_kernel.setup_plain(b2, m2, w, cfg, col)
        return (con.ra, con.jna, con.jt1b, con.mn, con.mt2, con.bias, con.t1,
                velw, *acc)

    ins = [bodies.pos, bodies.quat, bodies.vel, bodies.angvel, man.normal,
           man.pos, man.depth, warm]
    _gradcheck(fn, [x.clone().requires_grad_() for x in ins])


def test_setup_twin_split_backward_matches_central_differences():
    """The split-impulse setup's constraint part (`solver.setup_constraints`:
    the deep-bias gate on the approach velocity, its ungated floor, the
    pseudo bias, the warm pseudo impulses) in float64. What setup_plain adds
    under split impulse, `solver.pseudo_warm_start`, is linear in these
    outputs and sums them into float32 velocities, so its gradient is
    autograd's through index_add."""
    cfg, bodies, man, warm, pwarm, col = _valid_only(*_step_inputs())
    assert cfg.split_impulse and cfg.deep_bias_gate >= 0.0

    def fn(pos, quat, vel, normal, mpos, depth, w, pw):
        b2 = bodies.replace(pos=pos, quat=quat, vel=vel)
        m2 = man.replace(normal=normal, pos=mpos, depth=depth)
        con, b3, acc = solver.setup_constraints(b2, m2, w, cfg, col, pw)
        return (con.bias, con.pos_bias, con.pwarm, con.jnb, b3.vel,
                b3.angvel, *acc)

    ins = [bodies.pos, bodies.quat, bodies.vel, man.normal, man.pos,
           man.depth, warm, pwarm]
    _gradcheck(fn, [x.clone().requires_grad_() for x in ins])


@pytest.mark.parametrize("split", [False, True])
def test_setup_twin_mass_backward_matches_central_differences(split):
    """setup_plain's gradient with respect to MASS_INPUTS (the bodies'
    inverse masses and inertias, the static ground's too, and the
    manifolds' friction) in float64: through the im rows, the effective
    masses, the angular responses, the warm start's impulses and its
    friction bound. With split impulse on, the pseudo warm start's
    velocities are float32 (see the split test above), so only the
    constraint part is checked there."""
    kw = dict(split_impulse=False, restitution=0.4) if not split else {}
    cfg, bodies, man, warm, pwarm, col = _valid_only(*_step_inputs(**kw))
    assert bool((bodies.inv_mass == 0).any())

    def fn(inv_mass, inv_inertia, friction):
        b2 = bodies.replace(inv_mass=inv_mass, inv_inertia=inv_inertia)
        m2 = man.replace(friction=friction)
        if split:
            con, b3, acc = solver.setup_constraints(b2, m2, warm, cfg, col,
                                                    pwarm)
            return (con.mn, con.jt1a, con.jnb, con.im_a, con.mu, b3.vel,
                    b3.angvel, *acc)
        con, velw, acc = setup_kernel.setup_plain(b2, m2, warm, cfg, col)
        return (con.mn, con.mt1, con.jna, con.jt2b, con.im_b, con.mu, velw,
                *acc)

    _gradcheck(fn, [x.clone().requires_grad_() for x in
                    (bodies.inv_mass, bodies.inv_inertia, man.friction)])


def test_solve_twin_backward_matches_central_differences():
    """solve_plain in float64 over 2 sweeps of the valid manifolds: its
    adjoints of the input velocities, the accumulators and the constraint
    rows of each kind that the solve reads, against central differences."""
    cfg, bodies, man, warm, pwarm, col = _valid_only(
        *_step_inputs(solver_iters=2))
    con, velw, acc = setup_kernel.setup_plain(
        bodies.replace(**{f: getattr(bodies, f).float() for f in (
            "pos", "quat", "vel", "angvel", "inv_mass", "inv_inertia")}),
        man.replace(normal=man.normal.float(), pos=man.pos.float(),
                    depth=man.depth.float(), friction=man.friction.float()),
        warm.float(), cfg, (col[0], col[1], col[2].float(), col[3], col[4]),
        pwarm.float())
    con = con.replace(**{f: getattr(con, f).to(f64) for f, _ in
                         solver_kernel.ROW_FIELDS
                         if getattr(con, f).is_floating_point()})
    fields = ("n", "t1", "ra", "rb", "jna", "jt2b", "mn", "mt1", "bias",
              "pos_bias", "pwarm", "mu")

    def fn(velw, a0, a1, *xs):
        c = con.replace(**dict(zip(fields, xs)))
        v, a, p = solver_kernel.solve_plain(velw, c, (a0, a1,
                                                      acc[2].to(f64)), cfg)
        return (v, *a, p)

    ins = [velw.to(f64), acc[0].to(f64), acc[1].to(f64)] \
        + [getattr(con, f) for f in fields]
    _gradcheck(fn, [x.clone().requires_grad_() for x in ins])


def test_solve_twin_mass_rows_backward_matches_central_differences():
    """solve_plain in float64 over 2 sweeps: its adjoints of the im_a and
    im_b rows (a static side's too, whose inverse mass is 0) and of the j
    rows, against central differences."""
    cfg, bodies, man, warm, pwarm, col = _valid_only(
        *_step_inputs(solver_iters=2))
    con, velw, acc = setup_kernel.setup_plain(
        bodies.replace(**{f: getattr(bodies, f).float() for f in (
            "pos", "quat", "vel", "angvel", "inv_mass", "inv_inertia")}),
        man.replace(normal=man.normal.float(), pos=man.pos.float(),
                    depth=man.depth.float(), friction=man.friction.float()),
        warm.float(), cfg, (col[0], col[1], col[2].float(), col[3], col[4]),
        pwarm.float())
    con = con.replace(**{f: getattr(con, f).to(f64) for f, _ in
                         solver_kernel.ROW_FIELDS
                         if getattr(con, f).is_floating_point()})
    assert bool((con.im_a == 0).any() | (con.im_b == 0).any())
    fields = ("im_a", "im_b", "jna", "jnb", "jt1a", "jt2b")

    def fn(*xs):
        c = con.replace(**dict(zip(fields, xs)))
        v, a, p = solver_kernel.solve_plain(
            velw.to(f64), c, tuple(x.to(f64) for x in acc), cfg)
        return (v, *a, p)

    _gradcheck(fn, [getattr(con, f).clone().requires_grad_()
                    for f in fields])


def test_backward_wrappers_refuse_cpu_tensors():
    """A backward wrapper launches its kernel on CUDA tensors or raises: on
    CPU tensors it raises (the plain versions are autograd of the twins)."""
    b = scenes.scene_pile(6, sphere_frac=0.5, seed=2)
    bcfg = b.auto_config()
    st = b.finalize(bcfg, device="cpu")
    wc = broadphase.world_colliders(st)
    bb, bs, ss = broadphase.allpairs_broadphase(st, wc, bcfg)
    with pytest.raises(ValueError):
        narrowphase_kernel.box_box_adjoint_cuda(st.boxes, wc, bb, None, None,
                                                None)
    with pytest.raises(ValueError):
        narrowphase_1pt.pairs_1pt_adjoint_cuda(st.boxes, st.spheres, wc, bs,
                                               ss, None, None, None)
    keys = torch.zeros(3, dtype=torch.int32)
    perm = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        segment.segment_sum_cuda(keys, perm, torch.zeros((3, 2)), 1)
    cfg, bodies, man, warm, pwarm, col = _step_inputs()
    order = solver_kernel.color_order(man, bodies, col, cfg)
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    with pytest.raises(ValueError):
        setup_kernel.setup_backward_cuda(
            bodies, man, warm, pwarm, col[2], order, cfg, True,
            torch.zeros((solver_kernel.ROWS, m)),
            torch.zeros((solver_kernel.WORK_ROWS, m)), torch.zeros((2, m, 3)),
            torch.zeros((n, solver_kernel.VEL_ROW)))


def test_saved_trees_rebuild_and_guard_in_place_writes():
    """The Functions save setup's and the narrowphase's input trees through
    `state.flatten` and `save_for_backward`: the rebuilt tree holds the
    same tensors in the same structure, and a write into a saved tensor
    between the forward and the backward raises instead of giving a
    silently wrong gradient."""
    cfg, bodies, man, warm, pwarm, col = _step_inputs()
    order = solver_kernel.color_order(man, bodies, col, cfg)
    tree = (bodies, man, warm, pwarm, col[2], order)
    leaves, rebuild = flatten(tree)
    again = rebuild(leaves)
    assert [type(x) for x in again] == [type(x) for x in tree]
    assert len(flatten(again)[0]) == len(leaves)
    assert all(x is y for x, y in zip(flatten(again)[0], leaves))

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, bodies):
            saved, ctx.rebuild = flatten(bodies)
            ctx.save_for_backward(*saved)
            return x * bodies.inv_mass

        @staticmethod
        def backward(ctx, g):
            return g * ctx.rebuild(ctx.saved_tensors).inv_mass, None

    x = torch.ones_like(bodies.inv_mass, requires_grad=True)
    b = bodies.replace(inv_mass=bodies.inv_mass.clone())
    (g,) = torch.autograd.grad(Scale.apply(x, b).sum(), x)
    assert torch.equal(g, b.inv_mass)
    y = Scale.apply(x, b)
    b.inv_mass.mul_(2.0)
    with pytest.raises(RuntimeError, match="inplace"):
        torch.autograd.grad(y.sum(), x)


# --- setup's and the solve's backward kernels on the card ---------------
# Each case of CARD_CASES: SimConfig overrides, and what the test does to
# the step's inputs (`fewer_points`: point 3 of every other manifold made
# invalid; `friction`: the friction coefficients scaled, with `push` added
# to the warm impulses along x, so that warm starts and solve sweeps meet
# the friction bound).
CARD_CASES = {
    "split_impulse": dict(),
    "no_split_impulse": dict(cfg=dict(split_impulse=False)),
    "no_pseudo_friction": dict(cfg=dict(pseudo_friction=False)),
    "no_warm_start": dict(cfg=dict(warm_start=False)),
    "spill_color": dict(cfg=dict(max_colors=3)),
    "fewer_points": dict(fewer_points=True),
    "friction_bound": dict(cfg=dict(pseudo_friction=False), friction=0.1,
                           push=0.5),
}
# setup's gradients within SETUP_RTOL of their largest element from the
# twin's autograd (the kernel recomputes the forward's bits; only the
# order of float sums differs); the solve's within SOLVE_RTOL of the
# field's largest element from autograd of the float64 twin, or within
# SOLVE_CORNER of autograd of the float32 twin where the float32 forward
# itself parts from the float64 one (tests/test_torch_kernels.py's
# tolerances for the same kernels)
SETUP_RTOL = 1e-4
SOLVE_RTOL, SOLVE_CORNER = 4e-5, 4e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_inputs(dev, case, n=150):
    """What a step of a pressed pile on the card (every box in contact,
    the ground a static side of the bottom layer's manifolds) hands setup
    and the solve, changed as CARD_CASES[case] says: (cfg, bodies,
    manifolds, warm, pwarm, coloring, order)."""
    spec = CARD_CASES[case]
    b = scenes.scene_pile(n, seed=4, walls=True)
    cfg = b.auto_config(broadphase="grid", **spec.get("cfg", {}))
    st = b.finalize(cfg, device=dev)
    pos = st.bodies.pos.clone()
    dyn = st.bodies.inv_mass > 0
    pos[dyn, 1] = 0.5 + (pos[dyn, 1] - 0.75) * (0.995 / 1.15)
    st, _ = engine.simulate(st.replace(bodies=st.bodies.replace(pos=pos)),
                            cfg, 3)
    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = contacts.collide(st, cfg)
    warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
    if spec.get("fewer_points"):
        pv = man.point_valid.clone()
        pv[::2, 3] = False
        man = man.replace(point_valid=pv)
    if "friction" in spec:
        man = man.replace(friction=man.friction * spec["friction"])
        warm = warm + torch.tensor([spec["push"], 0.0, 0.0], device=dev)
    col = solver.color_manifolds(man, bodies, cfg)
    order = solver_kernel.color_order(man, bodies, col, cfg)
    valid = man.valid
    static = ((bodies.inv_mass[man.body_a] == 0.0)
              | (bodies.inv_mass[man.body_b] == 0.0)) & valid
    assert bool(static.any()), "no manifold with a static side"
    if spec.get("fewer_points"):
        assert bool((man.point_valid[valid].sum(1) < 4).any())
    if "max_colors" in spec.get("cfg", {}):
        assert int(col[3]) > 0, "no manifold in the spill color"
    return cfg, bodies, man, warm, pwarm, col, order


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_setup_backward_kernel_matches_plain(cuda, case):
    """setup's backward kernel and its per-body sums against autograd of
    the twin (`setup_backward_plain`) on the same inputs and seeded output
    adjoints, twice bitwise."""
    cfg, bodies, man, warm, pwarm, col, order = _card_inputs(cuda, case)
    if case == "friction_bound":   # warm starts clamped to the cone
        con, _, _ = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                             pwarm)
        wn = torch.clamp_min((warm * con.n[:, None]).sum(-1), 0.0)
        wt = (warm * con.t1[:, None]).sum(-1).abs()
        at = man.point_valid & man.valid[:, None] & (
            wt > man.friction[:, None] * wn)
        assert bool(at.any())
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    live = torch.arange(m, device=cuda) < order.offsets[cfg.max_colors]
    gen = torch.Generator(device=cuda).manual_seed(11)
    d_rows = torch.randn((solver_kernel.ROWS, m), generator=gen,
                         device=cuda) * live
    d_rows[solver_kernel.ROW_OFFSET["relax"]:] = 0.0
    d_work = torch.randn((solver_kernel.WORK_ROWS, m), generator=gen,
                         device=cuda) * live
    d_work[16:] = 0.0
    d_frame = torch.randn((2, m, 3), generator=gen, device=cuda) \
        * man.valid[None, :, None]
    d_velw = torch.randn((n, solver_kernel.VEL_ROW), generator=gen,
                         device=cuda)
    args = (bodies, man, warm, pwarm, col[2], order, cfg,
            setup_kernel.uses_pwarm(pwarm, cfg), d_rows, d_work, d_frame,
            d_velw)
    kg = setup_kernel.setup_backward_cuda(*args)
    again = setup_kernel.setup_backward_cuda(*args)
    tg = setup_kernel.setup_backward_plain(bodies, man, warm, cfg, col,
                                           pwarm, order, d_rows, d_work,
                                           d_frame, d_velw)
    for name, x, y, z in zip(setup_kernel.GRAD_INPUTS, kg, again, tg):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()), name
        err = float((x - z).abs().max())
        assert err <= SETUP_RTOL * float(z.abs().max()), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_solve_backward_kernel_matches_plain(cuda, case):
    """The solve's reverse-sweep kernel (through `SolveFn`, from the twin's
    setup packed into the kernel's layout) against autograd of
    `solve_plain` in float64, element by element, twice bitwise."""
    cfg, bodies, man, warm, pwarm, col, order = _card_inputs(cuda, case)
    con, velw, acc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                              pwarm)
    if case == "friction_bound":   # sweeps that end at the friction bound
        _, (ln, lt1, _), _ = solver_kernel.solve_plain(velw, con, acc, cfg)
        bound = man.friction[:, None] * ln
        assert bool(((lt1.abs() >= 0.999 * bound) & (ln > 0.0)
                     & man.point_valid).any())
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(12)
    g_v = torch.randn((n, solver_kernel.VEL_ROW), generator=gen, device=cuda)
    g_o = torch.randn((4, m, 4), generator=gen, device=cuda) \
        * man.valid[None, :, None]
    tv, tf, ta = solver_kernel.solve_backward_plain(velw, con, acc, cfg, g_v,
                                                    g_o)
    fields = list(tf)
    qv, qf, qa = solver_kernel.solve_backward_plain(
        velw.double(), con.replace(**{f: getattr(con, f).double()
                                      for f in fields}),
        tuple(x.double() for x in acc), cfg, g_v.double(), g_o.double())

    def kernel():
        leaves = {f: getattr(con, f).detach().requires_grad_()
                  for f in fields}
        v = velw.detach().requires_grad_()
        a = [x.detach().requires_grad_() for x in acc]
        packed, work = setup_kernel.pack_constraints(
            con.replace(**leaves), tuple(a), order)
        vo, ao, po = solver_kernel.solve_cuda(v, packed, work, cfg)
        return torch.autograd.grad([vo, *ao, po], [v, *leaves.values(), *a],
                                   [g_v, *g_o], allow_unused=True)

    kg, again = kernel(), kernel()
    for x, y in zip(kg, again):
        assert (x is None and y is None) or torch.equal(x, y)
    dyn = {"a": con.im_a > 0.0, "b": con.im_b > 0.0}
    pairs = [("velw", kg[0], tv, qv)]
    for i, f in enumerate(fields):
        if f in ("im_a", "im_b", "relax"):
            continue            # their adjoints end at the inverse masses
        x, y, z = kg[1 + i], tf[f], qf[f]
        if x is None:
            x = torch.zeros_like(y)
        if f.startswith("j"):   # a static side's j rows: the same
            x, y, z = x[dyn[f[-1]]], y[dyn[f[-1]]], z[dyn[f[-1]]]
        pairs.append((f, x, y, z))
    pairs += [(f"acc{i}", kg[-3 + i], ta[i], qa[i]) for i in range(3)]
    for name, x, y, z in pairs:
        assert bool(torch.isfinite(x).all()), name
        big = float(z.abs().max())
        far = (x.double() - z).abs() > SOLVE_RTOL * big
        corner = (x - y).abs() <= SOLVE_CORNER * big
        assert not bool((far & ~corner).any()), (
            name, float((x.double() - z).abs().max()), big)


# --- the shape and mass instances of the backward kernels on the card ------

@pytest.mark.gpu
@pytest.mark.parametrize("spheres", [False, True])
def test_narrowphase_shape_backward_kernels_match_plain(cuda, spheres):
    """The narrowphase backward kernels' shape instances (half extents,
    radii and frictions, through pos, depth, normal and the pair friction)
    and their per-collider sums against autograd of the joined twins,
    twice bitwise; their pose columns bitwise the pose-only instances'."""
    b = scenes.scene_pile(300, sphere_frac=0.3 if spheres else 0.0, seed=5,
                          walls=True)
    cfg = b.auto_config(broadphase="grid")
    st, _ = engine.simulate(b.finalize(cfg, device=cuda), cfg, 60)
    wc = broadphase.world_colliders(st)
    from nudge_tpu_torch.ops import grid
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    k = contacts.narrowphase_all(st, wc, bb, bs, ss, cfg)
    p = contacts.narrowphase_joined_plain(st, wc, bb, bs, ss)
    same = torch.cat([bb.valid, bs.valid, ss.valid])
    for key in ("point_valid", "feat"):
        same &= (k[key] == p[key]).all(1)
    n = same.shape[0]
    w = same.float()
    gen = torch.Generator(device=cuda).manual_seed(21)
    grads = {"pos": torch.randn((n, 4, 3), generator=gen, device=cuda)
             * w[:, None, None],
             "depth": torch.randn((n, 4), generator=gen, device=cuda)
             * w[:, None],
             "normal": torch.randn((n, 3), generator=gen, device=cuda)
             * w[:, None],
             "friction": torch.randn(n, generator=gen, device=cuda) * w}
    args = (st, wc, bb, bs, ss, grads)
    kg = contacts.narrowphase_backward_cuda(*args, shapes=True)
    again = contacts.narrowphase_backward_cuda(*args, shapes=True)
    pose = contacts.narrowphase_backward_cuda(*args)
    tg = contacts.narrowphase_backward_plain(*args, shapes=True)
    names = ("box_pos", "box_quat", "sph_pos") + contacts.SHAPE_LEAVES
    assert len(kg) == len(tg) == len(names)
    for name, x, y, z in zip(names, kg, again, tg):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()), name
        err = float((x - z).abs().max())
        assert err <= SETUP_RTOL * max(float(z.abs().max()), 1e-30), (name,
                                                                       err)
    for x, y in zip(kg[:3], pose):
        assert torch.equal(x, y)
    if spheres:
        assert int(bs.valid.sum() + ss.valid.sum()) > 0
        assert float(kg[5].abs().max()) > 0.0    # the radii


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_setup_mass_backward_kernel_matches_plain(cuda, case):
    """setup's backward kernel's mass instance and its 17-column per-body
    sums against autograd of the twin, every GRAD_INPUTS adjoint, twice
    bitwise; the other inputs' adjoints bitwise the instance without."""
    cfg, bodies, man, warm, pwarm, col, order = _card_inputs(cuda, case)
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    live = torch.arange(m, device=cuda) < order.offsets[cfg.max_colors]
    gen = torch.Generator(device=cuda).manual_seed(13)
    d_rows = torch.randn((solver_kernel.ROWS, m), generator=gen,
                         device=cuda) * live
    d_rows[solver_kernel.ROW_OFFSET["relax"]:] = 0.0
    d_work = torch.randn((solver_kernel.WORK_ROWS, m), generator=gen,
                         device=cuda) * live
    d_work[16:] = 0.0
    d_frame = torch.randn((2, m, 3), generator=gen, device=cuda) \
        * man.valid[None, :, None]
    d_velw = torch.randn((n, solver_kernel.VEL_ROW), generator=gen,
                         device=cuda)
    args = (bodies, man, warm, pwarm, col[2], order, cfg,
            setup_kernel.uses_pwarm(pwarm, cfg), d_rows, d_work, d_frame,
            d_velw)
    kg = setup_kernel.setup_backward_cuda(*args, mass=True)
    again = setup_kernel.setup_backward_cuda(*args, mass=True)
    without = setup_kernel.setup_backward_cuda(*args)
    tg = setup_kernel.setup_backward_plain(bodies, man, warm, cfg, col,
                                           pwarm, order, d_rows, d_work,
                                           d_frame, d_velw)
    assert len(kg) == len(setup_kernel.GRAD_INPUTS) == len(tg)
    for name, x, y in zip(setup_kernel.GRAD_INPUTS, kg, without):
        assert torch.equal(x, y), name
    for name, x, y, z in zip(setup_kernel.GRAD_INPUTS, kg, again, tg):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()), name
        err = float((x - z).abs().max())
        assert err <= SETUP_RTOL * float(z.abs().max()), (name, err)
    static = bodies.inv_mass == 0.0
    assert float(kg[-3][static].abs().max()) > 0.0   # a static body's


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_solve_mass_backward_kernel_matches_plain(cuda, case):
    """The solve's reverse-sweep kernel's mass instance (a static side's
    running adjoint in adj_velw) against autograd of `solve_plain` in
    float64: every row's adjoint, the im rows and a static side's j rows
    too, and the velocities' and accumulators'."""
    import dataclasses

    cfg, bodies, man, warm, pwarm, col, order = _card_inputs(cuda, case)
    con, velw, acc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                              pwarm)
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(14)
    g_v = torch.randn((n, solver_kernel.VEL_ROW), generator=gen, device=cuda)
    g_o = torch.randn((4, m, 4), generator=gen, device=cuda) \
        * man.valid[None, :, None]
    tv, tf, ta = solver_kernel.solve_backward_plain(velw, con, acc, cfg, g_v,
                                                    g_o)
    fields = list(tf)
    qv, qf, qa = solver_kernel.solve_backward_plain(
        velw.double(), con.replace(**{f: getattr(con, f).double()
                                      for f in fields}),
        tuple(x.double() for x in acc), cfg, g_v.double(), g_o.double())

    def kernel():
        leaves = {f: getattr(con, f).detach().requires_grad_()
                  for f in fields}
        v = velw.detach().requires_grad_()
        a = [x.detach().requires_grad_() for x in acc]
        packed, work = setup_kernel.pack_constraints(
            con.replace(**leaves), tuple(a), order)
        packed = dataclasses.replace(packed, mass_grad=True)
        vo, ao, po = solver_kernel.solve_cuda(v, packed, work, cfg)
        return torch.autograd.grad([vo, *ao, po], [v, *leaves.values(), *a],
                                   [g_v, *g_o], allow_unused=True)

    kg, again = kernel(), kernel()
    for x, y in zip(kg, again):
        assert (x is None and y is None) or torch.equal(x, y)
    pairs = [("velw", kg[0], tv, qv)]
    for i, f in enumerate(fields):
        if f == "relax":
            continue
        x = kg[1 + i]
        pairs.append((f, torch.zeros_like(tf[f]) if x is None else x, tf[f],
                      qf[f]))
    pairs += [(f"acc{i}", kg[-3 + i], ta[i], qa[i]) for i in range(3)]
    for name, x, y, z in pairs:
        assert bool(torch.isfinite(x).all()), name
        big = float(z.abs().max())
        far = (x.double() - z).abs() > SOLVE_RTOL * big
        corner = (x - y).abs() <= SOLVE_CORNER * big
        assert not bool((far & ~corner).any()), (
            name, float((x.double() - z).abs().max()), big)
    static = (con.im_a == 0.0) & con.valid
    assert float(qf["im_a"][static].abs().max()) > 0.0
