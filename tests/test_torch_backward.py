"""The plain versions behind the backward kernels, on the CPU: autograd of
each kernel's twin (the narrowphases, setup, the solve) against
torch.autograd.gradcheck's central differences in float64 on tiny scenes,
and the fixed-order segment sum that adds the kernels' adjoint rows per
body and per collider against a plain sum. The kernels themselves are
held to these plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py phase 18)."""

import pytest
import torch

from nudge_tpu_torch import engine, scenes
from nudge_tpu_torch.mathx import quat_from_axis_angle
from nudge_tpu_torch.ops import cache, contacts, integrate, narrowphase
from nudge_tpu_torch.ops import segment, setup_kernel, solver, solver_kernel
from nudge_tpu_torch.ops.broadphase import CandidatePairs
from nudge_tpu_torch.state import flatten

f64 = torch.float64


def _gradcheck(fn, inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def _q(axis, angle):
    return quat_from_axis_angle(torch.tensor(axis), torch.tensor(angle))


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

    def pairs(a, b, valid):
        return CandidatePairs(
            a=torch.tensor(a, dtype=torch.int32),
            b=torch.tensor(b, dtype=torch.int32),
            valid=torch.tensor(valid), count=torch.tensor(len(a)))

    bb = pairs([0, 1, 2], [1, 2, 0], [True, True, False])
    bs = pairs([2, 0], [1, 0], [True, True])
    ss = pairs([0], [1], [True])
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


def test_backward_wrappers_refuse_cpu_tensors():
    """A backward wrapper launches its kernel on CUDA tensors or raises: on
    CPU tensors it raises (the plain versions are autograd of the twins)."""
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
