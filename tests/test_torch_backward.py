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
in every case). They skip without a card; on one, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_backward.py
"""

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
