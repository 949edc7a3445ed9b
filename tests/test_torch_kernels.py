"""The CUDA kernels of nudge_tpu_torch against their plain PyTorch twins, on
the same CUDA tensors. These need an NVIDIA GPU and skip without one.

This file imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from nudge_tpu_torch import engine, scenes
from nudge_tpu_torch.ops import broadphase, cache, contacts, grid, integrate
from nudge_tpu_torch.ops import coloring_kernel as ck
from nudge_tpu_torch.ops import narrowphase_1pt as p1pt
from nudge_tpu_torch.ops import narrowphase_kernel as npk
from nudge_tpu_torch.ops import segment, setup_kernel, solver, solver_kernel

pytestmark = pytest.mark.gpu

# Kernels and twins run the same float32 operations in the same order (the
# kernels are built without FMA contraction); the twins' scatter-adds use
# atomics on the card and sum in another order, hence a tolerance at all.
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _close(a, b, name):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)


def _pressed_pile(n, dev, **over):
    """A pile with its layers pressed together: contacts from step 0."""
    b = scenes.scene_pile(n, seed=4, walls=True)
    cfg = b.auto_config(**over)
    st = b.finalize(cfg, device=dev)
    pos = st.bodies.pos.clone()
    dyn = st.bodies.inv_mass > 0
    pos[dyn, 1] = 0.5 + (pos[dyn, 1] - 0.75) * (0.995 / 1.15)
    return cfg, st.replace(bodies=st.bodies.replace(pos=pos))


def _falling_mixed_pile(n, dev, steps, **over):
    """A mixed pile (30% spheres, walls) after `steps` steps of its drop."""
    b = scenes.scene_pile(n, sphere_frac=0.3, seed=5)
    cfg = b.auto_config(broadphase="grid", **over)
    st, _ = engine.simulate(b.finalize(cfg, device=dev), cfg, steps)
    return cfg, st


def _stage_inputs(cfg, st):
    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = contacts.collide(st, cfg)
    warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
    col, _ = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    return bodies, man, warm, pwarm, col


def _assert_live_equal(k, p, live):
    """Kernel slots `k` against twin slots `p` of the same pairs: every
    field of every live slot bit for bit, point_valid false on every dead
    one (the kernels write nothing else there)."""
    torch.cuda.synchronize()
    assert not bool(k["point_valid"][~live].any())
    for key in ("ga", "gb", "point_valid", "feat", "body_a", "body_b", "pos",
                "depth", "normal", "friction"):
        assert torch.equal(k[key][live], p[key][live]), key


def _box_box_both(st, wc, bb):
    p = npk.box_box_slots_plain(st.boxes, wc, bb)
    _assert_live_equal(npk.box_box_slots_cuda(st.boxes, wc, bb), p, bb.valid)
    return p


def test_box_box_kernel_matches_twin(dev):
    cfg, st = _pressed_pile(300, dev, broadphase="grid")
    st, _ = engine.simulate(st, cfg, 3)
    wc = broadphase.world_colliders(st)
    bb, _, _ = grid.grid_broadphase(st, wc, cfg)
    p = _box_box_both(st, wc, bb)
    assert int(p["point_valid"].sum()) > 100


def test_box_box_kernel_with_few_live_pairs(dev):
    """The same pairs with all but the first 20 live slots dead, as the
    compaction leaves a mostly idle scene: the dead slots cost nothing and
    read nothing, the live ones match the twin."""
    cfg, st = _pressed_pile(300, dev, broadphase="grid")
    st, _ = engine.simulate(st, cfg, 3)
    wc = broadphase.world_colliders(st)
    bb, _, _ = grid.grid_broadphase(st, wc, cfg)
    keep = bb.valid & (torch.cumsum(bb.valid.int(), 0) <= 20)
    zero = torch.zeros_like(bb.a)
    few = bb.replace(a=torch.where(keep, bb.a, zero),
                     b=torch.where(keep, bb.b, zero), valid=keep)
    p = _box_box_both(st, wc, few)
    assert int(keep.sum()) == 20 and int(p["point_valid"].sum()) > 0


@pytest.mark.parametrize("max_colors", [24, 2])
def test_setup_and_solve_kernels_match_twins(dev, max_colors):
    """Setup against setup_plain on every live manifold after unpacking;
    the one-launch solve against solve_plain from the same packed inputs:
    bitwise where no manifold spills, within tolerance with the spill
    color's Jacobi sums (the twin's scatter-adds use atomics there)."""
    cfg, st = _pressed_pile(300, dev, broadphase="grid",
                            max_colors=max_colors)
    st, _ = engine.simulate(st, cfg, 3)        # warm caches
    bodies, man, warm, pwarm, col = _stage_inputs(cfg, st)
    order = solver_kernel.color_order(man, bodies, col, cfg)
    kcon, kvelw, kwork = setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                                 pwarm, order)
    tcon, tvelw, tacc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                                 pwarm)
    torch.cuda.synchronize()
    live = man.valid
    ucon = setup_kernel.unpack_constraints(kcon)
    for f in dataclasses.fields(solver.ContactConstraints):
        a, b = getattr(ucon, f.name), getattr(tcon, f.name)
        if a.dim() and a.shape[0] == live.shape[0]:
            a, b = a[live], b[live]
        _close(a, b, f.name)
    _close(kcon.t1[live], tcon.t1[live], "frame t1")
    _close(kcon.t2[live], tcon.t2[live], "frame t2")
    _close(kvelw, tvelw, "velw")
    for a, b in zip(setup_kernel.unpack_acc(kwork, order), tacc):
        _close(a[live], b[live], "acc")

    packed, work = setup_kernel.pack_constraints(tcon, tacc, order)
    kv, ka, kp = solver_kernel.solve_cuda(tvelw.clone(), packed, work, cfg)
    tv, ta, tp = solver_kernel.solve_plain(tvelw, tcon, tacc, cfg)
    torch.cuda.synchronize()
    pairs = [(kv, tv, "solved velw")] + [
        (a, b, "solved acc") for a, b in zip(ka + (kp,), ta + (tp,))]
    for a, b, name in pairs:
        if int(col[3]) == 0:
            assert torch.equal(a, b), name
        else:
            _close(a, b, name)
    if max_colors == 2:
        assert int(col[3]) > 0
    else:
        assert int(col[3]) == 0


def _solve_inputs(dev, max_colors):
    cfg, st = _pressed_pile(300, dev, broadphase="grid",
                            max_colors=max_colors)
    st, _ = engine.simulate(st, cfg, 3)
    bodies, man, warm, pwarm, col = _stage_inputs(cfg, st)
    con, velw, work = setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                              pwarm)
    return cfg, col, con, velw, work


@pytest.mark.parametrize("max_colors", [24, 2])
def test_solve_kernel_repeats_bitwise(dev, max_colors):
    """Ten launches from one input give the same bits: a stale read of
    another SM's velocity write would make them differ."""
    cfg, col, con, velw, work = _solve_inputs(dev, max_colors)
    runs = []
    for _ in range(10):
        v, a, p = solver_kernel.solve_cuda(velw.clone(), con, work.clone(),
                                           cfg)
        runs.append(torch.cat([v.reshape(-1), *[x.reshape(-1) for x in a],
                               p.reshape(-1)]))
    torch.cuda.synchronize()
    assert not torch.equal(runs[0][:velw.numel()], velw.reshape(-1))
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    assert (int(col[3]) > 0) == (max_colors == 2)


def test_solve_is_one_launch(dev):
    """The whole solve, every sweep and color, is one kernel on the
    device: a CUDA graph capture of one call holds one kernel node and
    nothing else."""
    from nudge_tpu_torch.utils import timing

    cfg, col, con, velw, work = _solve_inputs(dev, 24)
    v, w = velw.clone(), work.clone()
    n0 = solver_kernel.solve.launches
    ops = timing.device_ops(lambda: solver_kernel.solve_cuda(v, con, w, cfg))
    assert solver_kernel.solve.launches == n0 + 2    # the warm call, the capture
    assert ops == {"kernel": 1}, ops
    assert int(col[1]) * cfg.solver_iters > 20     # many passes, one launch


def test_engine_on_cuda_launches_every_kernel_and_repeats(dev):
    cfg, st0 = _pressed_pile(200, dev, broadphase="grid")
    counters = (npk.box_box_slots, setup_kernel.setup, solver_kernel.solve)
    before = [c.launches for c in counters]
    a, ma = engine.simulate(st0, cfg, 5)
    b, mb = engine.simulate(st0, cfg, 5)
    torch.cuda.synchronize()
    assert all(c.launches >= n + 10 for c, n in zip(counters, before))
    for f in ("pos", "quat", "vel", "angvel"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f
    assert not bool(ma.overflow.any())
    # and the CPU twins agree with the card over the same steps
    c, _ = engine.simulate(
        dataclasses.replace(st0, **{
            g: dataclasses.replace(getattr(st0, g), **{
                f.name: getattr(getattr(st0, g), f.name).cpu()
                for f in dataclasses.fields(getattr(st0, g))})
            for g in ("bodies", "boxes", "spheres", "cache", "sleep", "bp",
                      "colors")},
            connections=st0.connections.cpu(),
            step_count=st0.step_count.cpu()), cfg, 5)
    np.testing.assert_allclose(a.bodies.pos.cpu().numpy(),
                               c.bodies.pos.numpy(), rtol=0, atol=1e-4)


def _one_point_both(st, wc, bb, bs, ss, cfg):
    """The one-point kernel as the step launches it: contacts.narrowphase_all
    writing its rows after box-box's, against the joined twins. Returns the
    twins' one-point rows."""
    p = contacts.narrowphase_joined_plain(st, wc, bb, bs, ss)
    _assert_live_equal(contacts.narrowphase_all(st, wc, bb, bs, ss, cfg), p,
                       torch.cat([bb.valid, bs.valid, ss.valid]))
    return {key: v[bb.a.shape[0]:] for key, v in p.items()}


def _few(pairs, n):
    """The pairs with only the first `n` live ones kept, the tail dead."""
    keep = pairs.valid & (torch.cumsum(pairs.valid.int(), 0) <= n)
    zero = torch.zeros_like(pairs.a)
    return pairs.replace(a=torch.where(keep, pairs.a, zero),
                         b=torch.where(keep, pairs.b, zero), valid=keep)


def test_pairs_1pt_kernel_matches_twin(dev):
    cfg, st = _falling_mixed_pile(400, dev, 40)
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    p = _one_point_both(st, wc, bb, bs, ss, cfg)
    assert int(bs.valid.sum()) > 20 and int(ss.valid.sum()) > 5
    assert int(p["point_valid"].sum()) > 20


def test_pairs_1pt_kernel_with_few_live_pairs(dev):
    """A few live pairs of each class in front of a long dead tail: the
    dead slots read nothing, the live ones match the twin."""
    cfg, st = _falling_mixed_pile(400, dev, 40)
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    bb, bs, ss = _few(bb, 10), _few(bs, 6), _few(ss, 3)
    p = _one_point_both(st, wc, bb, bs, ss, cfg)
    assert int(bs.valid.sum()) == 6 and int(ss.valid.sum()) == 3
    assert bs.a.shape[0] + ss.a.shape[0] > 1000
    assert int(p["point_valid"].sum()) > 0


def test_narrowphase_all_joins_in_place(dev):
    """On a mixed pile, narrowphase_all is the box-box and the one-point
    kernels writing one set of buffers: two kernels and nothing else a
    call, every live slot's fields equal to the joined twins' (the CPU
    path's join)."""
    from nudge_tpu_torch.utils import timing

    cfg, st = _falling_mixed_pile(400, dev, 40)
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    _one_point_both(st, wc, bb, bs, ss, cfg)
    assert int(bb.valid.sum()) > 100 and int(bs.valid.sum()) > 20
    ops = timing.device_ops(
        lambda: contacts.narrowphase_all(st, wc, bb, bs, ss, cfg))
    assert ops == {"kernel": 2}, ops


@pytest.mark.parametrize("max_colors", [24, 4])
def test_coloring_kernel_matches_twin(dev, max_colors):
    """Raw colors bit for bit: int32 atomicMin claims do not depend on
    their order."""
    cfg, st = _pressed_pile(300, dev, broadphase="grid")
    st, _ = engine.simulate(st, cfg, 3)
    man, _ = contacts.collide(st, cfg)
    dyn = st.bodies.inv_mass > 0.0
    args = (man.body_a, man.body_b, man.valid, dyn, dyn.shape[0], max_colors)
    n0 = ck.color_rounds.launches
    k = ck.color_rounds_cuda(*args)
    p = ck.color_rounds_plain(*args)
    torch.cuda.synchronize()
    assert ck.color_rounds.launches == n0 + 1
    assert torch.equal(k, p)
    spilled = int(((p < 0) & man.valid).sum())
    assert (spilled > 0) == (max_colors == 4)


def test_box_box_and_coloring_are_one_launch(dev):
    """A call of box-box, and of the coloring with every round, enqueues
    one kernel and nothing else (a CUDA graph capture of the call)."""
    from nudge_tpu_torch.utils import timing

    cfg, st = _pressed_pile(300, dev, broadphase="grid")
    wc = broadphase.world_colliders(st)
    bb, _, _ = grid.grid_broadphase(st, wc, cfg)
    bx = st.boxes
    man, _ = contacts.collide(st, cfg)
    dyn = st.bodies.inv_mass > 0.0
    args = (man.body_a, man.body_b, man.valid, dyn, dyn.shape[0], 24)
    assert timing.device_ops(
        lambda: npk.box_box_slots_cuda(bx, wc, bb)) == {"kernel": 1}
    assert timing.device_ops(
        lambda: ck.color_rounds_cuda(*args)) == {"kernel": 1}


def test_pairs_1pt_is_one_launch(dev):
    """A call of the one-point narrowphase, both pair classes, into the
    rows after box-box's of joined buffers as narrowphase_all makes it,
    enqueues one kernel and nothing else."""
    from nudge_tpu_torch.utils import timing

    cfg, st = _falling_mixed_pile(400, dev, 10)
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    n_bb = bb.a.shape[0]
    out = npk.empty_slots(n_bb + bs.a.shape[0] + ss.a.shape[0], dev)
    rows = {k: v[n_bb:] for k, v in out.items()}
    n0 = p1pt.pairs_1pt_slots_cuda.launches
    ops = timing.device_ops(lambda: p1pt.pairs_1pt_slots_cuda(
        st.boxes, st.spheres, wc, bs, ss, out=rows))
    assert ops == {"kernel": 1}, ops
    # the warm call and the capture
    assert p1pt.pairs_1pt_slots_cuda.launches == n0 + 2


def test_device_ms_times_the_device_and_refuses_a_host_wait(dev):
    """device_ms times work queued behind its spin; a call that waits on
    the device cannot be timed that way and raises."""
    from nudge_tpu_torch.utils import timing

    x = torch.ones(1 << 20, device=dev)
    ms = timing.device_ms(lambda: torch.cuda._sleep(2_000_000), reps=4)
    assert 0.5 < ms < 5.0          # 2e6 cycles at 1-2 GHz, 1-2 ms
    assert timing.device_ms(lambda: x.mul_(1.0)) > 0.0
    with pytest.raises(RuntimeError, match="waits on the device"):
        timing.device_ms(lambda: float(x.sum()), reps=2)


def _random_manifolds(dev, n_bodies, m, live, seed):
    """`live` manifolds at the front of `m` slots between random bodies of
    `n_bodies`, a tenth of them static; the dead tail as compaction leaves
    it (body 0, not valid)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_bodies, size=m)
    b = (a + rng.integers(1, 40, size=m)) % n_bodies
    valid = np.arange(m) < live
    a[~valid] = 0
    b[~valid] = 0
    dyn = rng.random(n_bodies) > 0.1

    def t(x, dt):
        return torch.tensor(x, dtype=dt, device=dev)

    return (t(a, torch.int32), t(b, torch.int32), t(valid, torch.bool),
            t(dyn, torch.bool))


@pytest.mark.parametrize("case", ["many_bodies", "dead_tail"])
@pytest.mark.parametrize("max_colors", [24, 4])
def test_coloring_kernel_matches_twin_at_scale(dev, case, max_colors):
    """Many more bodies than one CTA has threads, and a long dead tail of
    manifold slots behind a few live ones: the raw colors bit for bit, and
    ten launches from one input equal."""
    n_bodies, m, live = {"many_bodies": (200_000, 61_440, 40_000),
                         "dead_tail": (20_480, 61_440, 300)}[case]
    a, b, valid, dyn = _random_manifolds(dev, n_bodies, m, live, seed=3)
    args = (a, b, valid, dyn, n_bodies, max_colors)
    k = ck.color_rounds_cuda(*args)
    p = ck.color_rounds_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert bool((p[:live] >= 0).any()) and bool((p[live:] == -1).all())
    for _ in range(9):
        assert torch.equal(ck.color_rounds_cuda(*args), k)


def test_mixed_pile_fresh_coloring_launches_every_kernel_and_repeats(dev):
    cfg, st0 = _falling_mixed_pile(400, dev, 30, persistent_coloring=False)
    counters = (npk.box_box_slots, p1pt.pairs_1pt_slots_cuda, ck.color_rounds,
                setup_kernel.setup, solver_kernel.solve)
    before = [c.launches for c in counters]
    a, ma = engine.simulate(st0, cfg, 5)
    b, mb = engine.simulate(st0, cfg, 5)
    torch.cuda.synchronize()
    assert all(c.launches == n + 10 for c, n in zip(counters, before))
    for f in ("pos", "quat", "vel", "angvel"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f
    assert torch.equal(ma.kinetic_energy, mb.kinetic_energy)
    assert not bool(ma.overflow.any())
    assert bool(torch.isfinite(a.bodies.pos).all())


def _through_twins(monkeypatch):
    """Route every kernel wrapper's CUDA branch to its plain twin."""
    for mod, name in ((npk, "box_box_slots"), (ck, "color_rounds"),
                      (solver_kernel, "solve")):
        monkeypatch.setattr(mod, f"{name}_cuda", getattr(mod, f"{name}_plain"))
    # the joined twins in place of NarrowphaseFn: autograd through them
    monkeypatch.setattr(contacts, "narrowphase_cuda",
                        contacts.narrowphase_joined_plain)
    # the twin keeps manifold order: it takes no slot order
    monkeypatch.setattr(setup_kernel, "setup_cuda",
                        lambda *a: setup_kernel.setup_plain(*a[:6]))


def test_reference_mode_step_matches_twins(dev, monkeypatch):
    """Reference-mode steps (sleeping + persistent broadphase) of a pressed
    pile on the card, through the kernels and through the twins on the
    same CUDA tensors: sleep state and cache bitwise, bodies within the
    kernels' tolerance, and every sleeper's velocity exactly zero under
    its awake load."""
    cfg, st = _pressed_pile(300, dev, broadphase="grid", sleeping=True,
                            persistent_broadphase=True, sleep_frames=10_000)
    st, _ = engine.simulate(st, cfg, 2)
    # the two bottom layers asleep under an awake load (nobody else can
    # qualify to sleep, and resting bodies are too slow to wake them)
    low = (st.bodies.inv_mass > 0) & (st.bodies.pos[:, 1] < 2.0)
    zero = torch.zeros_like(st.bodies.vel)
    st = st.replace(
        bodies=st.bodies.replace(
            vel=torch.where(low[:, None], zero, st.bodies.vel),
            angvel=torch.where(low[:, None], zero, st.bodies.angvel)),
        sleep=st.sleep.replace(awake=st.sleep.awake & ~low))
    counters = (npk.box_box_slots, setup_kernel.setup, solver_kernel.solve)
    for _ in range(3):
        before = [c.launches for c in counters]
        k, km = engine.step(st, cfg)
        assert all(c.launches == n + 1 for c, n in zip(counters, before))
        with monkeypatch.context() as m:
            _through_twins(m)
            t, tm = engine.step(st, cfg)
        torch.cuda.synchronize()
        for g in ("sleep", "bp"):
            for f in dataclasses.fields(getattr(k, g)):
                assert torch.equal(getattr(getattr(k, g), f.name),
                                   getattr(getattr(t, g), f.name)), f.name
        for f in ("pos", "quat", "vel", "angvel"):
            _close(getattr(k.bodies, f), getattr(t.bodies, f), f)
        assert torch.equal(km.awake_count, tm.awake_count)
        asleep = (st.bodies.inv_mass > 0) & ~st.sleep.awake & ~k.sleep.awake
        assert int(asleep.sum()) > 0 and int(km.awake_count) > 0
        assert not bool(k.bodies.vel[asleep].any())
        assert not bool(k.bodies.angvel[asleep].any())
        st = k


# --- the backward kernels (the differentiable mode) ---------------------
# Each against autograd of its twin on the same inputs and output adjoint:
# every gradient within GRAD_RTOL of its largest element (the backward
# replays the forward's bits, so only the order of float sums differs).
# The solve is held to its float64 twin instead: autograd of the float32
# twin loses more than that to cancellation over the sweeps.
GRAD_RTOL = 1e-4


def _grad_close(k, t, name, rtol=GRAD_RTOL):
    assert bool(torch.isfinite(k).all()), name
    err = float((k - t).abs().max()) if k.numel() else 0.0
    assert err <= rtol * float(t.abs().max() if t.numel() else 0.0), \
        (name, err)


def _randn(shape, dev, seed):
    return torch.randn(shape, generator=torch.Generator(device=dev)
                       .manual_seed(seed), device=dev)


@pytest.mark.parametrize("spheres", [False, True])
def test_narrowphase_backward_matches_twin(dev, spheres):
    if spheres:
        cfg, st = _falling_mixed_pile(400, dev, 60)
    else:
        cfg, st = _pressed_pile(300, dev, broadphase="grid")
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    k = contacts.narrowphase_all(st, wc, bb, bs, ss, cfg)
    p = contacts.narrowphase_joined_plain(st, wc, bb, bs, ss)
    same = torch.cat([bb.valid, bs.valid, ss.valid])
    for key in ("point_valid", "feat"):
        same &= (k[key] == p[key]).all(1)
    n = same.shape[0]
    w = same.float()
    grads = {"pos": _randn((n, 4, 3), dev, 1) * w[:, None, None],
             "depth": _randn((n, 4), dev, 2) * w[:, None],
             "normal": _randn((n, 3), dev, 3) * w[:, None]}
    args = (st, wc, bb, bs, ss, grads)
    kg = contacts.narrowphase_backward_cuda(*args)
    again = contacts.narrowphase_backward_cuda(*args)
    tg = contacts.narrowphase_backward_plain(*args)
    for name, x, y, z in zip(("box_pos", "box_quat", "sph_pos"), kg, again,
                             tg):
        assert torch.equal(x, y), name
        _grad_close(x, z, name)
    assert int(bs.valid.sum() + ss.valid.sum()) > 0 or not spheres


def test_setup_backward_matches_twin(dev):
    cfg, st = _pressed_pile(300, dev, broadphase="grid")
    st, _ = engine.simulate(st, cfg, 3)
    bodies, man, warm, pwarm, col = _stage_inputs(cfg, st)
    order = solver_kernel.color_order(man, bodies, col, cfg)
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    live = torch.arange(m, device=dev) < order.offsets[cfg.max_colors]
    d_rows = _randn((solver_kernel.ROWS, m), dev, 1) * live
    d_rows[solver_kernel.ROW_OFFSET["relax"]:] = 0.0
    d_work = _randn((solver_kernel.WORK_ROWS, m), dev, 2) * live
    d_work[16:] = 0.0
    d_frame = _randn((2, m, 3), dev, 3) * man.valid[None, :, None]
    d_velw = _randn((n, solver_kernel.VEL_ROW), dev, 4)
    args = (bodies, man, warm, pwarm, col[2], order, cfg,
            setup_kernel.uses_pwarm(pwarm, cfg), d_rows, d_work, d_frame,
            d_velw)
    kg = setup_kernel.setup_backward_cuda(*args)
    again = setup_kernel.setup_backward_cuda(*args)
    tg = setup_kernel.setup_backward_plain(bodies, man, warm, cfg, col, pwarm,
                                           order, d_rows, d_work, d_frame,
                                           d_velw)
    for name, x, y, z in zip(setup_kernel.GRAD_INPUTS, kg, again, tg):
        assert torch.equal(x, y), name
        _grad_close(x, z, name)


SOLVE64_RTOL, SOLVE64_CORNER = 4e-5, 4e-6


@pytest.mark.parametrize("max_colors", [24, 3])
def test_solve_backward_matches_float64_twin(dev, max_colors):
    """The reverse sweep (with the spill color's Jacobi adjoint at 3
    colors) against autograd of solve_plain in float64: every element
    within SOLVE64_RTOL of its field's largest element, or, where the
    float32 forward itself parts from the float64 one, equal to autograd
    of the float32 twin within SOLVE64_CORNER of it (chip_smoke.py's
    grad_check64; autograd of the float32 twin alone loses ~1e-3 of the
    norm to cancellation, so it is no reference)."""
    cfg, st = _pressed_pile(300, dev, broadphase="grid",
                            max_colors=max_colors)
    st, _ = engine.simulate(st, cfg, 3)
    bodies, man, warm, pwarm, col = _stage_inputs(cfg, st)
    order = solver_kernel.color_order(man, bodies, col, cfg)
    con, velw, acc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                              pwarm)
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    g_v = _randn((n, solver_kernel.VEL_ROW), dev, 1)
    g_o = _randn((4, m, 4), dev, 2) * man.valid[None, :, None]
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
        if f.startswith("j"):   # a static side's j rows: the same
            x, y, z = x[dyn[f[-1]]], y[dyn[f[-1]]], z[dyn[f[-1]]]
        pairs.append((f, x, y, z))
    pairs += [(f"acc{i}", kg[-3 + i], ta[i], qa[i]) for i in range(3)]
    for name, x, y, z in pairs:
        assert bool(torch.isfinite(x).all()), name
        big = float(z.abs().max())
        far = (x.double() - z).abs() > SOLVE64_RTOL * big
        corner = (x - y).abs() <= SOLVE64_CORNER * big
        assert not bool((far & ~corner).any()), (
            name, float((x.double() - z).abs().max()), big)


def test_segment_sum_kernel_is_the_plain_sum(dev):
    keys = torch.randint(0, 500, (20_000,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(0))
    take = _randn((20_000,), dev, 1) > -1.0
    vals = _randn((20_000, 13), dev, 2)
    k, perm = segment.entries(keys, take)
    init = _randn((500, 13), dev, 3)
    for start in (None, init):
        got = segment.segment_sum_cuda(k, perm, vals, 500, start)
        want = segment.segment_sum_plain(k.cpu(), perm.cpu(), vals.cpu(),
                                         500, None if start is None
                                         else start.cpu())
        assert torch.equal(got.cpu(), want)


def test_differentiable_rollout_matches_twins(dev, monkeypatch):
    """Three differentiable steps of a pressed pile through the kernels and
    their backward kernels, against autograd through the twins on the same
    CUDA tensors (the solve in float64: see the solve's test), and the
    forward bitwise equal to the normal mode's."""
    cfg, st0 = _pressed_pile(200, dev, broadphase="grid")
    dcfg = cfg.replace(differentiable=True)

    def grads(solve64=False):
        v = st0.bodies.vel.clone().requires_grad_()
        x = st0.bodies.pos.clone().requires_grad_()
        st = st0.replace(bodies=st0.bodies.replace(vel=v, pos=x))
        for _ in range(3):
            st, _ = engine.step(st, dcfg)
        loss = torch.sum(st.bodies.pos[:, 1] * (st.bodies.inv_mass > 0))
        return st, torch.autograd.grad(loss, [v, x])

    plain, _ = engine.simulate(st0, cfg, 3)
    st, kg = grads()
    for f in ("pos", "quat", "vel", "angvel"):
        assert torch.equal(getattr(st.bodies, f), getattr(plain.bodies, f)), f
    with monkeypatch.context() as m:
        _through_twins(m)

        def solve64(velw, con, acc, cfg):
            c = con.replace(**{f: getattr(con, f).double()
                               for f, _ in solver_kernel.ROW_FIELDS
                               if getattr(con, f).is_floating_point()})
            v, a, p = solver_kernel.solve_plain(
                velw.double(), c, tuple(x.double() for x in acc), cfg)
            return v.float(), tuple(x.float() for x in a), p.float()

        m.setattr(solver_kernel, "solve_cuda", solve64)
        _, tg = grads()
    for name, x, y in zip(("d/dv", "d/dx"), kg, tg):
        assert bool(torch.isfinite(x).all())
        rel = float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
        assert rel <= 1e-3, (name, rel)
