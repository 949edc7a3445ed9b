"""The port's on-device control flow (nudge_tpu_torch/control.py): `cond`
and `bounded_while` against Python's `if` and `while` on seeded inputs,
the metrics' packing into a graph's int32 rows, the capture's launch
accounting, and a host-read audit of a reference-mode step: outside
control.py's predicate reads (one park, one rebuild, three sleeping skips,
at most max_colors - 1 claim rounds) the step reads nothing to the host on
the paths the card runs.

The cases marked `gpu` hold the compiled rollout (`engine.simulate`, the
mesh's rollouts) to the eager `engine.step`, bit for bit, and the compiled
gradient to autograd of the eager loop; they skip without a CUDA
device."""

import collections
import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nudge_tpu_torch import control, engine, scenes
from nudge_tpu_torch.ops import persistent_bp
from nudge_tpu_torch.state import flatten, tree_map

torch.set_num_threads(2)

needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")


def _rng_tensors(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(17, 3)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-5, 5, size=(17,)).astype(np.int32))
    return rng, a, b


@pytest.mark.parametrize("seed", range(6))
def test_cond_equals_python_if(seed):
    rng, a, b = _rng_tensors(seed)
    pred = torch.tensor(bool(rng.integers(0, 2)))

    def yes(x, y):
        return x * 2.0 + 1.0, (y + 3, torch.any(x > 0))

    def no(x, y):
        return x - 0.5, (y * y, torch.all(x > 0))

    got = control.cond(pred, yes, no, (a, b))
    want = yes(a, b) if bool(pred) else no(a, b)
    for g, w in zip(flatten(got)[0], flatten(want)[0]):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_bounded_while_equals_python_while(seed):
    """A carry halved and counted while any element is above a seeded
    threshold, with the trip count bounded: Python's loop with the same
    bound and the same early exit."""
    rng, a, _ = _rng_tensors(seed)
    thresh = float(rng.uniform(0.05, 0.5))
    n_max = int(rng.integers(1, 8))

    def pred(c, carry):
        return torch.any(carry[0].abs() > thresh)

    def body(c, carry):
        x, k = carry
        return x * 0.5 + c * 1e-3, k + (x.abs() > thresh).to(torch.int32)

    k0 = torch.from_numpy(rng.integers(0, 3, size=a.shape).astype(np.int32))
    got = control.bounded_while(n_max, pred, body, (a.clone(), k0.clone()))
    x, k, c = a.clone(), k0.clone(), 0
    while c < n_max and bool(torch.any(x.abs() > thresh)):
        x, k = body(c, (x, k))
        c += 1
    assert torch.equal(got[0], x) and torch.equal(got[1], k)


def test_flatten_keeps_no_tree_alive():
    """A state flattened and rebuilt, then dropped, is freed by reference
    counting alone: `flatten` makes no reference cycle, which would keep
    every state a rollout flattens in memory until the cyclic collector
    runs (the window's reserved peak then grows with its call count)."""
    import gc
    import weakref

    b = scenes.scene_pile(8, seed=1)
    st = b.finalize(b.auto_config(), device="cpu")
    pos = st.bodies.pos.clone()
    probe = weakref.ref(pos)
    gc.collect()
    gc.disable()
    try:
        tree = st.replace(bodies=st.bodies.replace(pos=pos))
        leaves, build = flatten(tree)
        again = build([t.clone() for t in leaves])
        assert torch.equal(again.bodies.pos, pos)
        del tree, leaves, build, again, pos
        assert probe() is None
    finally:
        gc.enable()

def test_metric_rows_round_trip_bitwise():
    """A graph writes its 0-d metrics as int32 bits into one row; unpacked,
    every float keeps its bits (-0.0, inf, NaN, subnormals too), every
    integer and flag its value."""
    vals = [-0.0, float("inf"), float("nan"), 1e-45, -3.25, 2.0 ** 100]
    rows, want = [], []
    for k, f in enumerate(vals):
        m = engine.StepMetrics(
            contact_count=torch.tensor(k - 3, dtype=torch.int32),
            max_depth=torch.tensor(f, dtype=torch.float32),
            spill_count=torch.tensor(2 ** 31 - 1 - k, dtype=torch.int32),
            overflow=torch.tensor(k % 2 == 1),
            awake_count=torch.tensor(k, dtype=torch.int32),
            kinetic_energy=torch.tensor(-f, dtype=torch.float32),
            overflow_bits=torch.tensor(1 << k, dtype=torch.int32),
            manifold_demand=torch.tensor(-k, dtype=torch.int32),
            pair_demand=torch.tensor(7 * k, dtype=torch.int32))
        rows.append(control._pack(m))
        want.append(m)
    got = control._unpack(torch.stack(rows), want[0])
    for f in dataclasses.fields(engine.StepMetrics):
        w = torch.stack([getattr(m, f.name) for m in want])
        g = getattr(got, f.name)
        assert g.dtype == w.dtype
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f.name


def test_capture_accounts_launches_per_body():
    """The capture's record: launches captured outside every body, and in
    each body outside its nested bodies."""
    class Counted:
        pass

    k = control.counter(Counted(), "launches")
    cap = control._Capture(torch.zeros(8, dtype=torch.int64))
    k.launches += 2                      # outside
    outer = cap.open("outer")
    k.launches += 3
    inner = cap.open("inner")
    k.launches += 5
    cap.close(inner)
    k.launches += 7
    cap.close(outer)
    k.launches += 11                     # outside again
    i = control._COUNTERS.index((k, "launches"))
    assert inner.own[i] == 5 and outer.own[i] == 10
    assert cap.top()[i] == 13
    control._COUNTERS.remove((k, "launches"))


# --- the host-read audit -----------------------------------------------------

_PKG = "nudge_tpu_torch"


class HostReads(TorchDispatchMode):
    """Counts the operations that read a tensor to the host
    (`aten._local_scalar_dense`, which item, bool, int and float reach)
    and `aten.nonzero` (a size the host must know), each by the port's
    innermost frame and, for control.py's own reads, by the function that
    called into control.py."""

    def __init__(self):
        super().__init__()
        self.outside = collections.Counter()
        self.predicates = collections.Counter()
        self.nonzero = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.nonzero:
            self.nonzero += 1
        elif func is torch.ops.aten._local_scalar_dense.default:
            self.record()
        return func(*args, **(kwargs or {}))

    def record(self):
        frames = []
        f = sys._getframe(2)
        while f is not None:
            name = f.f_code.co_filename
            if _PKG in name:
                frames.append((name.split(_PKG)[-1].lstrip("/\\"),
                               f.f_code.co_name))
            f = f.f_back
        if frames and frames[0][0] == "control.py":
            caller = next(fr for fr in frames if fr[0] != "control.py")
            self.predicates[caller[1]] += 1
        else:
            self.outside[frames[0] if frames else ("?", "?")] += 1


def test_reference_step_reads_only_its_predicates(monkeypatch):
    """One active reference-mode step of a small pile (sleeping, the
    persistent broadphase, the cached coloring) on the CPU: its host reads
    are control.py's predicate reads, one park, one rebuild, three
    sleeping skips and at most max_colors - 1 claim rounds. The one other
    read is the solve kernel's plain twin sizing its Python loop by the
    color count (`solver.solve_from`): on the card the kernel reads the
    count on the device, and the twin is never captured."""
    b = scenes.scene_pile(64, seed=3)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    st = b.finalize(cfg, device="cpu")
    for _ in range(3):
        st, _ = engine.step(st, cfg)
    listed = []
    real = torch.Tensor.tolist

    def tolist(self):
        listed.append(self.shape)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    audit = HostReads()
    with audit:
        st, m = engine.step(st, cfg)
    assert int(m.awake_count) > 0 and int(m.manifold_demand) > 0
    assert audit.nonzero == 0 and listed == []
    assert dict(audit.outside) == {("ops/solver.py", "solve_from"): 1}
    p = dict(audit.predicates)
    claims = p.pop("color_rounds_cached_plain")
    assert 1 <= claims <= cfg.max_colors - 1
    assert p == {"step": 1, "persistent_broadphase": 1, "update_sleep": 3}


def test_parked_step_reads_only_the_park():
    """An all-asleep step reads the park's predicate and nothing else."""
    b = scenes.scene_single_box(0.5)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    st = b.finalize(cfg, device="cpu")
    st = st.replace(sleep=st.sleep.replace(
        awake=torch.zeros_like(st.sleep.awake)))
    audit = HostReads()
    p0 = engine.step.parked
    with audit:
        engine.step(st, cfg)
    assert engine.step.parked == p0 + 1
    assert dict(audit.predicates) == {"step": 1}
    assert not audit.outside and audit.nonzero == 0


# --- on the card: the compiled rollout against the eager step ----------------

def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bitwise(a, b, what):
    la, lb = flatten(a)[0], flatten(b)[0]
    assert len(la) == len(lb)
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), \
            f"{what}: leaf {k} differs"


def _eager(st, cfg, steps):
    ms = []
    for _ in range(steps):
        st, m = engine.step(st, cfg)
        ms.append(m)
    return st, engine.StepMetrics(**{
        f.name: torch.stack([getattr(m, f.name) for m in ms])
        for f in dataclasses.fields(engine.StepMetrics)})


def _compiled_vs_eager(st, cfg, steps, windows):
    """`windows` windows of `steps` compiled steps, each bitwise the eager
    steps from the same state. Returns (state, parks, rebuilds)."""
    parks = rebuilds = 0
    for _ in range(windows):
        p0 = engine.step.parked
        r0 = persistent_bp.persistent_broadphase.rebuilds
        got, gm = engine.simulate(st, cfg, steps)
        parks += engine.step.parked - p0
        rebuilds += persistent_bp.persistent_broadphase.rebuilds - r0
        want, wm = _eager(st, cfg, steps)
        _assert_bitwise(got, want, "state")
        _assert_bitwise(gm, wm, "metrics")
        st = got
    return st, parks, rebuilds


@pytest.mark.gpu
@needs_cuda
def test_compiled_pile_is_the_eager_step():
    """The 512-box pile in the reference mode: settled by the compiled
    rollout (50-step windows, each bitwise the eager steps), then 50
    compiled steps from the window before the first park, its rebuild
    forced, bitwise the eager steps, with a rebuild and a park among
    them."""
    b = scenes.scene_pile(512, seed=3)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    st = b.finalize(cfg, device="cuda")
    before = st
    for _ in range(60):
        p0 = engine.step.parked
        nxt, _ = engine.simulate(st, cfg, 25)
        if engine.step.parked > p0:
            break
        before, st = st, nxt
    else:
        pytest.fail("the 512-box pile never parked in 1,500 steps")
    before = before.replace(bp=before.bp.replace(
        stale=torch.ones_like(before.bp.stale)))
    _, parks, rebuilds = _compiled_vs_eager(before, cfg, 50, 1)
    assert parks >= 1 and rebuilds >= 1


@pytest.mark.gpu
@needs_cuda
def test_compiled_config3_is_the_eager_step():
    b = scenes.scene_pile(2048, sphere_frac=0.25)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    _compiled_vs_eager(b.finalize(cfg, device="cuda"), cfg, 50, 1)


@pytest.mark.gpu
@needs_cuda
def test_compiled_batch_is_the_eager_step():
    """batched_simulate over two scenes: each scene bitwise its own eager
    steps."""
    from nudge_tpu_torch.parallel import mesh

    stack, cfg = scenes.scene_pile_megachunks(2, 2, 64, device="cuda")
    out, m = mesh.batched_simulate(cfg, 20)(stack)
    for i in range(2):
        want, wm = _eager(mesh.take(stack, i), cfg, 20)
        _assert_bitwise(mesh.take(out, i), want, f"scene {i}")
        _assert_bitwise(tree_map(lambda x: x[:, i], m), wm,
                        f"scene {i} metrics")


@pytest.mark.gpu
@needs_cuda
def test_replay_reads_nothing_to_the_host():
    """Replays of the captured step under the sync debug mode "error": no
    operation between the rollout's start and its end waits on the
    device."""
    b = scenes.scene_pile(256, seed=1)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    st = b.finalize(cfg, device="cuda")
    graph = control.compiled(engine.step, cfg, st)
    graph.start()
    graph.load(st)
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay(2 * control.METRIC_ROWS + 3)
    finally:
        torch.cuda.set_sync_debug_mode(old)
    ran = graph.finish()
    assert ran["awake:true"] + ran["awake:false"] == 2 * control.METRIC_ROWS + 3


@pytest.mark.gpu
@needs_cuda
def test_differentiable_mode_compiles_with_and_without_a_gradient():
    """The differentiable mode with no leaf that requires grad replays the
    captured step, bitwise the eager steps; with one it is the compiled
    gradient (one `_RolloutFn` node: the captured step forward, the
    captured backward step in reverse), whose positions and gradient are
    the eager loop's under autograd, bit for bit."""
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=8, solver_iters=12)
    st = b.finalize(cfg, device="cuda")
    got, gm = engine.simulate(st, cfg, 12)
    want, wm = _eager(st, cfg, 12)
    _assert_bitwise(got, want, "state")
    _assert_bitwise(gm, wm, "metrics")
    assert not got.bodies.pos.requires_grad
    grads, nodes = [], []
    for run in (engine.simulate, _eager):
        v = st.bodies.vel.clone().requires_grad_()
        out, _ = run(st.replace(bodies=st.bodies.replace(vel=v)), cfg, 12)
        nodes.append(type(out.bodies.pos.grad_fn).__name__)
        (g,) = torch.autograd.grad(out.bodies.pos[1].sum(), v)
        _assert_bitwise(out.bodies.pos.detach(), want.bodies.pos,
                        "positions")
        grads.append(g)
    assert nodes[0] == "_RolloutFnBackward" != nodes[1]
    assert torch.isfinite(grads[0]).all() and bool(grads[0].abs().max() > 0)
    _assert_bitwise(grads[0], grads[1], "gradient")


# --- on the card: the compiled gradient against the eager loop ---------------

def _grad_run(st0, cfg, steps, compiled, targets):
    """(loss, d loss / d the initial vel and pos) of `steps` steps from
    st0 through engine.simulate (`compiled`) or the eager loop; the loss:
    the targets' squared distances plus the summed kinetic energy."""
    v = st0.bodies.vel.clone().requires_grad_()
    p = st0.bodies.pos.clone().requires_grad_()
    st = st0.replace(bodies=st0.bodies.replace(vel=v, pos=p))
    st, m = (engine.simulate if compiled else _eager)(st, cfg, steps)
    loss = m.kinetic_energy.sum() * 1e-2 + sum(
        torch.sum((st.bodies.pos[i] - torch.tensor(t, device="cuda")) ** 2)
        for i, t in targets)
    return (loss.detach(), *torch.autograd.grad(loss, [v, p]))


def _compiled_grad_is_the_loop(st0, cfg, steps, targets):
    want = _grad_run(st0, cfg, steps, False, targets)
    for _ in range(2):         # the first call captures
        _assert_bitwise(_grad_run(st0, cfg, steps, True, targets), want,
                        "loss and gradients")


@pytest.mark.gpu
@needs_cuda
def test_compiled_gradient_pile4_is_the_loop():
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=8, solver_iters=12)
    _compiled_grad_is_the_loop(b.finalize(cfg, device="cuda"), cfg, 12,
                               [(1, (1.0, 0.0, 3.0))])


@pytest.mark.gpu
@needs_cuda
def test_compiled_gradient_config3_sized_is_the_loop():
    """A 2,048-body mixed pile (config 3's scene, auto_config), 3 steps
    after 60: box-box's and the one-point's backward kernels inside the
    captured backward step."""
    b = scenes.scene_pile(2048, sphere_frac=0.25)
    cfg = b.auto_config(differentiable=True)
    st0, _ = engine.simulate(b.finalize(cfg, device="cuda"), cfg, 60)
    _compiled_grad_is_the_loop(st0, cfg, 3, [(1, (1.0, 0.0, 3.0)),
                                             (7, (0.0, 1.0, 0.0))])


@pytest.mark.gpu
@needs_cuda
def test_compiled_gradient_env_rollout_is_the_loop():
    """Two envs through vec_step (each env's frame skip one `_RolloutFn`
    node): the actions' gradient bitwise each env's alone through the
    eager loop."""
    from nudge_tpu_torch.envs import BoxPushEnv, vec_reset, vec_step
    from nudge_tpu_torch.parallel import mesh

    env = BoxPushEnv(horizon=10, frame_skip=3, differentiable=True,
                     sleeping=False, device="cuda")
    states, _ = vec_reset(env, [torch.Generator().manual_seed(5 + i)
                                for i in range(2)])
    acts = torch.tensor([[1.0, 0.5], [-0.8, 0.3]], device="cuda",
                        requires_grad=True)
    _, _, rew, _, _ = vec_step(env, states, acts)
    (gb,) = torch.autograd.grad(rew.sum(), acts)
    for i in range(2):
        a = acts[i].detach().requires_grad_()
        s = mesh.take(states, i)
        sim = env._push(s.sim, a)
        for _ in range(env.frame_skip):
            sim, _ = engine.step(sim, env.cfg)
        _, _, r, _, _ = env._finish(s, sim)
        (g,) = torch.autograd.grad(r, a)
        _assert_bitwise(gb[i], g, f"env {i}")


@pytest.mark.gpu
@needs_cuda
def test_backward_replays_read_nothing_to_the_host():
    """The compiled gradient's backward under the sync debug mode "error"
    (its one host read, the body counters at its end, deferred): no
    operation of the backward waits on the device, and it launches one
    graph a step. A resting box that parks inside the window, with the
    persistent broadphase."""
    b = scenes.scene_single_box(0.5)
    cfg = b.auto_config(differentiable=True, sleeping=True, sleep_frames=2,
                        max_colors=4, solver_iters=4,
                        persistent_broadphase=True)
    st0 = b.finalize(cfg, device="cuda")
    for _ in range(2):         # the first call captures
        v = st0.bodies.vel.clone().requires_grad_()
        st, m = engine.simulate(st0.replace(bodies=st0.bodies.replace(vel=v)),
                                cfg, 8)
        loss = torch.sum(st.bodies.pos ** 2) + m.kinetic_energy.sum()
        deferred, finish = [], control.GradStep.finish
        control.GradStep.finish = lambda step: deferred.append(step)
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            (g,) = torch.autograd.grad(loss, v)
        finally:
            torch.cuda.set_sync_debug_mode(old)
            control.GradStep.finish = finish
        for step in deferred:
            finish(step)
    assert [step.replays for step in deferred] == [8]
    assert bool(torch.isfinite(g).all())
