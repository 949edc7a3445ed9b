"""The port's tracing (nudge_tpu_torch/trace.py): off by default and then
recording nothing, the eager step's stage spans in order under its step
span, live counts (in the reference mode the `sleep` stage and the
rebuild and sleep counts, equal to what the step did), spans that nest and
share their call's id, the Recorder's rows read back onto the host clock,
and the compiled caches keyed on the tracing state.

The cases marked `gpu` hold the traced graphs to the untraced ones on the
card: bitwise the same rollout and gradient, the untraced graph's nodes
unchanged, stamps that rise through each replay and tile it, in-graph
counts equal to the eager step's (in the reference mode too), and the
clock calibration's error bound; they skip without a CUDA device."""

import pytest
import torch

from nudge_tpu_torch import control, engine, scenes, trace
from nudge_tpu_torch.state import flatten

torch.set_num_threads(2)

needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")

STAGES = ["collide", "cache_read", "coloring", "setup", "solve",
          "cache_write", "advance"]
COUNTS = {"pairs", "manifolds", "points", "bodies", "colors"}
# the reference mode: `sleep` (update_sleep, the metrics) after `advance`,
# the broadphase's rebuild decision and sleeping's net flag changes
REF_STAGES = STAGES + ["sleep"]
REF_COUNTS = COUNTS | {"rebuilt", "fell_asleep", "woke"}
# on the card the cached coloring's kernel also counts the rounds it ran,
# and the cache join its hits and the cache-table slots it read
KERNEL_COUNTS = {"claim_rounds", "cache_hits", "cache_probes"}
CARD_COUNTS = COUNTS | KERNEL_COUNTS


@pytest.fixture(autouse=True)
def _clean():
    trace.collect()
    yield
    trace.collect()


def _pile(n=48, device="cpu", **kw):
    b = scenes.scene_pile(n, seed=2)
    cfg = b.auto_config(broadphase="grid", **kw)
    st = b.finalize(cfg, device=device)
    for _ in range(12):            # into contact
        st, _ = engine.step(st, cfg)
    return st, cfg


def _bitwise(a, b):
    la, lb = flatten(a)[0], flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_off_by_default_and_on_restores():
    assert not trace.enabled()
    with trace.on():
        assert trace.enabled()
        with trace.on():
            assert trace.enabled()
        assert trace.enabled()
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")      # one shared null context


@pytest.mark.parametrize("kw", [{}, {"sleeping": True,
                                     "persistent_broadphase": True}],
                         ids=["awake", "reference_mode"])
def test_off_records_nothing_and_the_traced_step_is_bitwise(kw):
    st, cfg = _pile(**kw)
    trace.collect()
    off = engine.step(st, cfg)
    got = trace.collect()
    assert got.spans == [] and got.replays == []
    with trace.on():
        on = engine.step(st, cfg)
    assert trace.collect().spans
    _bitwise(off, on)


def test_eager_step_records_each_stage_once_in_order():
    st, cfg = _pile()
    with trace.on():
        engine.step(st, cfg)
    spans = trace.collect().spans
    (step,) = [s for s in spans if s.name == "step"]
    assert step.parent is None and step.call == step.id
    kids = sorted((s for s in spans if s.parent == step.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == STAGES
    assert all(s.call == step.id for s in kids)
    assert kids[0].start_ns == step.start_ns and kids[-1].end_ns <= step.end_ns
    for a, b in zip(kids, kids[1:]):         # they tile the step's stages
        assert a.end_ns == b.start_ns and a.start_ns <= a.end_ns
    assert set(step.counts) == COUNTS
    assert step.counts["manifolds"] > 0 and step.counts["colors"] >= 1
    assert step.counts["points"] >= step.counts["manifolds"]
    assert step.counts["bodies"] == int((st.bodies.inv_mass > 0).sum())


def test_parked_step_records_no_stages():
    """An all-asleep scene parks: its step span has no stage and no
    count."""
    b = scenes.scene_single_box(0.5)
    cfg = b.auto_config(sleeping=True, sleep_frames=2)
    st = b.finalize(cfg, device="cpu")
    for _ in range(80):
        st, m = engine.step(st, cfg)
        if int(m.awake_count) == 0:
            break
    else:
        pytest.fail("the box never slept")
    p0 = engine.step.parked
    with trace.on():
        engine.step(st, cfg)
    assert engine.step.parked == p0 + 1
    spans = trace.collect().spans
    assert [s.name for s in spans] == ["step"] and spans[0].counts == {}


@pytest.mark.parametrize("kw, stages, counts", [
    ({"persistent_broadphase": True}, STAGES, COUNTS | {"rebuilt"}),
    ({"sleeping": True}, REF_STAGES, COUNTS | {"fell_asleep", "woke"}),
    ({"sleeping": True, "persistent_broadphase": True}, REF_STAGES,
     REF_COUNTS),
], ids=["persistent_bp", "sleeping", "reference_mode"])
def test_each_mode_records_its_stages_and_counts(kw, stages, counts):
    """Sleeping adds the `sleep` stage after `advance` and the
    `fell_asleep` and `woke` counts, the persistent broadphase the
    `rebuilt` count (with both off the awake step's stages and counts:
    `test_eager_step_records_each_stage_once_in_order`)."""
    st, cfg = _pile(24, **kw)
    with trace.on():
        engine.step(st, cfg)
    spans = trace.collect().spans
    (step,) = [s for s in spans if s.name == "step"]
    kids = sorted((s for s in spans if s.parent == step.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == stages
    assert set(step.counts) == counts


def _traced_step(st, cfg):
    """One eager step with tracing on: (state, its step span's counts,
    its stage names, the fat rebuilds it took)."""
    from nudge_tpu_torch.ops import persistent_bp

    r0 = persistent_bp.persistent_broadphase.rebuilds
    with trace.on():
        out, _ = engine.step(st, cfg)
    spans = trace.collect().spans
    (step,) = [s for s in spans if s.name == "step"]
    names = [s.name for s in sorted((s for s in spans if s.parent == step.id),
                                    key=lambda s: s.start_ns)]
    return (out, step.counts, names,
            persistent_bp.persistent_broadphase.rebuilds - r0)


def test_reference_mode_counts_equal_what_the_step_did():
    """In the reference mode every eager step stamps `sleep` after
    `advance`, and its counts are what it did: `rebuilt` the fat rebuilds
    the broadphase's counter took, `fell_asleep` and `woke` the bodies
    whose awake flag it cleared and set. The pile falls into contact
    awake, is put to sleep under test-only thresholds (5 m/s, 2 frames),
    and a sleeper given 3 m/s down wakes its neighbours."""
    b = scenes.scene_pile(24, seed=2)
    cfg = b.auto_config(broadphase="grid", sleeping=True,
                        persistent_broadphase=True)
    drowsy = cfg.replace(sleep_lin_vel=5.0, sleep_ang_vel=5.0,
                         sleep_frames=2)
    st = b.finalize(cfg, device="cpu")
    seen = {"rebuilt": set(), "fell_asleep": 0, "woke": 0}

    def step(st, cfg):
        out, counts, names, rebuilds = _traced_step(st, cfg)
        assert names == REF_STAGES and set(counts) == REF_COUNTS
        before, after = st.sleep.awake, out.sleep.awake
        assert counts["rebuilt"] == rebuilds
        assert counts["fell_asleep"] == int((before & ~after).sum())
        assert counts["woke"] == int((after & ~before).sum())
        seen["rebuilt"].add(counts["rebuilt"])
        seen["fell_asleep"] += counts["fell_asleep"]
        seen["woke"] += counts["woke"]
        return out

    for _ in range(12):            # into contact, awake
        st = step(st, cfg)
    for _ in range(2):             # to sleep: idle 2 frames at the latest
        st = step(st, drowsy)
    asleep = st.bodies.dynamic & ~st.sleep.awake
    assert seen["fell_asleep"] == int(asleep.sum()) > 0
    # a sleeper of a parked pair (two sleepers in contact), awake and fast:
    # it wakes the other and the flood its island
    pairs = st.sleep.pairs
    assert bool((pairs[:, 0] >= 0).any())
    k = int(pairs[0, 0])
    vel, awake = st.bodies.vel.clone(), st.sleep.awake.clone()
    vel[k, 1], awake[k] = -3.0, True
    st = st.replace(bodies=st.bodies.replace(vel=vel),
                    sleep=st.sleep.replace(awake=awake))
    st = step(st, cfg)
    assert seen["woke"] > 0 and seen["rebuilt"] == {0, 1}


def test_simulate_spans_nest_and_share_the_call_id():
    st, cfg = _pile(24)
    with trace.on():
        engine.simulate(st, cfg, 2)
        engine.simulate(st, cfg, 1)
    spans = trace.collect().spans
    tops = [s for s in spans if s.parent is None]
    assert [s.name for s in tops] == ["simulate", "simulate"]
    for top in tops:
        mine = [s for s in spans if s.call == top.id]
        assert all(s.start_ns >= top.start_ns and s.end_ns <= top.end_ns
                   for s in mine)
    steps = [s for s in spans if s.name == "step"]
    assert [sum(s.call == t.id for s in steps) for t in tops] == [2, 1]
    ids = {s.id for s in spans}
    assert len(ids) == len(spans)
    assert all(s.parent in ids for s in spans if s.parent is not None)


def test_span_inside_a_traced_capture_records_nothing(monkeypatch):
    """While a traced graph is captured a span is the null context, a stage
    goes to the Recorder and nothing reaches the host spans."""
    got = []

    class Rec:
        def stamp(self, name):
            got.append(name)

    monkeypatch.setattr(trace, "_REC", Rec())
    with trace.on():
        with trace.span("load"):
            trace.stage("collide")
    assert got == ["collide"] and trace.collect().spans == []


def test_recorder_rows_read_back_on_the_host_clock(monkeypatch):
    """A Recorder's rows (slots as the capture added them; -1 where a
    replay wrote nothing) become Replays: stamps in slot order moved by
    the calibrated offset, unset ones None, counts as they are, under the
    span open when they were moved out."""
    rec = trace.Recorder("step", 4, torch.zeros(1, dtype=torch.int64))
    for name, kind in (("start", "stamp"), ("pairs", "count"),
                       ("collide", "stamp"), ("tail", "stamp")):
        rec._slot(name, kind)
    rec.rows[0, :4] = torch.tensor([100, 7, 130, 190])
    rec.rows[1, :4] = torch.tensor([300, -1, -1, 350])
    rec.row.fill_(1)
    rec.put("points", torch.tensor(42, dtype=torch.int32))
    assert int(rec.rows[1, 4]) == 42
    monkeypatch.setattr(trace, "calibrate", lambda dev: (1000, 3))
    rec.next()
    rec.next()
    with trace.on(), trace.span("launch"):
        rec.keep()
    assert int(rec.row) == 0 and rec.used == 0
    rec.flush()
    got = trace.collect()
    (launch,) = got.spans
    a, b = got.replays
    assert a.stamps == [("start", 1100), ("collide", 1130), ("tail", 1190)]
    assert b.stamps == [("start", 1300), ("collide", None), ("tail", 1350)]
    assert a.counts == {"pairs": 7, "points": None}
    assert b.counts == {"pairs": None, "points": 42}
    assert (a.graph, a.parent, a.call, a.error_ns) == ("step", launch.id,
                                                        launch.id, 3)
    assert rec.kept == [] and trace.collect().replays == []


def test_recorder_keeps_its_rows_when_full_and_flushes_the_rest(monkeypatch):
    """An owner that calls `next` before each replay and `flush` at its end
    gets every replay back in order, however many rows the Recorder has:
    full rows are kept (and the row counter zeroed) before the replay that
    would overwrite them."""
    rec = trace.Recorder("grad", 2, torch.zeros(1, dtype=torch.int64))
    rec._slot("start", "stamp")
    monkeypatch.setattr(trace, "calibrate", lambda dev: (10, 1))
    for k in range(5):
        rec.next()
        rec.rows[int(rec.row), 0] = 100 + k     # what a replay writes
        rec.row.add_(1)
    assert len(rec.kept) == 2 and rec.used == 1
    rec.flush()
    got = trace.collect().replays
    assert [r.stamps for r in got] == [[("start", 110 + k)]
                                       for k in range(5)]
    assert rec.kept == [] and rec.used == 0 and int(rec.row) == 0


def test_compiled_keys_its_cache_on_the_tracing_state(monkeypatch):
    made = []

    class Fake:
        def __init__(self, fn, cfg, state):
            made.append(trace.enabled())

    monkeypatch.setattr(control, "Compiled", Fake)
    monkeypatch.setattr(control, "_CACHE", {})
    st, cfg = _pile(8)
    off = control.compiled(engine.step, cfg, st)
    with trace.on():
        on = control.compiled(engine.step, cfg, st)
        assert control.compiled(engine.step, cfg, st) is on
    assert on is not off and control.compiled(engine.step, cfg, st) is off
    assert made == [False, True]


def test_compiled_grad_keys_its_cache_on_the_tracing_state(monkeypatch):
    monkeypatch.setattr(control, "_GRAD_CACHE", {})
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=4, solver_iters=2)
    st = b.finalize(cfg, device="cpu")
    need = [t is st.bodies.vel for t in flatten(st)[0]]
    off = control.compiled_grad(engine.step, cfg, st, need)
    with trace.on():
        on = control.compiled_grad(engine.step, cfg, st, need)
        assert control.compiled_grad(engine.step, cfg, st, need) is on
    assert on is not off
    assert control.compiled_grad(engine.step, cfg, st, need) is off
    assert on.rec is None and off.rec is None      # no graph on the CPU


# --- on the card -------------------------------------------------------------

def _card_pile(n=2048):
    b = scenes.scene_pile(n, seed=1)
    cfg = b.auto_config()
    return b.finalize(cfg, device="cuda"), cfg


@pytest.mark.gpu
@needs_cuda
def test_traced_rollout_and_gradient_are_bitwise_the_untraced():
    """100 pile steps and a 100-step gradient through the traced graphs:
    the untraced graphs' state, metrics and gradient, bit for bit."""
    st, cfg = _card_pile()
    off = engine.simulate(st, cfg, 100)
    with trace.on():
        on = engine.simulate(st, cfg, 100)
    _bitwise(off, on)
    assert len(trace.collect().replays) == 100

    b = scenes.scene_pile(64, seed=0)
    gcfg = b.auto_config(differentiable=True)
    st0 = b.finalize(gcfg, device="cuda")

    def grad():
        v = st0.bodies.vel.clone().requires_grad_()
        out, m = engine.simulate(
            st0.replace(bodies=st0.bodies.replace(vel=v)), gcfg, 100)
        loss = out.bodies.pos[:, 1].sum() + 1e-3 * m.kinetic_energy.sum()
        return loss.detach(), torch.autograd.grad(loss, v)[0]

    g_off = grad()
    with trace.on():
        g_on = grad()
    _bitwise(g_off, g_on)
    got = trace.collect().replays
    assert sum(r.graph == "grad" for r in got) == 100
    assert sum(r.graph == "step" for r in got) == 100


def _nodes(graph) -> int:
    from nudge_tpu_torch.utils import timing

    return sum(timing._node_kinds(graph.raw_cuda_graph()).values())


@pytest.mark.gpu
@needs_cuda
def test_untraced_graph_keeps_its_nodes():
    """The untraced capture has the same nodes before and after a traced
    capture of the same step, captured again; the traced one adds its
    stamps and counts."""
    st, cfg = _card_pile(512)
    control.clear()
    before = _nodes(control.compiled(engine.step, cfg, st).graph)
    with trace.on():
        traced = control.compiled(engine.step, cfg, st)
    control._CACHE.pop(control._key(engine.step, cfg, st))
    after = _nodes(control.compiled(engine.step, cfg, st).graph)
    assert before == after
    stamps = traced.rec.kinds.count("stamp")
    assert stamps == len(STAGES) + 2
    assert _nodes(traced.graph) >= before + stamps + len(COUNTS)


@pytest.mark.gpu
@needs_cuda
def test_stamps_rise_through_each_replay_and_tile_it():
    st, cfg = _card_pile()
    with trace.on():
        engine.simulate(st, cfg, 2 * control.METRIC_ROWS + 5)
    got = trace.collect()
    assert len(got.replays) == 2 * control.METRIC_ROWS + 5
    (launch,) = [s for s in got.spans if s.name == "launch"]
    for r in got.replays:
        names = [n for n, _ in r.stamps]
        assert names == ["start"] + STAGES + ["tail"]
        ns = [t for _, t in r.stamps]
        assert all(t is not None for t in ns)
        assert all(a <= b for a, b in zip(ns, ns[1:]))
        assert launch.start_ns < ns[0] and r.parent == launch.id
    starts = [r.stamps[0][1] for r in got.replays]
    assert starts == sorted(starts)


@pytest.mark.gpu
@needs_cuda
def test_graph_counts_equal_the_eager_step_counts():
    st, cfg = _card_pile()
    st, _ = engine.simulate(st, cfg, 60)
    with trace.on():
        engine.step(st, cfg)
        eager = [s for s in trace.collect().spans if s.name == "step"][0]
        engine.simulate(st, cfg, 1)       # captures
        trace.collect()
        engine.simulate(st, cfg, 1)
    (r,) = trace.collect().replays
    assert r.counts == eager.counts and set(r.counts) == CARD_COUNTS
    assert r.counts["points"] > 0


@pytest.mark.gpu
@needs_cuda
def test_reference_mode_graph_counts_equal_the_eager_step_counts():
    """With sleeping and the persistent broadphase the traced graph stamps
    `sleep` after `advance`, and its counts (`rebuilt`, `fell_asleep`,
    `woke` too) equal the eager step's from the same state."""
    b = scenes.scene_pile(2048, seed=1)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    st, _ = engine.simulate(b.finalize(cfg, device="cuda"), cfg, 60)
    with trace.on():
        engine.step(st, cfg)
        eager = [s for s in trace.collect().spans if s.name == "step"][0]
        engine.simulate(st, cfg, 1)       # captures
        trace.collect()
        engine.simulate(st, cfg, 1)
    (r,) = trace.collect().replays
    assert [n for n, _ in r.stamps] == ["start"] + REF_STAGES + ["tail"]
    assert all(t is not None for _, t in r.stamps)
    assert r.counts == eager.counts
    assert set(r.counts) == REF_COUNTS | KERNEL_COUNTS


@pytest.mark.gpu
@needs_cuda
def test_calibration_error_bound_is_under_50_us():
    dev = torch.device("cuda")
    got = [trace.calibrate(dev) for _ in range(20)]
    print("calibration errors (ns):", sorted(err for _, err in got))
    assert max(err for _, err in got) < 50_000
    offsets = [off for off, _ in got]
    assert max(offsets) - min(offsets) < 100_000
