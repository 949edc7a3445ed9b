"""The settling entry (`harness/entries/simulate_settle.py`) and the
reference mode's readers, on the CPU at a tiny size: a tiny settle cell
(`tinys.rollout`: `pile20k-ref` cut to scene seed 3's 64-box pile with
test-only sleep settings, 0.5 m/s and rad/s for 4 frames, so that it is
half asleep within a few calls of 4 steps; episodes of 2 calls) added as
files to a copy of the benchmark. The scene is the configuration's scene seed's, whatever
the run's seed; the warm calls reach the share and every episode starts
from the same start state; a warm call that fails a gate (an overflow, a
non-finite state, a penetration of 0.5 m) fails set-up; the sound run is
correct, and a start state with one sleeper woken or a
call's output altered is not. The readers of the `sleep` stage and the
rebuild counts read the eager steps' stage spans and counts as the
replays a traced graph gives, and are silent on a program without them.

With `-m gpu`, `pile20k-ref.rollout` at its own size on three seeds with
the reference in bfloat16 in the program's place (the control) comes out
not correct, its numbers printed beside their limits:

    python -m pytest -p no:cacheprovider -m gpu -s \\
        benchmark/tests/test_bench_settle.py
"""

import json
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
import tiny_bench

CELL = "tinys.rollout"
SEED = 2 ** 31 + 17
READERS = ("stage_ms.sleep", "rebuild_pct", "collide_ms.rebuild.p50",
           "collide_ms.refilter.p50")
CONTROL_SEEDS = (2 ** 31 + 7, 3_000_000_023, 777_777)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    spec, bd = tiny_bench.make(tmp_path_factory.mktemp("bench"))
    config = json.loads((bd / "configs/pile20k-ref.json").read_text())
    # a 64-box pile whose episode from the start both rebuilds and refilters
    config["scene"].update(n_bodies=64, scene_seed=3)
    config["sim"].update(max_box_box_pairs=512, max_manifolds=192,
                         broadphase="grid", sleep_lin_vel=0.5,
                         sleep_ang_vel=0.5, sleep_frames=4)
    traffic = json.loads((bd / "traffic/settle_300x100.json").read_text())
    traffic.update(calls_per_episode=2, steps_per_call=4, max_warm_calls=12)
    files = {"configs/tinys.json": config,
             "traffic/tiny_settle.json": traffic,
             f"limits/{CELL}.json": json.loads(
                 (bd / "limits/pile20k-ref.rollout.json").read_text())}
    for rel, obj in files.items():
        assert not (bd / rel).exists(), rel
        (bd / rel).write_text(json.dumps(obj))
    spec["workloads"].append({"name": CELL, "config": "tinys",
                              "traffic": "tiny_settle", "chips": 1,
                              "why": "a CPU test's tiny cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "pile20k-ref.rollout" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return spec, bd


def _entry(bench, seed=SEED):
    from harness import cell, registry, system

    spec, bd = bench
    c = registry.Cell(spec, CELL, bd)
    sysm = system.build(c.config, seed, "cpu")
    return c, sysm, cell._entry(c, sysm, np.random.default_rng(seed))


def _awake(state) -> int:
    return int((state.bodies.dynamic & state.sleep.awake).sum())


def _clone(state):
    from nudge_tpu_torch.state import tree_map

    return tree_map(lambda t: t.clone(), state)


def _equal(a, b) -> bool:
    from nudge_tpu_torch.state import flatten

    return all(x.dtype == y.dtype and bool((x == y).all())
               for x, y in zip(flatten(a)[0], flatten(b)[0]))


def test_warm_reaches_the_share_and_every_episode_starts_there(bench):
    _, sysm, entry = _entry(bench)
    entry.warm()
    n = sysm.n_dynamic
    (s_in, s_out, m), = entry.kept       # the last warm call, checked
    assert s_out is entry.start
    assert _awake(entry.start) == int(m.awake_count[-1]) <= entry.share * n
    assert _awake(s_in) > entry.share * n     # the first call that reaches it
    assert 0 < _awake(entry.start)             # half asleep, not parked
    start = _clone(entry.start)
    for ep in range(2):
        entry.start_episode(ep)
        assert entry.state is entry.start
        for c in range(entry.calls):
            entry.call(c)
        entry.end_episode()
    assert _equal(entry.start, start)
    assert bool((entry.prints[0] == entry.prints[-1]).all())
    assert len(entry.kept) == 1 + entry.calls


def test_warm_fails_loudly_short_of_the_share(bench, monkeypatch):
    _, _, entry = _entry(bench)
    monkeypatch.setattr(entry, "max_warm", 1)
    with pytest.raises(RuntimeError, match="not reached"):
        entry.warm()


def _patch_simulate(monkeypatch, at: int, edit):
    """engine.simulate whose call number `at` has `edit(metrics, state)`
    applied to its output."""
    from nudge_tpu_torch import engine

    real, seen = engine.simulate, []

    def simulate(state, cfg, steps):
        out, m = real(state, cfg, steps)
        if len(seen) == at:
            edit(m, out)
        seen.append(1)
        return out, m

    monkeypatch.setattr(engine, "simulate", simulate)


def test_warm_call_that_overflows_fails_set_up(bench, monkeypatch):
    _, _, entry = _entry(bench)
    _patch_simulate(monkeypatch, 1, lambda m, s: m.overflow[3].fill_(True))
    with pytest.raises(RuntimeError, match="failed a gate: overflow$"):
        entry.warm()


def test_warm_call_with_a_non_finite_state_fails_set_up(bench, monkeypatch):
    _, _, entry = _entry(bench)
    _patch_simulate(monkeypatch, 0,
                    lambda m, s: s.bodies.vel[2, 0].fill_(float("nan")))
    with pytest.raises(RuntimeError, match="failed a gate: non-finite state$"):
        entry.warm()


def test_warm_call_past_the_depth_gate_fails_set_up(bench, monkeypatch):
    _, _, entry = _entry(bench)
    _patch_simulate(monkeypatch, 1, lambda m, s: m.max_depth[1].fill_(0.5))
    with pytest.raises(RuntimeError, match="failed a gate: penetration"):
        entry.warm()


def test_deepest_penetration_on_the_way_is_printed(bench, monkeypatch,
                                                   capsys):
    _, _, entry = _entry(bench)
    _patch_simulate(monkeypatch, 0, lambda m, s: m.max_depth[1].fill_(0.4321))
    entry.warm()
    assert "deepest penetration on the way 0.4321 m" in capsys.readouterr().err


def test_scene_is_the_scene_seeds_whatever_the_run_seed(bench):
    """Two run seeds build the same spawn, the scene seed's, and the
    reference rebuilds that spawn for either."""
    from harness import check, registry, system
    from nudge_tpu_torch import scenes

    spec, bd = bench
    c = registry.Cell(spec, CELL, bd)
    scene = c.config["scene"]
    a, b = (system.build(c.config, s, "cpu") for s in (SEED, 5))
    assert _equal(a.state, b.state)
    own = scenes.scene_pile(scene["n_bodies"], seed=scene["scene_seed"])
    assert _equal(a.state, own.finalize(a.cfg, device="cpu"))
    other = scenes.scene_pile(scene["n_bodies"], seed=SEED)
    assert not _equal(a.state, other.finalize(a.cfg, device="cpu"))
    for s in (SEED, 5):
        cmp = check.Comparison(a.cfg)
        cmp.spawn(a.state, system.reference_spawn(c.config, s, a.cfg, "cpu"))
        assert cmp.numbers["spawn_mismatch"] == 0


def test_sound_run_is_correct(bench):
    result = tiny_bench.run(*bench, CELL)
    assert result["correct"], result["limits"]
    assert result["failed"] == 0


def test_start_state_with_a_sleeper_woken(bench, monkeypatch):
    from harness.entries import simulate_settle

    real = simulate_settle.Entry.warm

    def woken(self):
        real(self)
        awake = self.start.sleep.awake
        asleep = self.start.bodies.dynamic & ~awake
        awake[int(asleep.nonzero()[0, 0])] = True

    monkeypatch.setattr(simulate_settle.Entry, "warm", woken)
    result = tiny_bench.run(*bench, CELL)
    assert not result["correct"]
    assert result["limits"]["int_mismatch"][0] >= 1


def test_call_output_altered_where_produced(bench, monkeypatch):
    """The step that ends each episode's first call lifts body 5 by 0.1 m:
    the window's and the check's re-run alike."""
    from harness.entries import simulate_settle
    from nudge_tpu_torch import engine

    real_warm, real_step = simulate_settle.Entry.warm, engine.step

    def warm(self):
        real_warm(self)
        last = int(self.start.step_count) + self.steps

        def step(state, cfg):
            out, m = real_step(state, cfg)
            if int(out.step_count) == last:
                pos = out.bodies.pos.clone()
                pos[5, 1] += 0.1
                out = out.replace(bodies=out.bodies.replace(pos=pos))
            return out, m

        vars(step).update(vars(real_step))
        monkeypatch.setattr(engine, "step", step)

    monkeypatch.setattr(simulate_settle.Entry, "warm", warm)
    result = tiny_bench.run(*bench, CELL)
    assert not result["correct"]
    assert result["limits"]["pos_gap_m"][0] >= 0.05


def _as_replays(spans) -> list:
    """The eager steps' host spans as the replays of a traced graph: a stamp
    at the end of each stage span, the step span's counts; a parked step
    (no stage span) is left out."""
    out = []
    for s in spans:
        kids = sorted((k for k in spans if k.parent == s.id),
                      key=lambda k: k.start_ns)
        if s.name != "step" or not kids:
            continue
        stamps = ([("start", s.start_ns)] + [(k.name, k.end_ns) for k in kids]
                  + [("tail", s.end_ns)])
        out.append(NS(graph="step", stamps=stamps, counts=dict(s.counts),
                      call=s.call, parent=s.parent))
    return out


def test_readers_read_the_eager_stages_and_counts(bench):
    """On the program's own stage and count names the three readers return
    numbers (from the active steps of one episode from the start state);
    without the `sleep` stamp and the three counts, as a program that has
    none records, they are silent."""
    from harness import cell, program_trace
    from nudge_tpu_torch import trace

    c, sysm, entry = _entry(bench)
    entry.warm()
    with trace.on():
        entry.start_episode(-1)
        for k in range(entry.calls):
            entry.call(k)
    spans = trace.collect().spans
    replays = _as_replays(spans)
    assert len(replays) >= 2
    run = cell.TraceRun(c, sysm, entry)
    run.program_trace = program_trace.ProgramTrace(spans, replays)
    got = {name: c.reader(name).read(run) for name in READERS}

    stages = [program_trace.stages_ms(r) for r in replays]
    rebuilt = [r.counts["rebuilt"] for r in replays]
    assert set(rebuilt) == {0, 1}
    assert got["stage_ms.sleep"] == program_trace.median(
        [st["sleep"] for st in stages]) > 0
    assert got["rebuild_pct"] == 100.0 * sum(rebuilt) / len(rebuilt)
    for name, b in (("collide_ms.rebuild.p50", 1),
                    ("collide_ms.refilter.p50", 0)):
        assert got[name] == program_trace.median(
            [st["collide"] for st, r in zip(stages, rebuilt) if r == b])
    assert all(isinstance(v, float) for v in got.values())

    for r in replays:                       # a program without them
        r.stamps = [(n, t) for n, t in r.stamps if n != "sleep"]
        for name in ("rebuilt", "fell_asleep", "woke"):
            r.counts.pop(name)
    assert {name: c.reader(name).read(run) for name in READERS} == \
        dict.fromkeys(READERS)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_control_fails_on_the_card(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell's own size runs on the card")
    from harness import registry
    from harness.cell import run_cell

    cell = registry.Cell(registry.load_spec(tiny_bench.ROOT),
                         "pile20k-ref.rollout")
    result = run_cell(cell, seed, 0.01, False, "cuda:0", time.perf_counter(),
                      control=torch.bfloat16)
    print(f"\ncontrol pile20k-ref.rollout seed {seed}: "
          + " ".join(f"{k}={v!r}/{lim!r}"
                     for k, (v, lim) in result["limits"].items()))
    assert not result["correct"]
