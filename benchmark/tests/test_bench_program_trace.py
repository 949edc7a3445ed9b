"""The arithmetic of the readers of the program's own trace
(`harness/program_trace.py`) on synthetic stamp rows and spans, and one
traced episode of a tiny cell on the CPU: the entry as it was afterwards,
its fingerprints extended by the traced episode."""

from types import SimpleNamespace as NS

import pytest
import tiny_bench

from harness import program_trace as pt
from harness import roofline

STEP = ["start", "collide", "cache_read", "coloring", "setup", "solve",
        "cache_write", "advance", "tail"]


def replay(t0, widths, graph="step", names=STEP, counts=None, call=1):
    """A replay whose stamps start at t0 (ns) and step by `widths` (None:
    a stamp its body left unset)."""
    stamps, t = [(names[0], t0)], t0
    for name, w in zip(names[1:], widths):
        if w is None:
            stamps.append((name, None))
        else:
            t += w
            stamps.append((name, t))
    return NS(graph=graph, stamps=stamps, counts=counts or {}, call=call,
              parent=None)


def test_stages_tile_a_replay_and_parked_steps_are_skipped():
    w = [1_000_000, 200_000, 300_000, 40_000, 1_400_000, 100_000, 500_000,
         60_000]
    active = replay(0, w)
    parked = replay(10 ** 9, [None] * 7 + [30_000])
    st = pt.stages_ms(active)
    assert st == {n: v * 1e-6 for n, v in zip(STEP[1:], w)}
    assert pt.stages_ms(parked) is None
    groups = {g: pt.stage_group_ms([active, parked], g)
              for g in pt.STAGE_GROUPS}
    assert groups["cache"] == [pytest.approx(0.3)]
    assert groups["advance"] == [pytest.approx(0.56)]
    assert groups["solve"] == [pytest.approx(1.4)]
    assert sum(v[0] for v in groups.values()) == pytest.approx(
        (active.stamps[-1][1] - active.stamps[0][1]) * 1e-6)


def test_stage_median_over_steps():
    rs = [replay(k * 10 ** 8, [k * 1_000_000] + [1] * 7) for k in (1, 2, 9)]
    assert pt.median(pt.stage_group_ms(rs, "collide")) == 2.0
    assert pt.median([]) is None


def test_solve_share_from_the_steps_own_counts():
    counts = {"points": 80_000, "manifolds": 30_000, "bodies": 20_480,
              "pairs": 50_000, "colors": 6}
    r = replay(0, [1, 1, 1, 1, 1_375_000, 1, 1, 1], counts=counts)
    empty = replay(0, [1] * 8, counts=dict(counts, points=0))
    got = pt.solve_shares_pct([r, empty], 20)
    bound, _ = roofline.bound(*roofline.solve_work(80_000, 30_000, 20_480,
                                                   20))
    assert got == [pytest.approx(100 * bound / 1.375)]
    assert 0 < got[0] < 100


def test_backward_halves_and_the_gaps_between_replays():
    names = ["start", "collide", "recompute", "adjoint"]
    a = replay(1_000, [2_000_000, 4_000_000, 5_000_000], "grad", names)
    b = replay(a.stamps[-1][1] + 700_000, [1_000_000, 5_000_000,
                                            6_000_000], "grad", names)
    c = replay(b.stamps[-1][1] + 900_000, [1, 1, 1], "grad", names, call=2)
    assert pt.span_ms(a, "start", "recompute") == pytest.approx(6.0)
    assert pt.span_ms(a, "recompute", "adjoint") == pytest.approx(5.0)
    gaps = pt.gaps_ns([c, b, a], by_call=True)
    assert [(y - x) * 1e-6 for x, y in gaps] == [pytest.approx(0.7)]
    assert len(pt.gaps_ns([c, b, a])) == 2


def test_frame_lead_and_gap_shares():
    f1 = replay(10_000, [100] * 8, call=1)
    f2 = replay(50_000, [100] * 8, call=7)
    spans = [NS(name="step_jit", start_ns=1_000, end_ns=11_000, parent=None,
                call=1, id=1),
             NS(name="finish", start_ns=10_900, end_ns=20_800, parent=1,
                call=1, id=2),
             NS(name="step_jit", start_ns=40_800, end_ns=51_000, parent=None,
                call=7, id=7),
             NS(name="load", start_ns=44_800, end_ns=46_800, parent=7, call=7,
                id=8)]
    assert pt.leads_ms(spans, [f1, f2], "step_jit") == [
        pytest.approx(9e-3), pytest.approx(9.2e-3)]
    gaps = pt.gaps_ns([f2, f1])
    assert gaps == [(10_800, 50_000)]
    shares = pt.gap_shares(spans, gaps)
    total = 50_000 - 10_800
    assert shares == {"step_jit": pytest.approx(7_300 / total),
                      "finish": pytest.approx(9_900 / total),
                      "outside": pytest.approx(20_000 / total),
                      "load": pytest.approx(2_000 / total)}
    assert sum(shares.values()) == pytest.approx(1.0)


def test_traced_episode_puts_the_entry_back(tmp_path):
    """On the CPU a tiny rollout cell's traced episode records host spans
    (no graph: no replays), keeps nothing for the check, and leaves the
    entry as it was, its fingerprints one episode longer."""
    import numpy as np

    from harness import cell, registry, system

    spec, bd = tiny_bench.make(tmp_path)
    c = registry.Cell(spec, "tiny.rollout", bd)
    sysm = system.build(c.config, 5, "cpu")
    entry = cell._entry(c, sysm, np.random.default_rng(5))
    entry.start_episode(0)
    for k in range(entry.calls):
        entry.call(k)
    entry.end_episode()
    before = {a: getattr(entry, a) for a in pt.ENTRY_ATTRS
              if hasattr(entry, a)}
    kept = list(entry.kept)
    run = cell.TraceRun(c, sysm, entry)
    tr = pt.episode(run)
    assert pt.episode(run) is tr
    assert tr.replays == []
    tops = [s.name for s in tr.spans if s.parent is None]
    assert tops == ["simulate"] * entry.calls
    stages = [s.name for s in tr.spans if s.name == "solve"]
    assert len(stages) == entry.calls * entry.steps
    assert all(getattr(entry, a) is v for a, v in before.items())
    assert entry.kept == kept and len(entry.prints) == 2
    assert bool((entry.prints[0] == entry.prints[-1]).all())


def test_tiling_note_sets_the_stages_beside_the_events():
    w = [1_000_000, 200_000, 300_000, 40_000, 1_400_000, 100_000, 500_000,
         60_000]
    steps = [replay(k * 10 ** 8, w, call=k + 5) for k in range(3)]
    spans = NS(replay_ms=lambda: [(360.0, 100, 0), (361.0, 100, 1),
                                  (370.0, 100, 2)])
    events = [(180.0, 50, 0), (181.0, 50, 0), (362.0, 100, 1),
              (366.0, 100, 2)]
    note = pt.tiling_note(NS(spans=spans),
                          pt.ProgramTrace([], steps, events))
    assert note == ("stage_ms: the six medians sum to 3.600000 ms; CUDA "
                    "events around the traced replays 3.620000 ms a step, "
                    "around the untraced ones 3.610000 (medians of calls); "
                    "stamped replays 3.600000 ms; by call, untraced "
                    "events/traced events/stamped ms a step: "
                    "3.600/3.610/3.600, 3.610/3.620/3.600, "
                    "3.700/3.660/3.600")
    assert pt.tiling_note(NS(spans=spans), pt.ProgramTrace([], [])) == \
        "stage_ms: no active step"


def test_colors_and_collide_time_a_pair_from_the_steps_own_counts():
    """The `colors` and `pairs` counts of active steps only; a step with
    no live pair has no time a pair."""
    w = [2_000_000] + [1] * 7
    rs = [replay(0, w, counts={"colors": 6, "pairs": 40_000}),
          replay(0, w, counts={"colors": 8, "pairs": 0}),
          replay(0, [None] * 7 + [1], counts={"colors": None,
                                              "pairs": None}),
          replay(0, w, counts={"colors": 7, "pairs": 50_000})]
    assert pt.counts_of(rs, "colors") == [6, 8, 7]
    assert pt.median(pt.counts_of(rs, "colors")) == 7
    assert pt.collide_ns_per_pair(rs) == [pytest.approx(50.0),
                                          pytest.approx(40.0)]
