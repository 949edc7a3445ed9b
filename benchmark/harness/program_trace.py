"""The program's own trace of one episode, and the arithmetic its readers
share.

The readers of the stage stamps, live counts and host spans that the
program records with its tracing on (`nudge_tpu_torch.trace`) take their
readings from one traced episode, run once a run and kept on it
(`episode`): the cell's traffic from the spawn state through the entry's
own `start_episode`, `call` and `end_episode`, after one traced call that
captures the traced graphs and, on the card, `SETTLE_S` of traced
episodes (what they recorded is dropped). The entry keeps
nothing of it for the check (`ep` -1, as the profiled window does; the
gradient entry times nothing), and every attribute of the entry the
episode set is put back afterwards, except the fingerprints an entry
takes of every episode: the check's `repeat_mismatch` holds the traced
episode's outputs to the window's first, bit for bit. On the card, CUDA
events around the traced step's replay calls (`harness.trace.Spans`)
time the same replays the stamps bracket.

A program without tracing raises ImportError here, and every reader is
silent.

A replay's stamps are [(the stage that ends there, host-clock ns or None)]
in the order its graph ran them, the first `start`; the forward step's
stages then tile it (`tail`: the carry and the metrics row), the backward
step's end in `recompute` and `adjoint`.
"""

from __future__ import annotations

import time

import numpy as np

# seconds of traced episodes, their records dropped, between the traced
# capture and the recorded episode: after a capture the card runs every
# graph's kernels ~20% slower to start (a 2,000-kernel graph 2.46 ms
# against 2.03; the pile's step ~8%) for 4-9 s of work, both graphs alike
# (PERF.md, PR 16)
SETTLE_S = 10.0
# the entry attributes an episode sets (the fingerprints stay)
ENTRY_ATTRS = ("ep", "state", "episode_prints", "record")
# stage_ms.<group>: the forward step's stages it sums
STAGE_GROUPS = {
    "collide": ("collide",),
    "cache": ("cache_read", "cache_write"),
    "coloring": ("coloring",),
    "setup": ("setup",),
    "solve": ("solve",),
    "advance": ("advance", "tail"),
}


class ProgramTrace:
    """The host spans (`spans`) and the replays of traced graphs
    (`replays`) of one episode, and on the card the CUDA events around the
    traced step's replay calls in it (`events`: [(ms, steps, call)], as
    `harness.trace.Spans.replay_ms` gives them)."""

    def __init__(self, spans, replays, events=None):
        self.spans, self.replays = spans, replays
        self.events = events or []

    def of(self, graph: str) -> list:
        return [r for r in self.replays if r.graph == graph]


def episode(run) -> ProgramTrace:
    """The program's trace of one episode of the cell, kept on `run`."""
    got = getattr(run, "program_trace", None)
    if got is None:
        got = run.program_trace = _episode(run)
    return got


def _whole(entry):
    entry.start_episode(-1)
    for c in range(entry.calls):
        entry.call(c)
    entry.end_episode()


def _episode(run) -> ProgramTrace:
    from nudge_tpu_torch import trace

    from harness import calls
    from harness.trace import Spans

    entry = run.entry
    cuda = entry.spawn.device.type == "cuda"
    saved = {a: getattr(entry, a) for a in ENTRY_ATTRS if hasattr(entry, a)}
    if "record" in saved:
        entry.record = None
    try:
        with trace.on():
            entry.start_episode(-1)
            entry.call(0)
            calls.sync(entry.spawn)
            settled = time.perf_counter() + (SETTLE_S if cuda else 0.0)
            while time.perf_counter() < settled:
                _whole(entry)
                calls.sync(entry.spawn)
            trace.collect()
            if cuda:
                # CUDA events around the traced step's replays
                with Spans(run.compiled()) as spans:
                    spans.episode(entry, -1)
            else:
                spans = None
                _whole(entry)
            calls.sync(entry.spawn)
            got = trace.collect()
    finally:
        for a, v in saved.items():
            setattr(entry, a, v)
    return ProgramTrace(got.spans, got.replays,
                        spans.replay_ms() if spans is not None else None)


def median(values):
    return float(np.median(values)) if len(values) else None


def stages_ms(replay) -> dict | None:
    """{stage: ms} of one replay, each from the stamp before it; None when
    a stamp is unset (a parked step, whose stages never ran)."""
    ns = [t for _, t in replay.stamps]
    if any(t is None for t in ns):
        return None
    return {name: (ns[k] - ns[k - 1]) * 1e-6
            for k, (name, _) in enumerate(replay.stamps) if k}


def stage_group_ms(replays, group: str) -> list:
    """stage_ms.<group> of every active step among `replays`."""
    out = []
    for r in replays:
        st = stages_ms(r)
        if st is not None:
            out.append(sum(st[n] for n in STAGE_GROUPS[group]))
    return out


def tiling_note(run, tr: ProgramTrace) -> str:
    """The six stage_ms medians' sum beside the step's device time from
    CUDA events around the replays: those of the traced episode itself
    (the same replays the stamps bracket) and the benchmark's own
    (`run.spans`, around the untraced step's replays in the episode before
    it), each the median over calls of ms a step; the stamped replays'
    median (first to last stamp); then call by call (the same steps, bit
    for bit) the untraced events, the traced events and the stamped
    replays' mean, ms a step."""
    steps = tr.of("step")
    six = [median(stage_group_ms(steps, g)) for g in STAGE_GROUPS]
    if any(v is None for v in six):
        return "stage_ms: no active step"

    def by_call(got):
        calls: dict = {}
        for ms, n, c in got:
            calls.setdefault(c, [0.0, 0])
            calls[c][0] += ms
            calls[c][1] += n
        return {c: ms / n for c, (ms, n) in calls.items()}

    untraced, traced = by_call(run.spans.replay_ms()), by_call(tr.events)
    whole = [(bounds(r)[1] - bounds(r)[0]) * 1e-6 for r in steps
             if stages_ms(r) is not None]
    stamped: dict = {}
    for r in steps:
        stamped.setdefault(r.call, []).append(
            (bounds(r)[1] - bounds(r)[0]) * 1e-6)
    calls = [stamped[c] for c in sorted(stamped)]
    rows = [f"{u:.3f}/{t:.3f}/{float(np.mean(w)):.3f}" for u, t, w in
            zip((untraced[c] for c in sorted(untraced)),
                (traced[c] for c in sorted(traced)), calls)]
    per_step = [ms / n for ms, n, _ in tr.events]
    return (f"stage_ms: the six medians sum to {sum(six):.6f} ms; CUDA "
            f"events around the traced replays {median(per_step) or 0:.6f} "
            f"ms a step, around the untraced ones "
            f"{median([ms / n for ms, n, _ in run.spans.replay_ms()]):.6f} "
            f"(medians of calls); stamped replays {median(whole):.6f} ms; "
            "by call, untraced events/traced events/stamped ms a step: "
            + ", ".join(rows))


def counts_of(replays, name: str) -> list:
    """The count `name` of every active step that recorded it."""
    return [r.counts[name] for r in replays if stages_ms(r) is not None
            and r.counts.get(name) is not None]


def collide_ns_per_pair(replays) -> list:
    """Per active step with live candidate pairs: its `collide` stage's ns
    over those pairs."""
    out = []
    for r in replays:
        st, n = stages_ms(r), r.counts.get("pairs")
        if st is not None and n:
            out.append(st["collide"] * 1e6 / n)
    return out


def solve_shares_pct(replays, sweeps: int) -> list:
    """Per active step with live points: the solve's least time, from the
    step's own live points, manifolds and solve bodies and `sweeps`
    (`harness.roofline.solve_work`), over its stamped solve time, in
    percent."""
    from harness import roofline

    out = []
    for r in replays:
        st, n = stages_ms(r), r.counts
        if st is None or not n.get("points"):
            continue
        bound_ms, _ = roofline.bound(*roofline.solve_work(
            n["points"], n["manifolds"], n["bodies"], sweeps))
        out.append(roofline.share_pct(bound_ms, st["solve"]))
    return out


def span_ms(replay, first: str, last: str) -> float | None:
    """ms from the stamp `first` to the stamp `last` of one replay."""
    ns = dict(replay.stamps)
    if ns.get(first) is None or ns.get(last) is None:
        return None
    return (ns[last] - ns[first]) * 1e-6


def bounds(replay):
    """(first set stamp, last set stamp) of a replay, ns."""
    ns = [t for _, t in replay.stamps if t is not None]
    return ns[0], ns[-1]


def gaps_ns(replays, by_call: bool = False) -> list:
    """[(end of replay k, start of replay k + 1)] in the device's order;
    with `by_call` only between replays of one call."""
    rs = sorted(replays, key=lambda r: bounds(r)[0])
    return [(bounds(a)[1], bounds(b)[0]) for a, b in zip(rs, rs[1:])
            if not by_call or a.call == b.call]


def leads_ms(spans, replays, name: str) -> list:
    """Per top-level span `name`: its host start to the first stamp of the
    first replay of its call, ms."""
    first = {}
    for r in replays:
        t = bounds(r)[0]
        if r.call not in first or t < first[r.call]:
            first[r.call] = t
    return [(first[s.call] - s.start_ns) * 1e-6 for s in spans
            if s.name == name and s.parent is None and s.call in first]


def gap_shares(spans, gaps) -> dict:
    """{span name: share of the gaps' total time in which it was the
    innermost host span open}, "outside" where none was."""
    total, by = 0, {}
    for a, b in gaps:
        if b <= a:
            continue
        total += b - a
        inside = [s for s in spans if s.start_ns < b and s.end_ns > a]
        cuts = sorted({a, b} | {t for s in inside
                                for t in (s.start_ns, s.end_ns) if a < t < b})
        for lo, hi in zip(cuts, cuts[1:]):
            open_ = [s for s in inside if s.start_ns <= lo and s.end_ns >= hi]
            name = (max(open_, key=lambda s: s.start_ns).name if open_
                    else "outside")
            by[name] = by.get(name, 0) + hi - lo
    return {k: v / total for k, v in by.items()} if total else {}
