"""One run of one cell: set-up, the measured window, the traced readings,
the check, the result.

Set-up builds the configuration's spawn state from the seed (the program's
scene builders), loads the kernels from the build directory in the
checkout, and captures the cell's graphs with one short call of its
entry. The window then runs whole episodes, each from the spawn state, until
`seconds` have passed: every episode is the same work, so a faster program
completes more of them and its rate is the rate of the same work.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

from harness import calls, check, system, trace


class Window:
    """What the window did: calls, their host times, gate failures, the
    body-steps completed, and its wall time."""

    def __init__(self):
        self.call_s, self.failed, self.episodes = [], 0, 0

    def run(self, entry, seconds: float):
        calls.sync(entry.spawn)
        t0 = time.perf_counter()
        while True:
            entry.start_episode(self.episodes)
            for c in range(entry.calls):
                t = time.perf_counter()
                self.failed += bool(entry.call(c))
                self.call_s.append(time.perf_counter() - t)
            entry.end_episode()
            self.episodes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.wall_s = time.perf_counter() - t0
        self.body_steps = entry.body_steps * len(self.call_s)
        return self


def end_to_end(win: Window, peak_bytes: int, setup_s: float) -> dict:
    """Every end-to-end metric this window gives, by name."""
    call_ms = np.asarray(win.call_s) * 1e3
    rate = win.body_steps / win.wall_s
    return {"body_steps_per_s": rate,
            "grad_body_steps_per_s": rate,
            "frame_ms_p95": float(np.percentile(call_ms, 95)),
            "peak_mem_gib": peak_bytes / 2 ** 30,
            "setup_s": setup_s}


class TraceRun:
    """What the per-layer readers read: the cell, the system, the entry
    (its last state), the spans of one instrumented episode, and, once
    it has run, the profile."""

    def __init__(self, cell, sysm, entry):
        self.cell, self.system, self.entry = cell, sysm, entry
        self.cfg = sysm.cfg
        self.spans = None
        self.profile = None

    def one_state(self, state):
        """A single scene's (or chunk 0's) state of `state`."""
        if self.system.chunks is None:
            return state
        from nudge_tpu_torch.parallel import mesh

        return mesh.take(state, 0)

    def compiled(self):
        """The program's captured step for this cell's shapes."""
        from nudge_tpu_torch import control, engine

        return control.compiled(engine.step, self.cfg,
                                self.one_state(self.system.state))


def _entry(cell, sysm, rng):
    mod = importlib.import_module(f"harness.entries.{cell.traffic['entry']}")
    return mod.Entry(sysm, cell.traffic, rng)


def _per_layer(cell, run: TraceRun, profile_phase: bool, out: dict, log):
    for m in cell.per_layer:
        reader = cell.reader(m["name"])
        if bool(getattr(reader, "NEEDS_PROFILE", False)) != profile_phase:
            continue
        try:
            value = reader.read(run)
        except (AttributeError, ImportError) as err:
            # the program no longer has what the reader reads (a stage
            # fused away, a module moved): the metric is silent
            log(f"{m['name']}: not read ({type(err).__name__}: {err})")
            value = None
        if value is None:
            log(f"{m['name']}: nothing to read in this cell")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=None, control=None) -> dict:
    """One run; returns the result line's object. With `control` (a dtype)
    the check judges the reference computed in that lower precision in the
    program's place: the control that must come out not correct."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    rng = np.random.default_rng(seed)
    sysm = system.build(cell.config, seed, device)
    entry = _entry(cell, sysm, rng)
    entry.warm()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = Window().run(entry, seconds)
    # reserved, not allocated: a captured graph's intermediates live in its
    # pool, which the allocator counts as reserved once the capture ends
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    log(f"window {win.wall_s:.3f} s: {win.episodes} episodes, "
        f"{len(win.call_s)} calls, {win.failed} failed")
    e2e = end_to_end(win, peak, setup_s)
    metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}

    run = None
    if traced:
        metrics = {}
        run = TraceRun(cell, sysm, entry)
        compiled = run.compiled()
        entry.record = []          # an entry that times its calls' parts
        with trace.Spans(compiled) as spans:
            spans.episode(entry, win.episodes)
        run.spans = spans
        _per_layer(cell, run, False, metrics, log)

    entry.drop()
    cmp = check.Comparison()
    cmp.spawn(sysm.state, system.reference_spawn(cell.config, seed,
                                                 sysm.cfg, device))

    def judge(s_in, out_state, out_row, adjoint=None):
        """The reference's step from `s_in` against the program's output
        state (None: its metrics only) and metrics row; with `adjoint`
        (next state's adjoints, kinetic energy weight, this state's
        adjoints) also the step's vector-Jacobian product."""
        ref_state, ref_m, ref_adj = check.reference_step(s_in, sysm.cfg,
                                                         adjoint=adjoint)
        if control is not None:    # the control in the program's place
            out_state, low_m, low_adj = check.reference_step(
                s_in, sysm.cfg, control, adjoint=adjoint)
            out_row = dict(vars(low_m))
            if adjoint is not None:
                adjoint = (None, None, low_adj)
        if out_state is not None:
            cmp.state(out_state, ref_state)
        cmp.metrics(out_row, ref_m)
        if adjoint is not None:
            cmp.adjoint(adjoint[2], ref_adj)

    t = time.perf_counter()
    entry.check(cmp, judge)
    for note in cmp.notes:
        log(note)
    log(f"check {time.perf_counter() - t:.3f} s over {cmp.count} states")
    correct, rows = cmp.judge(check.load_limits(cell.bench_dir, cell.name))

    result = {"correct": correct, "attempted": len(win.call_s),
              "failed": win.failed, "metrics": metrics,
              "device": device_record(device, peak)}
    if traced:
        prof = run.profile = _profile(run, entry, sysm, log)
        _per_layer(cell, run, True, metrics, log)
        result["device"]["busy_s"] = prof.busy_s
        result["device"]["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown()
    result["limits"] = {n: [v, lim] for n, v, lim in rows}
    return result


def _profile(run: TraceRun, entry, sysm, log):
    """The profiled window: `profile_calls` calls of the cell's traffic from
    the spawn state (the whole episode when it is shorter)."""
    from harness import timing

    compiled = run.compiled()
    graphs = (entry.graphs(compiled) if hasattr(entry, "graphs")
              else [(compiled, entry.steps * (sysm.chunks or 1))])
    n = min(int(run.cell.traffic["profile_calls"]), entry.calls)
    expected = n * sum(timing.graph_ops(g).get("kernel", 0) * k
                       for g, k in graphs)

    def run_calls():
        entry.start_episode(0)
        entry.ep = -1          # keeps nothing for the check
        for c in range(n):
            entry.call(c)

    prof = trace.profile(run_calls, expected)
    log(f"profiler: {prof.kernels} device kernels recorded of "
        f"{prof.expected_kernels:.0f} that graph_ops expects "
        f"({prof.coverage_pct:.1f}% coverage) over {prof.window_s:.3f} s")
    return prof


def device_record(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
