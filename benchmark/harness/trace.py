"""The traced run's readings: spans the benchmark records around the
program's graph replays, and one short `torch.profiler` window at the
run's end.

The profiler runs last and only in a run with `--trace 1`: once it has
run, CUPTI stays attached to the process and every later launch pays, so
nothing is measured after it. It is imported here, inside `profile`, and
nowhere else.
"""

from __future__ import annotations

import time

import torch


class Spans:
    """CUDA events around every replay of a captured step (`Compiled.replay`
    wrapped on its instance) and the host time of each call, over one
    episode run under them."""

    def __init__(self, compiled):
        self.compiled = compiled
        self.replays = []        # (start event, stop event, steps, call)
        self.call_s = []
        self._call = 0

    def __enter__(self):
        orig = self.compiled.replay

        def replay(steps, before=None):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(steps, before=before)
            stop.record()
            self.replays.append((start, stop, steps, self._call))
            return out

        self.compiled.replay = replay
        return self

    def __exit__(self, *exc):
        del self.compiled.replay     # the class's method again

    def episode(self, entry, ep: int):
        entry.start_episode(ep)
        for c in range(entry.calls):
            self._call = c
            t = time.perf_counter()
            entry.call(c)
            self.call_s.append(time.perf_counter() - t)
        entry.end_episode()
        torch.cuda.synchronize()

    def replay_ms(self):
        """[(device ms of one replay call, its steps, its call index)]."""
        return [(a.elapsed_time(b), n, c) for a, b, n, c in self.replays]


class Profile:
    """A profiled window: device intervals, their union, and the host's
    operations for labelling the gaps."""

    def __init__(self, events, window_s: float, expected_kernels: float):
        dev, host = [], []
        for e in events:
            rec = (e["start"], e["end"], e["name"])
            (dev if e["device"] else host).append(rec)
        self.window_s = window_s
        self.device = sorted(dev)
        self.host = host
        self.kernels = sum(1 for e in events if e["device"] and e["kernel"])
        self.expected_kernels = expected_kernels
        busy, spans = 0.0, []
        for s, t, _ in self.device:
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], t)
            else:
                spans.append([s, t])
        for s, t in spans:
            busy += t - s
        self.busy_s = busy
        self.spans = spans

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def coverage_pct(self) -> float:
        return 100.0 * self.kernels / max(self.expected_kernels, 1.0)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the innermost host operation running as each gap
        began."""
        by_name: dict = {}
        for s, t, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = [(self.spans[k][1], self.spans[k + 1][0])
                for k in range(len(self.spans) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        labelled = []
        for s, t in gaps:
            inner = [h for h in self.host if h[0] <= s <= h[1]]
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "host outside any recorded operation")
            labelled.append([name[:120], t - s])
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": labelled}


def profile(run_calls, expected_kernels: float) -> Profile:
    """`run_calls()` under `torch.profiler` (CPU and CUDA activities)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_calls()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return Profile(_events(prof), window_s, expected_kernels)


def _events(prof) -> list:
    """[{start, end (s), name, device, kernel}] of a finished profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == torch.autograd.DeviceType.CUDA
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        out.append({"start": e.start_ns() * 1e-9,
                    "end": (e.start_ns() + e.duration_ns()) * 1e-9,
                    "name": e.name(), "device": device,
                    "kernel": device and "memcpy" not in kind.lower()
                    and "memset" not in kind.lower()
                    and not e.name().startswith(("Memcpy", "Memset"))})
    return out
