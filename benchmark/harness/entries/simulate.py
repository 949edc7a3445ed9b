"""Rollouts through `engine.simulate`: an episode is `calls_per_episode`
calls of `simulate(state, cfg, steps_per_call)` from the spawn state, each
call's StepMetrics read back to the host as it ends.

The check takes every call of the window's first episode. For each, the
program re-runs the call's leading steps from the call's input (the same
captured step; its metrics must equal the window's bit for bit), the
reference takes the last step from there and is compared with the
window's output state and last metrics row, and the reference takes the
first step from the call's input and is compared with the window's first
metrics row.
"""

from __future__ import annotations

import torch

from harness import calls, check
from harness.calls import gates, read_back


class Entry:
    def __init__(self, system, traffic: dict, rng):
        from nudge_tpu_torch import engine

        self.engine = engine
        self.cfg, self.spawn = system.cfg, system.state
        self.steps = int(traffic["steps_per_call"])
        self.calls = int(traffic["calls_per_episode"])
        self.body_steps = system.n_dynamic * self.steps
        self.kept, self.prints = [], []

    def warm(self):
        """Capture the step's graph with one short call."""
        self.engine.simulate(self.spawn, self.cfg, 1)
        calls.sync(self.spawn)

    def start_episode(self, ep: int):
        self.ep, self.state, self.episode_prints = ep, self.spawn, []

    def call(self, c: int) -> bool:
        """One call; returns whether a gate failed."""
        s_in = self.state
        s_out, m = self.engine.simulate(s_in, self.cfg, self.steps)
        failed = read_back(m, gates(m, s_out))
        self.state = s_out
        self.episode_prints.append(check.fingerprint(s_out))
        if self.ep == 0:
            self.kept.append((s_in, s_out, m))
        return failed

    def end_episode(self):
        self.prints.append(torch.stack(self.episode_prints))
        del self.prints[1:-1]

    def drop(self):
        """Free the working state; what the check reads stays."""
        self.state = None

    def check(self, cmp, judge):
        for s_in, s_out, m in self.kept:
            pre = s_in
            if self.steps > 1:
                pre, m_pre = self.engine.simulate(s_in, self.cfg,
                                                  self.steps - 1)
                cmp.worst("replay_mismatch", sum(
                    int((a != b[:self.steps - 1]).sum())
                    for a, b in zip(vars(m_pre).values(),
                                    vars(m).values())))
            judge(pre, s_out, check.metrics_row(m, self.steps - 1))
            if self.steps > 1:
                judge(s_in, None, check.metrics_row(m, 0))
        first, last = self.prints[0], self.prints[-1]
        cmp.worst("repeat_mismatch", int((first != last).sum()))
