"""Batched rollouts through `parallel.mesh.megabatch_simulate`: an episode
is `calls_per_episode` calls of `megabatch_simulate(cfg,
steps_per_call)` on the stack of chunks from the spawn stack, each call's
last-step metrics (a row a chunk) read back as it ends: a reinforcement
learning loop with a frame skip of `steps_per_call`.

The check takes one call of the window's first episode, drawn from the
seed among the episode's second half (where the piles are in contact),
and every chunk of it: the program re-runs the chunk from its spawn to
the call's last step (the same captured step as the window's), the
reference takes that step and is compared with the window's output chunk
and its metrics row. The same call of the window's last episode must
give the same stack, bit for bit. Both stacks are copied into buffers
made at set-up, so that what the window keeps takes the same memory
whichever call the seed picks.
"""

from __future__ import annotations

import torch

from harness import calls
from harness.calls import gates, read_back


class Entry:
    def __init__(self, system, traffic: dict, rng):
        from nudge_tpu_torch import engine
        from nudge_tpu_torch.parallel import mesh

        self.engine, self.mesh = engine, mesh
        self.cfg, self.spawn = system.cfg, system.state
        self.chunks = system.chunks
        self.steps = int(traffic["steps_per_call"])
        self.calls = int(traffic["calls_per_episode"])
        self.body_steps = system.n_dynamic * self.steps
        self.run = mesh.megabatch_simulate(self.cfg, self.steps)
        half = self.calls // 2
        self.checked = half + int(rng.integers(self.calls - half))
        self.first, self.last = calls.Slot(self.spawn), calls.Slot(self.spawn)
        self.kept = None

    def warm(self):
        self.run(self.spawn)
        calls.sync(self.spawn)

    def start_episode(self, ep: int):
        self.ep, self.state = ep, self.spawn

    def call(self, c: int) -> bool:
        s_out, m = self.run(self.state)
        failed = read_back(m, gates(m, s_out))
        self.state = s_out
        if c == self.checked and self.ep >= 0:
            if self.ep == 0:
                self.kept = (self.first.keep(s_out), m)
            self.last.keep(s_out)
        return failed

    def end_episode(self):
        pass

    def drop(self):
        self.state = None

    def check(self, cmp, judge):
        s_out, m = self.kept
        before = (self.checked + 1) * self.steps - 1
        for i in range(self.chunks):
            pre, _ = self.engine.simulate(self.mesh.take(self.spawn, i),
                                          self.cfg, before)
            judge(pre, self.mesh.take(s_out, i),
                  {k: v[i] for k, v in vars(m).items()})
            del pre
        cmp.worst("repeat_mismatch", sum(
            int((a != b).sum()) for a, b in zip(calls.leaves(self.first.state),
                                                calls.leaves(self.last.state))))
