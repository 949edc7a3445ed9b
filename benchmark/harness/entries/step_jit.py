"""Interactive frames through `engine.step_jit`: an episode is
`calls_per_episode` frames from the spawn state; each frame is one
`step_jit` and the bodies' positions and quaternions copied to the host,
as a viewer reads them.

The check takes `checked_frames` frames of the window's first episode,
drawn from the seed, and its last frame: the reference takes the frame's
step from the frame's input and is compared with the frame's output state
and metrics.
"""

from __future__ import annotations

import torch

from harness import calls, check
from harness.calls import finite


class Entry:
    def __init__(self, system, traffic: dict, rng):
        from nudge_tpu_torch import engine

        self.engine = engine
        self.cfg, self.spawn = system.cfg, system.state
        self.steps = 1
        self.calls = int(traffic["calls_per_episode"])
        self.body_steps = system.n_dynamic
        n = int(traffic["checked_frames"])
        picks = rng.choice(self.calls - 1, size=n, replace=False)
        self.checked = sorted({int(k) for k in picks} | {self.calls - 1})
        self.slots = [(calls.Slot(self.spawn), calls.Slot(self.spawn))
                      for _ in self.checked]
        self.kept, self.prints = [], []

    def warm(self):
        self.engine.step_jit(self.spawn, self.cfg)
        calls.sync(self.spawn)

    def start_episode(self, ep: int):
        self.ep, self.state = ep, self.spawn

    def call(self, c: int) -> bool:
        s_in = self.state
        s_out, m = self.engine.step_jit(s_in, self.cfg)
        b = s_out.bodies
        flags = torch.stack([m.overflow, ~finite(s_out), m.max_depth >= 0.5])
        host = torch.cat([b.pos.reshape(-1), b.quat.reshape(-1),
                          flags.to(torch.float32)]).cpu()
        self.state = s_out
        if self.ep == 0 and c in self.checked:
            a, b = self.slots[len(self.kept)]
            self.kept.append((a.keep(s_in), b.keep(s_out), m))
        if c == self.calls - 1:
            self.prints.append(check.fingerprint(s_out))
            del self.prints[1:-1]
        return bool(host[-3:].any())

    def end_episode(self):
        pass

    def drop(self):
        self.state = None

    def check(self, cmp, judge):
        for s_in, s_out, m in self.kept:
            judge(s_in, s_out, dict(vars(m)))
        cmp.worst("repeat_mismatch",
                  int((self.prints[0] != self.prints[-1]).sum()))
