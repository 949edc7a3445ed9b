"""Rollouts through `engine.simulate` from a settling pile: set-up steps
the spawn state through calls of `steps_per_call` until the first call
that ends with at most `awake_share` of the dynamic bodies awake (at most
`max_warm_calls` calls), and every episode then runs `calls_per_episode`
calls from that start state, each call's StepMetrics read back, as
`entries/simulate.py` does from the spawn.

Every warm call is held to the window's gates (`calls.gates`: an
overflow, a non-finite state, a penetration of 0.5 m or more): one that
fails one fails set-up. The deepest penetration on the way is printed with
the start state.

The check takes what `simulate`'s does for every call of the window's
first episode, and the last warm call the same way (its leading steps
re-run, the reference's last and first steps), so the start state is
itself a checked output.
"""

from __future__ import annotations

import sys

from harness.calls import gates
from harness.entries import simulate

GATES = ("overflow", "non-finite state", "penetration of 0.5 m or more")


class Entry(simulate.Entry):
    def __init__(self, system, traffic: dict, rng):
        super().__init__(system, traffic, rng)
        self.share = float(traffic["awake_share"])
        self.max_warm = int(traffic["max_warm_calls"])
        self.n_dynamic = system.n_dynamic

    def warm(self):
        """Step the spawn to the start state (the step's graph is captured
        by the first call)."""
        state, deepest = self.spawn, 0.0
        for k in range(self.max_warm):
            s_in = state
            state, m = self.engine.simulate(s_in, self.cfg, self.steps)
            failed = [name for name, f in zip(GATES, gates(m, state).tolist())
                      if f]
            if failed:
                raise RuntimeError(f"warm call {k} failed a gate: "
                                   + ", ".join(failed))
            deepest = max(deepest, float(m.max_depth.max()))
            awake = int(m.awake_count[-1])
            if awake <= self.share * self.n_dynamic:
                break
        else:
            raise RuntimeError(
                f"{awake} of {self.n_dynamic} dynamic bodies awake after "
                f"{self.max_warm} calls of {self.steps} steps: the start "
                f"share {self.share} was not reached")
        print(f"start state: {awake} of {self.n_dynamic} dynamic bodies "
              f"awake after {k + 1} calls of {self.steps} steps; the "
              f"deepest penetration on the way {deepest:.4f} m",
              file=sys.stderr, flush=True)
        self.start = state
        self.kept.append((s_in, state, m))     # checked before episode 0's

    def start_episode(self, ep: int):
        self.ep, self.state, self.episode_prints = ep, self.start, []
