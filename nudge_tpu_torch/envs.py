"""RL-style environment API over the engine (PyTorch port of
`nudge_tpu.envs`).

BASELINE config 5 frames the scene batch as "RL-style rollouts"; this is
the user-facing shape of that: `BoxPushEnv.reset` / `step` on one
environment, `vec_reset` / `vec_step` on a batch of them (an `EnvState`
with a leading env axis on every leaf) through `parallel.mesh`, so on the
card every physics step of every env goes through the kernels. Everything
rides the public API: `engine.step`, `api.apply_impulse`, `api.wake`.

Where the reference takes a `jax.random` key, `reset` takes a
`torch.Generator`. With `BoxPushEnv(differentiable=True, sleeping=False)`
a rollout differentiates end to end (analytic policy gradients): on the
CPU through the engine's plain twins, on the card through the kernels and
their backward kernels; `vec_step` stacks the batch out of place when it
carries a gradient (`parallel.mesh`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .api import apply_impulse, wake
from .config import SimConfig
from .engine import step as _phys_step
from .parallel.mesh import batched_simulate, make_scene_batch
from .scenes import SceneBuilder
from .state import SimState


@dataclasses.dataclass
class EnvState:
    sim: SimState
    goal: torch.Tensor   # f32[3] world goal for the agent box
    t: torch.Tensor      # i32 env steps taken

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class BoxPushEnv:
    """Push a unit box to a goal on a ground slab.

    obs  f32[9]: agent position, velocity, goal - position
    act  f32[2]: horizontal impulse (x, z), clipped to `max_push`
    rew  f32   : negative horizontal distance to goal
    done bool  : after `horizon` env steps

    Each env step applies the action as one impulse (plus wake, so a
    settled agent rejoins the solve) and advances `frame_skip` physics
    steps. The scene is built on `device`, the card unless the caller asks
    for another.
    """

    obs_size = 9
    act_size = 2

    def __init__(self, cfg: SimConfig = None, horizon: int = 100,
                 frame_skip: int = 5, max_push: float = 2.0,
                 goal_radius: float = 6.0, device="cuda", **cfg_overrides):
        """`cfg_overrides` go to auto_config when no cfg is given."""
        b = SceneBuilder()
        b.add_static_box((12.0, 0.5, 12.0), (0.0, -0.5, 0.0))
        self._agent = b.add_box((0.5, 0.5, 0.5), (0.0, 0.5, 0.0))
        if cfg is None:
            cfg = b.auto_config(**{"sleeping": True, **cfg_overrides})
        self.cfg = cfg
        self._proto = b.finalize(cfg, device=device)
        self.device = self._proto.device
        self.horizon = horizon
        self.frame_skip = frame_skip
        self.max_push = max_push
        self.goal_radius = goal_radius

    def _obs(self, s: EnvState) -> torch.Tensor:
        pos = s.sim.bodies.pos[..., self._agent, :]
        vel = s.sim.bodies.vel[..., self._agent, :]
        return torch.cat([pos, vel, s.goal - pos], -1)

    def reset(self, generator: torch.Generator = None):
        """A fresh episode with its goal drawn from `generator` (torch's
        default generator when None): (EnvState, obs)."""
        gdev = generator.device if generator is not None else "cpu"

        def uniform(lo, hi):
            u = torch.rand((), generator=generator, dtype=torch.float32,
                           device=gdev)
            return (lo + u * (hi - lo)).to(self.device)

        ang = uniform(0.0, 2 * math.pi)
        r = uniform(2.0, self.goal_radius)
        goal = torch.stack([r * torch.cos(ang), torch.full_like(r, 0.5),
                            r * torch.sin(ang)])
        s = EnvState(sim=self._proto, goal=goal,
                     t=torch.zeros((), dtype=torch.int32, device=self.device))
        return s, self._obs(s)

    def _push(self, sim: SimState, action) -> SimState:
        a = torch.clamp(torch.as_tensor(action, dtype=torch.float32,
                                        device=self.device),
                        -self.max_push, self.max_push)
        imp = torch.stack([a[..., 0], torch.zeros_like(a[..., 0]), a[..., 1]],
                          -1)
        sim = sim.replace(bodies=apply_impulse(sim.bodies, self._agent, imp))
        return wake(sim, self._agent)

    def _finish(self, s: EnvState, sim: SimState):
        s = EnvState(sim=sim, goal=s.goal, t=s.t + 1)
        d = s.goal - sim.bodies.pos[..., self._agent, :]
        reward = -torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2 + 1e-8)
        done = s.t >= self.horizon
        return s, self._obs(s), reward, done, {}

    def step(self, s: EnvState, action):
        """(EnvState, obs, reward, done, info) after one env step."""
        sim = self._push(s.sim, action)
        for _ in range(self.frame_skip):
            sim, _ = _phys_step(sim, self.cfg)
        return self._finish(s, sim)


def vec_reset(env: BoxPushEnv, generators):
    """Batched reset, one generator an env: (EnvState batch, obs f32[B,9])."""
    states, obs = zip(*(env.reset(g) for g in generators))
    return make_scene_batch(states), torch.stack(obs)


def vec_step(env: BoxPushEnv, states: EnvState, actions):
    """Batched step over B environments: the pushes on the whole batch, the
    physics steps through `parallel.mesh.batched_simulate`."""
    sim = env._push(states.sim, actions)
    sim, _ = batched_simulate(env.cfg, env.frame_skip)(sim)
    return env._finish(states, sim)
