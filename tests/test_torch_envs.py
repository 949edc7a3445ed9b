"""The port's environment API (`nudge_tpu_torch.envs`): the cases of
tests/test_envs.py, the batched step against each env stepped alone, and
one env step against the JAX package's from an equal reset state."""

import jax
import numpy as np
import pytest
import torch

from nudge_tpu import envs as jenvs
from nudge_tpu_torch.envs import BoxPushEnv, EnvState, vec_reset, vec_step
from nudge_tpu_torch.parallel import mesh

from _torch_bridge import POS_ATOL, assert_close, jax_cfg, to_port_state


@pytest.fixture(scope="module")
def env():
    return BoxPushEnv(horizon=20, frame_skip=3, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_reset_and_obs(env):
    s, obs = env.reset(_gen(0))
    assert obs.shape == (env.obs_size,)
    # goal is on the slab, 2..goal_radius out
    r = float(torch.linalg.vector_norm(s.goal[[0, 2]]))
    assert 2.0 <= r <= env.goal_radius + 1e-5
    assert isinstance(s.replace(t=s.t + 1), EnvState)
    # an EnvState goes through the numpy bridge and back unchanged
    back = to_port_state(s)
    assert isinstance(back, EnvState)
    assert torch.equal(back.goal, s.goal) and torch.equal(back.t, s.t)
    assert torch.equal(back.sim.bodies.pos, s.sim.bodies.pos)


def test_pushing_toward_goal_improves_reward(env):
    s, obs = env.reset(_gen(1))
    r_first = None
    for _ in range(12):
        d = obs[6:9]                          # goal - pos
        a = 1.5 * torch.stack([d[0], d[2]])   # push along the bearing
        s, obs, rew, done, _ = env.step(s, a)
        r_first = rew if r_first is None else r_first
    assert float(rew) > float(r_first) + 0.5, (float(r_first), float(rew))
    assert not bool(done)


def test_vmapped_batch(env):
    """vec_reset / vec_step over 4 envs: shapes, finite values, four
    different goals, and each env's step equal to it stepped alone, bit
    for bit."""
    states, obs = vec_reset(env, [_gen(2 + i) for i in range(4)])
    assert obs.shape == (4, env.obs_size)
    acts = torch.ones((4, env.act_size)) * 0.5
    acts[1, 0] = -3.0                          # past max_push: clipped
    new, obs, rew, done, _ = vec_step(env, states, acts)
    assert obs.shape == (4, env.obs_size) and rew.shape == (4,)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())
    # the four goals differ (per-generator randomization survived)
    assert len({tuple(np.round(g.numpy(), 3)) for g in states.goal}) == 4
    for i in range(4):
        s1, o1, r1, d1, _ = env.step(mesh.take(states, i), acts[i])
        assert torch.equal(o1, obs[i]) and torch.equal(r1, rew[i])
        assert torch.equal(s1.sim.bodies.pos, new.sim.bodies.pos[i])
        assert bool(d1) == bool(done[i])


def test_env_step_matches_reference(env):
    """One env step from the reference's reset state, carried across: the
    same obs, reward and done within POS_ATOL."""
    jenv = jenvs.BoxPushEnv(cfg=jax_cfg(env.cfg), horizon=20, frame_skip=3)
    js, jobs = jenv.reset(jax.random.PRNGKey(0))
    ps = to_port_state(js)
    assert isinstance(ps, EnvState)
    assert_close(env._obs(ps), jobs, 0.0, "reset obs")
    a = np.array([1.2, -0.7], np.float32)
    js, jobs, jrew, jdone, _ = jenv.step(js, a)
    ps, pobs, prew, pdone, _ = env.step(ps, torch.from_numpy(a))
    assert_close(pobs, jobs, POS_ATOL, "obs")
    assert_close(prew, jrew, POS_ATOL, "reward")
    assert bool(pdone) == bool(jdone)
    assert int(ps.t) == int(js.t) == 1
