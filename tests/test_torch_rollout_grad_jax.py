"""The compiled gradient on the CPU (tests/test_torch_rollout_grad.py)
through the one-point narrowphase and through an environment: a mixed
pile's rollout through `engine.simulate` and a BoxPushEnv rollout whose
frame skip is one `engine._RolloutFn` node an env step, each held to the
eager `engine.step` loop bit for bit and to the JAX package's jax.grad
within GRAD_ATOL. A file of its own: the JAX package compiles each of
these rollouts for ~35-60 s on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nudge_tpu import envs as jenvs
from nudge_tpu import scenes as jscenes
from nudge_tpu_torch import engine, scenes
from nudge_tpu_torch.envs import BoxPushEnv

from _torch_bridge import assert_close, jax_cfg, to_port_state
from test_torch_autodiff import GRAD_ATOL, TARGET
from test_torch_rollout_grad import _assert_loop, _bits, _grads, _jax_grads

torch.set_num_threads(2)


def test_sphere_scene_matches_the_loop_and_jax():
    """test_torch_autodiff.py's mixed pile (the one-point narrowphase)
    through engine.simulate: the loop's bits, jax.grad's values."""
    b = scenes.scene_pile(6, seed=1, sphere_frac=0.5)
    cfg = b.auto_config(differentiable=True, max_colors=4, solver_iters=4)
    st0 = b.finalize(cfg, device="cpu")
    steps, keys = 10, (("bodies", "vel"),)
    targets = [(1, TARGET)]
    loop = _grads(st0, cfg, steps, keys, targets, False)
    got = _grads(st0, cfg, steps, keys, targets, True)
    _assert_loop(loop, got, keys)
    jcfg = jax_cfg(cfg)
    jst0 = jscenes.scene_pile(6, seed=1, sphere_frac=0.5).finalize(jcfg)
    jl, jg = _jax_grads(jst0, jcfg, steps, keys, targets)
    assert abs(float(got[0]) - jl) <= 1e-6 * abs(jl)
    assert float(torch.linalg.norm(got[1][keys[0]][1])) > 1e-4
    assert_close(got[1][keys[0]], jg[keys[0]], GRAD_ATOL, "d loss / d vel0")


def test_env_rollout_with_frame_skip():
    """test_torch_autodiff.py's BoxPushEnv rollout with frame_skip=2: each
    env step's two physics steps one `_RolloutFn` node. The return's
    gradient with respect to the actions: the eager loop's bits (the same
    push, engine.step twice, the same reward), jax.grad's values."""
    env = BoxPushEnv(horizon=10, frame_skip=2, differentiable=True,
                     sleeping=False, max_colors=4, solver_iters=8,
                     device="cpu")
    jenv = jenvs.BoxPushEnv(cfg=jax_cfg(env.cfg), horizon=10, frame_skip=2)
    js0, _ = jenv.reset(jax.random.PRNGKey(3))
    ps0 = to_port_state(js0)
    acts = np.array([[1.2, -0.7], [0.5, 0.9]], np.float32)

    def jret(a):
        s, ret = js0, 0.0
        for k in range(len(acts)):
            s, _, rew, _, _ = jenv.step(s, a[k])
            ret = ret + rew
        return ret

    jr, jg = jax.jit(jax.value_and_grad(jret))(jnp.asarray(acts))

    def port(step):
        a = torch.from_numpy(acts).requires_grad_()
        s, ret = ps0, 0.0
        for k in range(len(acts)):
            s, _, rew, _, _ = step(s, a[k])
            ret = ret + rew
        return ret, torch.autograd.grad(ret, a)[0]

    def eager_step(s, action):
        sim = env._push(s.sim, action)
        for _ in range(env.frame_skip):
            sim, _ = engine.step(sim, env.cfg)
        return env._finish(s, sim)

    ret, g = port(env.step)
    lret, lg = port(eager_step)
    assert torch.equal(_bits(ret.detach()), _bits(lret.detach()))
    assert torch.equal(_bits(g), _bits(lg))
    assert abs(float(ret) - float(jr)) <= 1e-5
    assert float(torch.linalg.norm(g)) > 1e-3
    assert_close(g, jg, GRAD_ATOL, "d return / d actions")
