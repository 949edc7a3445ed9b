"""The port's differentiable mode (`cfg.differentiable=True`) on the CPU,
held to the JAX package: the cases of tests/test_autodiff.py, a sphere
scene and a BoxPushEnv rollout against `jax.grad` of the same rollout from
the same state, and the port's dynamic color count against the
reference's static sweep.

On the CPU the port differentiates its plain twins with torch.autograd,
as the reference differentiates its XLA twins with jax.grad; the two run
the same float32 operations except that XLA contracts multiply-adds into
FMAs, so gradients agree to a few ulps grown by the rollout: GRAD_ATOL.
The kernels' backward on the card is held to these twins by
tests/test_torch_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import engine as jengine
from nudge_tpu import envs as jenvs
from nudge_tpu import scenes as jscenes
from nudge_tpu_torch import engine, scenes
from nudge_tpu_torch.envs import BoxPushEnv, vec_reset, vec_step
from nudge_tpu_torch.parallel import mesh

from _torch_bridge import assert_close, jax_cfg, to_port_state

# the 4-body rollout's gradient (max |g| ~1.4): the two packages measured
# 1.5e-8 apart; 1e-5 leaves the FMA rounding room to grow
GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-6
TARGET = (1.0, 0.0, 3.0)
STEPS = 12


def _port_loss(st0, cfg, steps, vel0):
    """(loss, d loss / d vel0) of the port's rollout (tests/test_autodiff.py's
    loss: body 1's squared distance to TARGET)."""
    v = torch.as_tensor(vel0, dtype=torch.float32).clone().requires_grad_()
    st = st0.replace(bodies=st0.bodies.replace(vel=v))
    for _ in range(steps):
        st, _ = engine.step(st, cfg)
    loss = torch.sum((st.bodies.pos[1] - torch.tensor(TARGET)) ** 2)
    (g,) = torch.autograd.grad(loss, v)
    return float(loss.detach()), g


def _jax_value_and_grad(jst0, jcfg, steps):
    def loss(vel0):
        st = jst0.replace(bodies=jst0.bodies.replace(vel=vel0))

        def body(s, _):
            s, _ = jengine.step(s, jcfg)
            return s, None

        st, _ = jax.lax.scan(body, st, None, length=steps)
        return jnp.sum((st.bodies.pos[1] - jnp.array(TARGET)) ** 2)

    return jax.jit(jax.value_and_grad(loss))


@pytest.fixture(scope="module")
def pile4():
    """tests/test_autodiff.py's scene and config in both packages, and the
    port's loss and gradient at the initial velocities."""
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=8, solver_iters=12)
    st0 = b.finalize(cfg, device="cpu")
    jcfg = jax_cfg(cfg)
    jst0 = jscenes.scene_pile(4, seed=0).finalize(jcfg)
    loss, g = _port_loss(st0, cfg, STEPS, st0.bodies.vel)
    return dict(cfg=cfg, st0=st0, jcfg=jcfg, jst0=jst0, loss=loss, g=g,
                vg=lambda v: _port_loss(st0, cfg, STEPS, v))


def test_grad_finite_and_nonzero(pile4):
    assert np.isfinite(pile4["loss"])
    assert bool(torch.isfinite(pile4["g"]).all())
    assert float(torch.linalg.norm(pile4["g"][1])) > 1e-4


def test_grad_matches_jax(pile4):
    """The 4-body rollout's loss and gradient against jax.grad of the JAX
    package's rollout from the same state."""
    jl, jg = _jax_value_and_grad(pile4["jst0"], pile4["jcfg"], STEPS)(
        pile4["jst0"].bodies.vel)
    assert abs(pile4["loss"] - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_close(pile4["g"], jg, GRAD_ATOL, "d loss / d vel0")


@pytest.mark.slow
def test_grad_matches_finite_differences(pile4):
    """tests/test_autodiff.py's check: central differences in 2 random
    directions within 8%."""
    v0 = pile4["st0"].bodies.vel.double().numpy()
    g = pile4["g"].double().numpy()
    rng = np.random.RandomState(1)
    eps = 1e-3
    for _ in range(2):
        d = rng.randn(*v0.shape)
        d /= np.linalg.norm(d)
        lp, _ = pile4["vg"](v0 + eps * d)
        lm, _ = pile4["vg"](v0 - eps * d)
        fd = (lp - lm) / (2 * eps)
        an = float(np.sum(g * d))
        assert abs(fd - an) <= 0.08 * max(abs(fd), abs(an), 1e-6), (fd, an)


@pytest.mark.slow
def test_gradient_descent_reduces_loss(pile4):
    v = pile4["st0"].bodies.vel
    best = l0 = pile4["loss"]
    for _ in range(15):
        lv, g = pile4["vg"](v)
        best = min(best, lv)
        v = v - 4.0 * g
    best = min(best, pile4["vg"](v)[0])
    assert best < 0.3 * l0, (l0, best)


@pytest.mark.slow
def test_batched_grads_match_sequential(pile4):
    """The reference's vmap of grad: three rollouts stepped as one batch
    (parallel.mesh, out of place under grad), each lane's gradient against
    the same rollout alone, atol 2e-4 as the reference's."""
    st0, cfg = pile4["st0"], pile4["cfg"]
    v0 = st0.bodies.vel
    batch = torch.stack([v0, v0 * 1.1, v0 - 0.2]).requires_grad_()
    states = mesh.make_scene_batch([st0] * 3)
    states = states.replace(bodies=states.bodies.replace(vel=batch))
    out, _ = mesh.batched_simulate(cfg, STEPS)(states)
    target = torch.tensor(TARGET)
    loss = torch.sum((out.bodies.pos[:, 1] - target) ** 2, -1)
    (gb,) = torch.autograd.grad(loss.sum(), batch)
    assert bool(torch.isfinite(gb).all())
    for i in range(3):
        _, g = pile4["vg"](batch[i].detach())
        assert_close(gb[i], g, 2e-4, f"lane {i}")


def test_dynamic_color_count_differentiates():
    """The port's counterpart of test_dynamic_bound_solver_rejects_grad:
    torch accepts a dynamic trip count, and the solve's sweep over the
    colors the scene uses gives the value and gradient of the reference's
    static max_colors sweep (the passes of unused colors are exact
    no-ops)."""
    b = scenes.scene_pile(4, seed=0)
    static = b.auto_config(differentiable=True, max_colors=8, solver_iters=4)
    st0 = b.finalize(static, device="cpu")
    ls, gs = _port_loss(st0, static, 6, st0.bodies.vel)
    ld, gd = _port_loss(st0, static.replace(differentiable=False), 6,
                        st0.bodies.vel)
    assert ls == ld
    assert torch.equal(gs, gd)


def test_sphere_scene_grad_matches_jax():
    """A mixed pile (box-sphere and sphere-sphere contacts, the one-point
    narrowphase) differentiated in both packages from the same state."""
    b = scenes.scene_pile(6, seed=1, sphere_frac=0.5)
    cfg = b.auto_config(differentiable=True, max_colors=4, solver_iters=4)
    st0 = b.finalize(cfg, device="cpu")
    assert int(cfg.max_spheres) > 0
    jcfg = jax_cfg(cfg)
    jst0 = jscenes.scene_pile(6, seed=1, sphere_frac=0.5).finalize(jcfg)
    steps = 10
    loss, g = _port_loss(st0, cfg, steps, st0.bodies.vel)
    jl, jg = _jax_value_and_grad(jst0, jcfg, steps)(jst0.bodies.vel)
    assert np.isfinite(loss) and float(torch.linalg.norm(g[1])) > 1e-4
    assert abs(loss - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_close(g, jg, GRAD_ATOL, "d loss / d vel0")


def test_env_rollout_grad_matches_jax():
    """BoxPushEnv(differentiable=True, sleeping=False): the summed reward
    of a 2-step rollout under two actions (a push, then a push that the
    sliding box's friction resists), differentiated with respect to the
    actions, against the JAX env's jax.grad from the same reset state."""
    env = BoxPushEnv(horizon=10, frame_skip=1, differentiable=True,
                     sleeping=False, max_colors=4, solver_iters=8,
                     device="cpu")
    jenv = jenvs.BoxPushEnv(cfg=jax_cfg(env.cfg), horizon=10, frame_skip=1)
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
    a = torch.from_numpy(acts).requires_grad_()
    s, ret = ps0, 0.0
    for k in range(len(acts)):
        s, _, rew, _, _ = env.step(s, a[k])
        ret = ret + rew
    (g,) = torch.autograd.grad(ret, a)
    assert abs(float(ret) - float(jr)) <= 1e-5
    assert float(torch.linalg.norm(g)) > 1e-3
    assert_close(g, jg, GRAD_ATOL, "d return / d actions")


def test_vec_step_grads_match_env_step():
    """A batch of envs through vec_step (parallel.mesh stacks it out of
    place under grad) gives each env's gradient of env.step alone."""
    env = BoxPushEnv(horizon=10, frame_skip=2, differentiable=True,
                     sleeping=False, max_colors=4, solver_iters=4,
                     device="cpu")
    gens = [torch.Generator().manual_seed(5 + i) for i in range(2)]
    states, _ = vec_reset(env, gens)
    acts = torch.tensor([[1.0, 0.5], [-0.8, 0.3]], requires_grad=True)
    _, _, rew, _, _ = vec_step(env, states, acts)
    (gb,) = torch.autograd.grad(rew.sum(), acts)
    for i in range(2):
        a = acts[i].detach().requires_grad_()
        _, _, r, _, _ = env.step(mesh.take(states, i), a)
        (g,) = torch.autograd.grad(r, a)
        assert torch.equal(gb[i], g)
