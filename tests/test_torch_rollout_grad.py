"""The compiled gradient on the CPU: `engine.simulate` and `step_jit` with
a state leaf that requires grad run one `engine._RolloutFn` node (the
forward keeps a checkpoint a step, the backward recomputes each step from
its checkpoint and differentiates it, `control.GradStep`, in reverse),
held to the eager `engine.step` loop under autograd and to the JAX
package's `jax.value_and_grad` over `lax.scan`; the differentiable cond
(`control._CondFn`) against autograd of a Python `if`.

On the CPU the runner is the eager step, so these cases check the logic
the card's captured graph replays: the checkpoints, the leaves that
require grad (fixed when the backward step is made), the adjoint carry,
the metrics' adjoints, sleeping's park and the persistent broadphase's rebuild inside
the window. The leaves every step rewrites (pos, quat, vel, angvel) must be
the loop's bit for bit. A leaf the step passes on unchanged (inverse
masses, frictions) collects one term a step, which the loop may add in
another order: within CARRIED_RTOL of its largest element. Against the
JAX package, GRAD_ATOL as tests/test_torch_autodiff.py (a sphere scene
and an environment's rollout: tests/test_torch_rollout_grad_jax.py).

The card's cases (the compiled gradient against the eager loop there, bit
for bit) are in tests/test_torch_control.py, which imports no JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import engine as jengine
from nudge_tpu import scenes as jscenes
from nudge_tpu_torch import control, engine, scenes
from nudge_tpu_torch.ops import persistent_bp
from nudge_tpu_torch.state import flatten

from _torch_bridge import assert_close, jax_cfg
from test_torch_autodiff import (
    GRAD_ATOL, STEPS, TARGET, _targets_loss, _with_leaves,
)
from test_torch_control import HostReads

torch.set_num_threads(2)

CARRIED_RTOL = 1e-6
KE_WEIGHT = 1e-2
VP = (("bodies", "vel"), ("bodies", "pos"))
CARRIED = (("bodies", "inv_mass"), ("boxes", "friction"))

def _loss(st, m, targets, xp=torch):
    """The targets' squared distances plus KE_WEIGHT x the kinetic energy
    summed over the steps (the metrics' adjoints)."""
    pos = [(i, xp.asarray(t) if xp is jnp else torch.tensor(
        t, device=st.bodies.pos.device)) for i, t in targets]
    return (_targets_loss(st.bodies.pos, pos, xp)
            + KE_WEIGHT * xp.sum(m.kinetic_energy))


def _eager(st, cfg, steps):
    ms = []
    for _ in range(steps):
        st, m = engine.step(st, cfg)
        ms.append(m)
    return st, engine._stack(ms)


def _grads(st0, cfg, steps, keys, targets, compiled):
    """(loss, {key: gradient}, parks, rebuilds) of `steps` steps from st0,
    the (part, field) leaves `keys` requiring grad: through
    engine.simulate (`compiled`) or the eager loop."""
    leaves = {k: getattr(getattr(st0, k[0]), k[1]).detach().clone()
              .requires_grad_() for k in keys}
    st = _with_leaves(st0, leaves)
    p0 = engine.step.parked
    r0 = persistent_bp.persistent_broadphase.rebuilds
    if compiled:
        st, m = engine.simulate(st, cfg, steps)
        assert type(st.bodies.pos.grad_fn).__name__ == "_RolloutFnBackward"
    else:
        st, m = _eager(st, cfg, steps)
    loss = _loss(st, m, targets)
    # a leaf the loss does not reach (a window that only parks): zeros
    got = torch.autograd.grad(loss, list(leaves.values()),
                              materialize_grads=True)
    return (loss.detach(), dict(zip(keys, got)), engine.step.parked - p0,
            persistent_bp.persistent_broadphase.rebuilds - r0)


def _jax_grads(jst0, jcfg, steps, keys, targets):
    """The same loss's value and gradients through the JAX package's
    rollout: jax.jit(jax.value_and_grad) over lax.scan."""
    def loss(xs):
        st = _with_leaves(jst0, dict(zip(keys, xs)))

        def body(s, _):
            s, m = jengine.step(s, jcfg)
            return s, m

        st, m = jax.lax.scan(body, st, None, length=steps)
        return _loss(st, m, targets, jnp)

    x0 = [getattr(getattr(jst0, k[0]), k[1]) for k in keys]
    val, g = jax.jit(jax.value_and_grad(loss))(x0)
    return float(val), dict(zip(keys, g))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_loop(want, got, keys, carried=()):
    """`got` (the compiled gradient) against `want` (the eager loop)."""
    assert torch.equal(_bits(want[0]), _bits(got[0])), "loss"
    for k in keys:
        a, b = want[1][k], got[1][k]
        if k in carried:
            err = float((a - b).abs().max())
            assert err <= CARRIED_RTOL * float(a.abs().max()), (k, err)
        else:
            assert torch.equal(_bits(a), _bits(b)), k
    assert want[2:] == got[2:], "parks and rebuilds"


@pytest.fixture(scope="module")
def pile4():
    """tests/test_autodiff.py's scene and config, STEPS steps, the loss
    with the kinetic energy, differentiated with respect to the initial
    velocities, positions, inverse masses and the boxes' frictions: the
    eager loop's and the compiled gradient's."""
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=8, solver_iters=12)
    st0 = b.finalize(cfg, device="cpu")
    keys = VP + CARRIED
    targets = [(1, TARGET)]
    return dict(cfg=cfg, st0=st0, keys=keys, targets=targets,
                loop=_grads(st0, cfg, STEPS, keys, targets, False),
                compiled=_grads(st0, cfg, STEPS, keys, targets, True))


def test_pile4_rewritten_leaves_bitwise_the_loop(pile4):
    _assert_loop(pile4["loop"], pile4["compiled"], VP)


def test_pile4_carried_leaves_within_their_bound(pile4):
    """The inverse masses (the static ground's too) and the frictions:
    within CARRIED_RTOL of the loop's largest element, and nonzero."""
    _assert_loop(pile4["loop"], pile4["compiled"], CARRIED, carried=CARRIED)
    g = pile4["compiled"][1]
    assert float(torch.linalg.norm(g[("bodies", "inv_mass")])) > 1e-3
    assert abs(float(g[("bodies", "inv_mass")][0])) > 0.0


def test_pile4_matches_jax(pile4):
    """The compiled gradient against jax.value_and_grad of the JAX
    package's scan, the same loss (the kinetic energy's stacked metric
    too) from the same state."""
    jcfg = jax_cfg(pile4["cfg"])
    jst0 = jscenes.scene_pile(4, seed=0).finalize(jcfg)
    jl, jg = _jax_grads(jst0, jcfg, STEPS, pile4["keys"], pile4["targets"])
    loss, g = pile4["compiled"][:2]
    assert abs(float(loss) - jl) <= 1e-6 * abs(jl)
    for k in pile4["keys"]:
        assert_close(g[k], jg[k], GRAD_ATOL, f"d loss / d {k[0]}.{k[1]}")


def test_step_jit_with_a_gradient_is_one_rollout_step():
    """step_jit with a leaf that requires grad: one `_RolloutFn` step,
    its 0-d metrics and its gradient the eager step's; once
    differentiable."""
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=4, solver_iters=4)
    st0 = b.finalize(cfg, device="cpu")
    out = []
    for fn in (engine.step, engine.step_jit):
        v = st0.bodies.vel.clone().requires_grad_()
        st, m = fn(st0.replace(bodies=st0.bodies.replace(vel=v)), cfg)
        assert m.kinetic_energy.shape == ()
        loss = torch.sum(st.bodies.pos ** 2) + m.kinetic_energy
        out.append((st, m, torch.autograd.grad(
            loss, v, create_graph=fn is engine.step_jit)))
    (sa, ma, (ga,)), (sb, mb, (gb,)) = out
    assert type(sb.bodies.pos.grad_fn).__name__ == "_RolloutFnBackward"
    for x, y in zip(flatten((sa, ma))[0], flatten((sb, mb))[0]):
        assert torch.equal(_bits(x.detach()), _bits(y.detach()))
    assert torch.equal(_bits(ga), _bits(gb.detach()))
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gb.sum().backward()


def _resting_box(**kw):
    b = scenes.scene_single_box(0.5)
    return b, b.auto_config(differentiable=True, sleeping=True,
                            sleep_frames=2, max_colors=4, solver_iters=4,
                            **kw)


@pytest.mark.parametrize("persistent", [False, True])
def test_park_inside_the_window_is_the_loop(persistent):
    """A resting box with sleep_frames=2 falls asleep and the step parks
    (the park's cond under autograd: `_CondFn`) inside an 8-step window,
    with and without the persistent broadphase: the loop's bits, the same
    parks."""
    b, cfg = _resting_box(persistent_broadphase=persistent)
    st0 = b.finalize(cfg, device="cpu")
    targets = [(1, (0.3, 0.4, -0.2))]
    loop = _grads(st0, cfg, 8, VP, targets, False)
    got = _grads(st0, cfg, 8, VP, targets, True)
    _assert_loop(loop, got, VP)
    assert got[2] >= 3


def test_rollout_from_a_parked_state_then_an_awake_one_is_the_loop():
    """The backward step's leaves that require grad are fixed when it is
    made, with both branches of every cond: a first rollout whose every
    step parks (its state passed on unchanged, its kinetic energy a
    constant) and then one from the awake state, with the same config and
    shapes (so the same cached backward step), are each the loop's bits,
    the kinetic energy's adjoint included."""
    b, cfg = _resting_box()
    st0 = b.finalize(cfg, device="cpu")
    asleep, m = engine.simulate(st0, cfg, 8)
    assert int(m.awake_count[-1]) == 0
    control.clear()
    targets = [(1, (0.3, 0.4, -0.2))]
    for start, parks in ((asleep, 6), (st0, 3)):
        loop = _grads(start, cfg, 6, VP, targets, False)
        got = _grads(start, cfg, 6, VP, targets, True)
        _assert_loop(loop, got, VP)
        assert got[2] >= parks


def test_rebuild_inside_the_window_is_the_loop():
    """The 4-body pile with the persistent broadphase: a fat rebuild at
    the first step and another inside the 8-step window (the rebuild's
    cond under autograd: the anchors take the positions' gradient): the
    loop's bits, the same rebuilds."""
    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, persistent_broadphase=True,
                        max_colors=4, solver_iters=4)
    st0 = b.finalize(cfg, device="cpu")
    targets = [(1, TARGET), (3, (0.0, 0.5, 0.0))]
    loop = _grads(st0, cfg, 8, VP, targets, False)
    got = _grads(st0, cfg, 8, VP, targets, True)
    _assert_loop(loop, got, VP)
    assert got[3] >= 2


def test_backward_reads_only_the_predicates(monkeypatch):
    """The compiled gradient's backward on the CPU (the runner the card
    replays as graphs) reads nothing to the host but control.py's
    predicates: the park, the rebuild, sleeping's skips and the claim
    rounds of each recomputed step, none of the adjoint carry's or the
    checkpoints'."""
    b, cfg = _resting_box(persistent_broadphase=True)
    st0 = b.finalize(cfg, device="cpu")
    v = st0.bodies.vel.clone().requires_grad_()
    st, m = engine.simulate(st0.replace(bodies=st0.bodies.replace(vel=v)),
                            cfg, 6)
    loss = torch.sum(st.bodies.pos ** 2) + m.kinetic_energy.sum()
    listed = []
    real = torch.Tensor.tolist

    def tolist(self):
        listed.append(self.shape)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    audit = HostReads()
    with audit:
        (g,) = torch.autograd.grad(loss, v)
    assert bool(torch.isfinite(g).all())
    assert not audit.outside and audit.nonzero == 0 and listed == []
    p = dict(audit.predicates)
    assert p.pop("step") == 6 and p.pop("persistent_broadphase") >= 1
    assert set(p) <= {"update_sleep", "color_rounds_cached_plain"}


@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_differentiable_cond_equals_python_if(seed, pred):
    """`control.cond` with operands that require grad (`_CondFn`) against
    autograd of a Python `if` on seeded inputs, both predicate values:
    the outputs, which of them require grad (outside a capture: those of
    the branch taken), and the gradients bit for bit, one branch
    returning an operand unchanged and one output differentiable in one
    branch only."""
    rng = np.random.default_rng(seed)
    a0 = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    b0 = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-3, 3, size=(5,)).astype(np.int32))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((5, 3), (5,), (5,))]

    def yes(a, b, k):
        return a * 2.0 + b[:, None], b, (k + 1, torch.zeros_like(b))

    def no(a, b, k):
        return a - b[:, None] ** 2, torch.sin(b) * a[:, 0], (k * k, b * 3.0)

    out = []
    for use_cond in (True, False):
        a = a0.clone().requires_grad_()
        b = b0.clone().requires_grad_()
        if use_cond:
            got = control.cond(torch.tensor(pred), yes, no, (a, b, k))
        else:
            got = yes(a, b, k) if pred else no(a, b, k)
        leaves = flatten(got)[0]
        diff = [t.requires_grad for t in leaves]
        loss = sum(torch.sum(x * y) for x, y in
                   zip((leaves[0], leaves[1], leaves[3]), w))
        out.append((leaves, diff, torch.autograd.grad(loss, [a, b])))
    (lc, dc, gc), (lp, dp, gp) = out
    for x, y in zip(lc, lp):
        assert x.dtype == y.dtype and torch.equal(_bits(x.detach()),
                                                  _bits(y.detach()))
    assert dc == dp
    for x, y in zip(gc, gp):
        assert torch.equal(_bits(x), _bits(y))
