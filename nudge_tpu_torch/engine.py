"""The simulation step: collide -> warm start -> setup -> solve -> advance
(PyTorch port of `nudge_tpu.engine`).

`step` runs on whatever device the state lives on: on CUDA tensors both
narrowphases, the claim rounds of both colorings, setup and solve go
through the hand-written kernels (the solve and the claim rounds in one
launch each, with no host read), on CPU tensors through their plain
twins. `step` is the eager step, the reference's un-jitted `step`.

`simulate` and `step_jit` are the reference's compiled rollout and step
(`lax.scan` over `step_jit`, donated state): on the card the step is
captured once as a CUDA graph (`control.compiled`) and replayed, one graph
launch a step, with no host read until the rollout ends; on the CPU they
loop over the eager step. The graph's replays are the eager step's bits.

It runs boxes and spheres, with the cached or the fresh coloring, with or
without sleeping and the persistent broadphase (together: the reference
mode of the JAX bench). The reference's data-dependent branches (any
dynamic body awake: step or park; `persistent_bp.needs_rebuild`: fat
rebuild or reuse; sleeping's three skips) go through `control.cond`:
Python branches on a predicate read in the eager step, conditional nodes
of the graph in the compiled one. The cached coloring's claim rounds, the
reference's while loop, are one kernel launch on the card that stops on
the device; its CPU twin is `control.bounded_while`.

The differentiable mode (`cfg.differentiable`): `step` builds an
autograd graph from whatever state tensors require grad, as the
reference's jax.grad reverses its step. No stage takes a gradient out of
the graph: it flows through the narrowphase geometry, the cache's warm
impulses, setup, the solve, advance and the split-impulse fix; the integer
stages (broadphase, coloring, the solve's order) carry none, as in the
reference. On the CPU the graph runs through the plain twins, with the
reference's static `solver_iters * max_colors` sweep (ops/solver.py). On
the card the kernels run inside autograd Functions whose backward is a
kernel too (the narrowphases, setup, the solve; the solve keeps its
dynamic color count, since the passes of unused colors are exact no-ops,
and records a tape of each visit). Without a gradient to build, the mode's
forward is the normal one, bit for bit. A cond whose operands require
grad is `control._CondFn`, whose backward is a cond again.

Tracing (trace.py): `_step_active` marks the end of each stage with
`trace.stage`: `collide` (gravity, broadphase, narrowphases, compaction),
`cache_read`, `coloring` (the coloring and `color_order`), `setup`,
`solve`, `cache_write` (the world impulses and the cache's write) and
`advance` (advance, the position fix, the kinetic energy and the metrics);
with sleeping on, `advance` ends after the position fix and `sleep`
(`update_sleep`, the kinetic energy and the metrics) follows it. With
tracing on it counts the live manifolds and points, the bodies the solve
sees and the colors used (the live pairs: `collide`; on the card the
cached coloring's claim rounds: `ops/coloring_kernel.py`; with the
persistent broadphase whether the step rebuilt: `ops/persistent_bp.py`;
with sleeping the bodies that fell asleep and woke: `ops/sleeping.py`).
In a traced graph those are stamps and counts in its rows; in an eager
step, host spans inside the step's span.

`simulate` and `step_jit` with a leaf that requires grad are the
reference's `jax.jit(jax.value_and_grad(...lax.scan...))`: one
`_RolloutFn` node over the rollout, with the step rematerialised in
reverse. Its forward is the normal step (on the card the captured graph's
replays) with each step's input state kept as a checkpoint; its backward
takes the steps in reverse, each a `control.GradStep` (on the card one
replay of a captured graph: the step recomputed from its checkpoint with
grad enabled, then `torch.autograd.grad` into the adjoints it carries).
It keeps T states, not T steps of saved tensors; it costs one more
forward step a backward step. The gradient is the eager `step` loop's,
bit for bit for the leaves every step rewrites.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from . import control, trace
from .config import SimConfig
from .mathx import dot
from .ops import setup_kernel, solver_kernel
from .ops.cache import read_cached_impulses, write_cached_impulses
from .ops.contacts import collide
from .ops.integrate import advance, apply_gravity, apply_position_correction
from .ops.sleeping import update_sleep
from .ops.solver import (
    accumulated_world_impulse, color_manifolds, color_manifolds_cached,
)
from .state import SimState, flatten

@dataclasses.dataclass
class StepMetrics:
    """Per-step observability (0-d tensors, or [steps] when stacked)."""

    contact_count: torch.Tensor   # i32
    max_depth: torch.Tensor       # f32 max penetration this step
    spill_count: torch.Tensor     # i32 manifolds past the coloring budget
    overflow: torch.Tensor        # bool any capacity exceeded
    awake_count: torch.Tensor     # i32 dynamic awake bodies
    kinetic_energy: torch.Tensor  # f32 Σ ½|v|²/inv_mass over dynamic bodies
    overflow_bits: torch.Tensor   # i32 attribution (Manifolds.overflow_bits)
    manifold_demand: torch.Tensor  # i32 manifolds wanted
    pair_demand: torch.Tensor     # i32 candidate pairs wanted


def step(state: SimState, cfg: SimConfig):
    """One simulation step. Returns (new_state, StepMetrics).

    With sleeping on, a scene whose every dynamic body is asleep skips the
    whole contact pipeline (the park): nothing inside the engine can wake
    an all-asleep scene, so the skip is exact."""
    with trace.span("step"):
        if cfg.sleeping:
            awake = torch.any(state.sleep.awake & state.bodies.dynamic)
            return control.cond(awake, lambda s: _step_active(s, cfg),
                                _step_parked, (state,), name="awake")
        return _step_active(state, cfg)


def _step_parked(state: SimState):
    """All-asleep fast path: state unchanged except the step counter, and
    all-zero metrics."""
    step.parked += 1
    dev = state.device
    z_i = torch.zeros((), dtype=torch.int32, device=dev)
    z_f = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = StepMetrics(
        contact_count=z_i, max_depth=z_f, spill_count=z_i,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        awake_count=z_i, kinetic_energy=z_f, overflow_bits=z_i,
        manifold_demand=z_i, pair_demand=z_i)
    return state.replace(step_count=state.step_count + 1), metrics


def _step_active(state: SimState, cfg: SimConfig):
    bodies = apply_gravity(state.bodies, state.sleep, cfg)
    contacts, bp = collide(state, cfg)
    trace.stage("collide")
    warm, pwarm = read_cached_impulses(state.cache, contacts, cfg)
    trace.stage("cache_read")
    if cfg.sleeping:
        # sleepers are static for coloring, setup and solve, so the solver
        # never writes velocity into them; true mass comes back before
        # advance
        im0, ii0 = bodies.inv_mass, bodies.inv_inertia
        asleep = ~state.sleep.awake
        bodies = bodies.replace(
            inv_mass=torch.where(asleep, 0.0, im0),
            inv_inertia=torch.where(asleep[:, None], 0.0, ii0))
    if cfg.persistent_coloring:
        coloring, colors = color_manifolds_cached(contacts, bodies, cfg,
                                                  state.colors)
    else:
        coloring, colors = color_manifolds(contacts, bodies, cfg), state.colors
    # the solve's color-sorted order, from the coloring; setup writes the
    # solve's rows in it on the card (the CPU twins keep manifold order)
    order = solver_kernel.color_order(contacts, bodies, coloring, cfg)
    if trace.enabled():
        trace.count(manifolds=contacts.valid.sum(),
                    points=contacts.point_valid.sum(),
                    bodies=torch.sum(bodies.inv_mass > 0.0),
                    colors=coloring[1])
    trace.stage("coloring")
    con, velw, acc = setup_kernel.setup(bodies, contacts, warm, cfg,
                                        coloring=coloring, pwarm=pwarm,
                                        order=order)
    trace.stage("setup")
    velw, acc, pseudo_acc = solver_kernel.solve(velw, con, acc, cfg)
    trace.stage("solve")
    bodies = bodies.replace(vel=velw[:, 0:3].contiguous(),
                            angvel=velw[:, 3:6].contiguous())
    cache = write_cached_impulses(contacts, accumulated_world_impulse(con, acc),
                                  pseudo_acc)
    trace.stage("cache_write")
    if cfg.sleeping:
        bodies = bodies.replace(inv_mass=im0, inv_inertia=ii0)

    bodies = advance(bodies, state.sleep, cfg)
    if cfg.split_impulse:
        bodies = apply_position_correction(
            bodies, (velw[:, 6:9], velw[:, 9:12]), state.sleep, cfg)
    sleep = state.sleep
    if cfg.sleeping:
        trace.stage("advance")
        # the wake gate's "fast" mask is taken from the state the step
        # started from (pre-gravity, pre-solve); wake_factor hysteresis keeps
        # settled jigglers from re-waking their sleeping neighbours
        wf2 = cfg.wake_factor ** 2
        v0, w0 = state.bodies.vel, state.bodies.angvel
        fast0 = ((dot(v0, v0) > wf2 * cfg.sleep_lin_vel ** 2)
                 | (dot(w0, w0) > wf2 * cfg.sleep_ang_vel ** 2))
        sleep, bodies = update_sleep(bodies, contacts, state.sleep, cfg,
                                     fast=fast0)

    new_state = state.replace(bodies=bodies, cache=cache, sleep=sleep, bp=bp,
                              colors=colors, step_count=state.step_count + 1)
    dyn = bodies.dynamic
    ke = 0.5 * torch.sum(torch.where(
        dyn, dot(bodies.vel, bodies.vel) / torch.clamp_min(bodies.inv_mass,
                                                            1e-12), 0.0))
    i32 = torch.int32      # torch sums integers to int64; the metrics are i32
    metrics = StepMetrics(
        contact_count=contacts.contact_count.to(i32),
        max_depth=torch.amax(torch.where(contacts.point_valid, contacts.depth,
                                         0.0)),
        spill_count=con.spill_count.to(i32),
        overflow=contacts.overflow,
        awake_count=torch.sum((dyn & sleep.awake).to(i32)).to(i32),
        kinetic_energy=ke,
        overflow_bits=contacts.overflow_bits.to(i32),
        manifold_demand=contacts.count.to(i32),
        pair_demand=contacts.pair_demand.to(i32),
    )
    trace.stage("sleep" if cfg.sleeping else "advance")
    return new_state, metrics


control.counter(step, "parked")


def _wants_grad(state: SimState, cfg: SimConfig) -> bool:
    return (cfg.differentiable and torch.is_grad_enabled()
            and any(t.requires_grad for t in flatten(state)[0]))


def _stack(per_step) -> StepMetrics:
    return StepMetrics(**{f.name: torch.stack([getattr(m, f.name)
                                               for m in per_step])
                          for f in dataclasses.fields(StepMetrics)})


def simulate(state: SimState, cfg: SimConfig, steps: int):
    """Run `steps` steps. Returns (state, StepMetrics with [steps] fields).

    On the card the step is replayed from its captured graph: the state is
    copied into the graph's input buffers once, each replay carries its
    outputs onto them and writes its metrics into a row on the device,
    and the state that comes back is cloned out of the buffers. On the CPU
    it is a loop over `step`. In the differentiable mode with a state leaf
    that requires grad it is one `_RolloutFn` node (see the module
    docstring), on either device."""
    with trace.span("simulate"):
        if _wants_grad(state, cfg):
            return rollout_grad(state, cfg, steps)
        if state.device.type != "cuda":
            per_step = []
            for _ in range(steps):
                state, m = step(state, cfg)
                per_step.append(m)
            return state, _stack(per_step)
        return control.compiled(step, cfg, state).rollout(state, steps)


def step_jit(state: SimState, cfg: SimConfig):
    """The reference's jitted single step: one replay of the captured step
    on the card (see `simulate`), `step` on the CPU, `_RolloutFn` over one
    step with a gradient. Returns (new_state, StepMetrics)."""
    with trace.span("step_jit"):
        if _wants_grad(state, cfg):
            state, m = rollout_grad(state, cfg, 1)
        elif state.device.type != "cuda":
            return step(state, cfg)
        else:
            state, m = control.compiled(step, cfg, state).rollout(state, 1)
        return state, StepMetrics(**{f.name: getattr(m, f.name)[0]
                                     for f in dataclasses.fields(StepMetrics)})


def rollout_grad(state: SimState, cfg: SimConfig, steps: int):
    """`steps` steps as one `_RolloutFn` node: (state, StepMetrics with
    [steps] fields), differentiable in the state's float leaves that
    require grad, the float metrics too."""
    leaves, build = flatten(state)
    run = _Rollout(cfg, steps, build)
    outs = _RolloutFn.apply(run, *leaves)
    n = len(leaves)
    return build(list(outs[:n])), run.metrics_build(list(outs[n:]))


class _RolloutFn(torch.autograd.Function):
    """A rollout of `step` as one autograd node (`_Rollout` does the work).
    Once differentiable: the reference's users take first derivatives, and
    the backward's own graph is not kept."""

    @staticmethod
    def forward(ctx, run, *leaves):
        with trace.span("grad_forward"):
            outs = run.forward(leaves, ctx.needs_input_grad[1:])
        ctx.run = run
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, run.diff)
                                      if not d])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        run, ctx.run = ctx.run, None
        return (None, *run.backward(grads))


class _Rollout:
    """The forward and backward of `_RolloutFn`. The forward (grad off) runs
    the normal step, on the card as replays of `control.compiled`, keeping
    each step's input state in checkpoint slot k of a [steps]-deep buffer
    a leaf. The backward loads checkpoint k and row k of the metrics'
    adjoints into the `control.GradStep`'s static inputs and runs it, for
    k = steps - 1 ... 0, from the adjoints of the final state: on the card
    one graph launch a step, and the body counters read back once at the
    end. The GradStep's leaves that require grad are the same at every
    step: the caller's and every leaf a step derives from one of them."""

    def __init__(self, cfg: SimConfig, steps: int, build):
        if steps < 1:
            raise ValueError(f"rollout_grad: {steps} steps")
        self.cfg, self.steps, self.build = cfg, steps, build

    def forward(self, leaves, need):
        cfg, steps = self.cfg, self.steps
        state = self.build(list(leaves))
        dev = leaves[0].device
        self.need = need
        g = self.g = control.compiled_grad(step, cfg, state, need)
        ckpt = self.ckpt = [torch.empty((steps,) + t.shape, dtype=t.dtype,
                                        device=dev) for t in leaves]

        def keep(k, now):
            control._copy_all([c[k] for c in ckpt], now)

        if dev.type == "cuda":
            graph = control.compiled(step, cfg, state)
            graph.start()
            graph.load(state)
            metrics = graph.replay(steps,
                                   before=lambda k: keep(k, graph.inputs))
            out = flatten(graph.state())[0]
            graph.finish()
        else:
            per_step = []
            for k in range(steps):
                keep(k, flatten(state)[0])
                state, m = step(state, cfg)
                per_step.append(m)
            metrics = _stack(per_step)
            ins = {id(t) for t in leaves}
            out = [t.clone() if id(t) in ins else t
                   for t in flatten(state)[0]]
        m_leaves, self.metrics_build = flatten(metrics)
        self.diff = ([m and t.dtype.is_floating_point
                      for m, t in zip(g.next_mask, out)]
                     + list(g.metric_mask))
        return (*out, *m_leaves)

    def backward(self, grads):
        g, steps, ckpt = self.g, self.steps, self.ckpt
        n = len(ckpt)
        with torch.no_grad(), trace.span("grad_backward"):
            for a, d in zip(g.adj, grads[:n]):
                if a is not None:
                    if d is None:
                        a.zero_()
                    else:
                        a.copy_(d)
            dsts = list(g.inputs)
            rows = []
            for a, d in zip(g.adj_m, grads[n:]):
                if a is not None:
                    dsts.append(a)
                    rows.append(torch.zeros(steps, dtype=a.dtype,
                                            device=a.device)
                                if d is None else d)
            g.start()
            for k in reversed(range(steps)):
                with trace.span("ckpt_copy"):
                    control._copy_all(dsts, [c[k] for c in ckpt]
                                      + [r[k] for r in rows])
                g.run()
            g.finish()
            out = [a.clone() if m else None
                   for a, m in zip(g.adj, self.need)]
        self.ckpt = None
        return out
