"""Gradients of rollouts through `engine.simulate` in the differentiable
mode: an episode is one gradient. The spawn state's velocities and
positions require grad, `simulate(state, cfg, steps_per_call)` runs the
rollout, the loss is the summed height of the dynamic bodies at its end
plus `ke_weight` x the kinetic energy summed over its steps, and
`torch.autograd.grad` takes the loss's gradient with respect to those
velocities and positions; the loss and the gates are read back.

The check follows the gradient a step at a time from the program's own
states. The program re-runs the first gradient as a chain of one-step
`engine.step_jit` calls (each one node of the same compiled gradient; its
loss and gradient must equal the window's bit for bit) and hands back its
states and, from one `autograd.grad`, the adjoint of every float leaf
that requires grad at each sampled step k and k + 1. The reference takes
step k from the program's state: its output and metrics are compared with
the program's state k + 1 and its metrics, and its vector-Jacobian
product with the program's adjoint at k + 1 (plus `ke_weight` on the
step's kinetic energy) with the program's adjoint at k. Step 0 is always
sampled: its adjoint is the window's gradient itself.
"""

from __future__ import annotations

import torch

from harness import calls, check
from reference import tree


def height(state) -> torch.Tensor:
    dyn = state.bodies.inv_mass > 0.0
    return torch.where(dyn, state.bodies.pos[:, 1], 0.0).sum()


class Entry:
    def __init__(self, system, traffic: dict, rng):
        from nudge_tpu_torch import engine

        self.engine = engine
        self.cfg = system.cfg.replace(differentiable=True)
        system.cfg = self.cfg
        self.spawn = system.state
        self.steps = int(traffic["steps_per_call"])
        self.calls = 1
        self.ke_weight = float(traffic["ke_weight"])
        self.body_steps = system.n_dynamic * self.steps
        n = int(traffic["checked_steps"])
        later = rng.choice(range(self.steps // 2, self.steps - 1), size=n,
                           replace=False)
        self.checked = sorted({0} | {int(k) for k in later})
        self.kept, self.prints = None, []
        self.record = None     # a list: CUDA events of each call's halves

    def _start(self):
        b = self.spawn.bodies
        v = b.vel.clone().requires_grad_()
        p = b.pos.clone().requires_grad_()
        return (v, p), self.spawn.replace(bodies=b.replace(vel=v, pos=p))

    def loss(self, out, ke_steps) -> torch.Tensor:
        return height(out) + self.ke_weight * ke_steps.sum()

    def warm(self):
        """Capture the forward step and the backward step with one short
        gradient."""
        (v, p), st = self._start()
        out, m = self.engine.simulate(st, self.cfg, 1)
        torch.autograd.grad(self.loss(out, m.kinetic_energy), (v, p))
        calls.sync(self.spawn)

    def start_episode(self, ep: int):
        self.ep = ep

    def call(self, c: int) -> bool:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if self.record is not None else None
        (v, p), st = self._start()
        if ev:
            ev[0].record()
        out, m = self.engine.simulate(st, self.cfg, self.steps)
        loss = self.loss(out, m.kinetic_energy)
        if ev:
            ev[1].record()
        gv, gp = torch.autograd.grad(loss, (v, p))
        if ev:
            ev[2].record()
            self.record.append(ev)
        flags = torch.stack([
            m.overflow.any(), ~calls.finite(out),
            (m.max_depth >= 0.5).any(),
            ~(torch.isfinite(gv).all() & torch.isfinite(gp).all())])
        host = torch.cat([loss.detach()[None], flags.to(torch.float32)]).cpu()
        self.state = out
        if self.ep == 0:
            self.kept = (loss.detach(), gv, gp)
        self.prints.append(check.fingerprint_of([loss[None], gv, gp]))
        del self.prints[1:-1]
        return bool(host[1:].any())

    def end_episode(self):
        pass

    def drop(self):
        self.state = None

    def grad_step(self):
        """The program's captured backward step of this traffic's gradient
        (`control.compiled_grad` for the spawn state with its velocities
        and positions requiring grad)."""
        from nudge_tpu_torch import control
        from nudge_tpu_torch.state import flatten

        _, st = self._start()
        need = [t.requires_grad for t in flatten(st)[0]]
        return control.compiled_grad(self.engine.step, self.cfg, st, need)

    def graphs(self, compiled) -> list:
        """[(captured graph, replays a call)] of one call."""
        return [(compiled, self.steps), (self.grad_step(), self.steps)]

    def check(self, cmp, judge):
        loss0, gv0, gp0 = self.kept
        (v, p), st = self._start()
        states, kes = [st], []
        for _ in range(self.steps):
            st, m = self.engine.step_jit(st, self.cfg)
            states.append(st)
            kes.append(m)
        loss = self.loss(st, torch.stack([m.kinetic_energy for m in kes]))
        wrt = {j: grad_leaves(states[j])
               for k in self.checked for j in (k, k + 1)}
        order = sorted(wrt)
        got = torch.autograd.grad(loss, [v, p] + [t for j in order
                                                  for _, t in wrt[j]])
        cmp.worst("replay_mismatch",
                  int(loss.detach().view(torch.int32)
                      != loss0.view(torch.int32))
                  + int((got[0] != gv0).sum()) + int((got[1] != gp0).sum()))
        adj, at = {}, 2
        for j in order:
            adj[j] = dict(zip([n for n, _ in wrt[j]],
                              got[at:at + len(wrt[j])]))
            at += len(wrt[j])
        for k in self.checked:
            row = {name: t.detach() for name, t in vars(kes[k]).items()}
            judge(tree.detached(tree.from_fields(states[k])),
                  tree.detached(tree.from_fields(states[k + 1])), row,
                  adjoint=(adj[k + 1], self.ke_weight, adj[k]))
        cmp.worst("repeat_mismatch",
                  int((self.prints[0] != self.prints[-1]).sum()))


def grad_leaves(state) -> list:
    """[(name, tensor)] of the state's leaves that require grad."""
    return [(n, t) for n, t in tree.leaves(tree.from_fields(state))
            if t.requires_grad]
