"""Differentiable simulation demo: optimize a throw through contact
(PyTorch port of examples/diff_throw.py).

A box is thrown from the origin toward a target pad 4 m away. The rollout
includes ballistic flight, impact, friction sliding and settling, and the
whole of it is differentiated end to end with torch.autograd: the loss is
the distance between the box's final position and the target, and the
optimized parameter is the initial velocity, by gradient descent at the
reference's rate. `cfg.differentiable=True`: the rollout is one
`engine.simulate`, the reference's `lax.scan` under `jax.value_and_grad`;
on the card its steps replay the captured step and its backward replays
the captured backward step in reverse (the kernels and their backward
kernels); on the CPU the plain twins.

    python -m nudge_tpu_torch.examples.diff_throw [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from nudge_tpu_torch import SceneBuilder
from nudge_tpu_torch.engine import simulate

TARGET = (4.0, 0.5, 0.0)   # rest on the pad, 4 m downrange
STEPS = 90                 # 1.5 s at dt=1/60
ITERS = 30
LR = 0.05


def build(device):
    b = SceneBuilder()
    b.add_static_box((20.0, 0.5, 20.0), (0.0, -0.5, 0.0))   # ground
    b.add_box((0.5, 0.5, 0.5), (0.0, 1.0, 0.0))             # projectile
    cfg = b.auto_config(differentiable=True)
    return b.finalize(cfg, device=device), cfg


def loss_and_grad(st0, cfg, v0):
    """(loss, d loss / d v0) of a rollout with body 1 thrown at v0."""
    v = v0.detach().requires_grad_()
    vel = torch.cat([st0.bodies.vel[:1], v[None], st0.bodies.vel[2:]])
    st = st0.replace(bodies=st0.bodies.replace(vel=vel))
    st, _ = simulate(st, cfg, STEPS)
    target = torch.tensor(TARGET, dtype=torch.float32, device=v.device)
    loss = torch.sum((st.bodies.pos[1] - target) ** 2)
    (g,) = torch.autograd.grad(loss, v)
    return loss.detach(), g


def main(argv=None):
    """Run the optimisation; returns {"loss": [per iteration], "seconds":
    [per iteration], "v": final throw velocity}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    st0, cfg = build(args.device)
    v = torch.tensor([3.0, 2.0, 0.0], device=st0.device)  # undershoots
    hist = {"loss": [], "seconds": []}
    print(f"{'iter':>4} {'loss':>10} {'throw velocity':>28}")
    for i in range(ITERS):
        t0 = time.perf_counter()
        loss, g = loss_and_grad(st0, cfg, v)
        lv = float(loss)
        hist["seconds"].append(time.perf_counter() - t0)
        hist["loss"].append(lv)
        if i % 5 == 0 or lv < 1e-3:
            print(f"{i:>4} {lv:>10.4f} {v.tolist()}")
        if lv < 1e-3:
            break
        v = v - LR * g
    loss, _ = loss_and_grad(st0, cfg, v)
    hist["final_loss"] = float(loss)
    hist["v"] = v.tolist()
    print(f"final loss {float(loss):.5f} with throw velocity {v.tolist()}")
    return hist


if __name__ == "__main__":
    main()
