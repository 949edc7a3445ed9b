"""The 20,480-box pile's gradient on the card, through the eager
`engine.step` loop and through `engine.simulate`, from one or more trees
of the package, each in a process of its own:

    python3 scripts/torch_grad_probe.py [--profile] DIR [DIR ...]

DIR holds a `nudge_tpu_torch/` (the repo root, or a commit unpacked with
`git archive` into the git-ignored `build/`); to compare two trees on one
card, give them as A B B A. Each process steps the pile 40 steps
(chip_smoke's `pile_config`), then differentiates 5 differentiable steps
from there (loss: the summed height of the dynamic bodies plus 1e-3 x the
summed kinetic energy, with respect to the initial velocities and
positions), twice through each route, and prints: forward and backward
ms a step (host clock around synchronized calls), peak GB allocated above
the state, and a hash of the gradients' bits (equal hashes: the same
gradient bit for bit). Where the tree has the compiled gradient
(`control.compiled_grad`) it also times one backward replay alone with
CUDA events, and with `--profile` lists the kernels of three backward
replays by device time under `torch.profiler` (the eager backward's for a
tree without it); the profile runs last in its process, since a profiler
session slows every later launch. Needs a CUDA device; ~1 minute a tree.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5


def probe(tree: str, profile: bool):
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, REPO)
    import torch

    import chip_smoke as cs
    import nudge_tpu_torch
    from nudge_tpu_torch import control, engine, scenes
    from nudge_tpu_torch.state import flatten

    print(f"tree {os.path.dirname(nudge_tpu_torch.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    b = scenes.scene_pile(cs.N_PILE)
    cfg = cs.pile_config(b, cs.N_PILE)
    pile, _ = engine.simulate(b.finalize(cfg, device=dev), cfg,
                              cs.COMPARE_AFTER)
    dcfg = cfg.replace(differentiable=True)
    keys = (("bodies", "vel"), ("bodies", "pos"))

    def loss(st, m):
        return cs.dynamic_height(st) + 1e-3 * m.kinetic_energy.sum()

    def bits_hash(r):
        return hashlib.sha1(b"".join(
            g.view(torch.int32).cpu().numpy().tobytes()
            for g in r["grads"].values())).hexdigest()[:16]

    for route, compiled in (("eager loop", False), ("simulate", True)):
        for k in range(2):
            r = cs.grad_rollout(cs.clone_state(pile), dcfg, STEPS, loss, keys,
                                compiled)
            print(f"{route} run {k + 1}: forward "
                  f"{1e3 * r['fwd'] / STEPS:.2f} ms a step, backward "
                  f"{1e3 * r['bwd'] / STEPS:.2f} ms a step, peak "
                  f"{r['peak']:.3f} GB above the state, gradient bits "
                  f"{bits_hash(r)}", flush=True)
    graph = None
    if hasattr(control, "compiled_grad"):
        need = [t is pile.bodies.vel or t is pile.bodies.pos
                for t in flatten(pile)[0]]
        graph = control.compiled_grad(engine.step, dcfg, pile, need).graph
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            start.record()
            graph.replay()
            stop.record()
            torch.cuda.synchronize()
            times.append(round(start.elapsed_time(stop), 3))
        print(f"one backward replay (CUDA events): {times} ms", flush=True)
    if not profile:
        return
    from torch.profiler import ProfilerActivity, profile as prof_session

    leaves = [getattr(pile.bodies, k[1]).clone().requires_grad_()
              for k in keys]
    st = pile.replace(bodies=pile.bodies.replace(vel=leaves[0],
                                                 pos=leaves[1]))
    st, m = engine.step(st, dcfg)
    out = loss(st, engine.StepMetrics(**{k: v[None]
                                         for k, v in vars(m).items()}))
    torch.cuda.synchronize()
    with prof_session(activities=[ProfilerActivity.CUDA]) as p:
        if graph is None:
            torch.autograd.grad(out, leaves)
        else:
            for _ in range(3):
                graph.replay()
        torch.cuda.synchronize()
    rows = sorted(p.key_averages(), key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in rows) / 1e3
    what = "one eager backward" if graph is None else "3 backward replays"
    print(f"profile of {what}: {total:.2f} ms of device time; by kernel:")
    for e in rows[:8]:
        print(f"  {e.device_time_total / 1e3:8.3f} ms  {e.count:4d} calls  "
              f"{e.key[:100]}")


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "--child":
        probe(args[1], args[2] == "1")
        return
    profile = "--profile" in args
    trees = [a for a in args if a != "--profile"]
    if not trees:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree, "1" if profile else "0"], check=True)


if __name__ == "__main__":
    main()
