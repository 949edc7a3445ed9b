"""solve_bwd_roofline_pct: the least time of the contact solve's backward
on the card over its measured device time, in percent.

The solve's inputs are made from the state the traced episode's gradient
ended with, by the step's own stages with the state's velocities and
positions requiring grad (so the solve runs as the differentiable mode's
`SolveFn`); the backward of that one call, `torch.autograd.grad` of its
outputs into its inputs that require grad, is timed with CUDA events
behind a spin kernel (`harness.timing.device_ms`). The work: the forward's
bytes twice (its inputs and the outputs' adjoints read, the inputs'
adjoints written) and `roofline.BWD_OPS_FACTOR` times its operations,
from the same live counts as `solve_roofline_pct`."""

import sys

import torch

from harness import roofline, timing


def read(run):
    from nudge_tpu_torch.ops import solver_kernel
    from nudge_tpu_torch.state import flatten, tree_map

    solve_inputs = run.cell.reader("solve_roofline_pct").solve_inputs
    state = tree_map(lambda t: t.detach(), run.entry.state)
    b = state.bodies
    state = state.replace(bodies=b.replace(
        vel=b.vel.clone().requires_grad_(),
        pos=b.pos.clone().requires_grad_()))
    with torch.enable_grad():
        (velw, con, acc), counts = solve_inputs(state, run.cfg)
        if counts["points"] == 0:
            return None
        ins = [t for t in [velw, *flatten(con)[0], *flatten(acc)[0]]
               if t.requires_grad]
        outs = [t for t in flatten(solver_kernel.solve(velw, con, acc,
                                                       run.cfg))[0]
                if t.requires_grad]
    adj = [torch.ones_like(t) for t in outs]
    ms = timing.device_ms(lambda: torch.autograd.grad(
        outs, ins, adj, retain_graph=True, allow_unused=True))
    n_bytes, n_ops = roofline.solve_work(**counts)
    bound_ms, by = roofline.bound(2 * n_bytes, roofline.BWD_OPS_FACTOR * n_ops)
    print(f"solve_bwd_roofline_pct: {counts}, {len(ins)} inputs, bound "
          f"{bound_ms:.6f} ms ({by}), device {ms:.6f} ms", file=sys.stderr)
    return roofline.share_pct(bound_ms, ms)
