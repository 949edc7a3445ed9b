"""solve_roofline_pct.stamped: the contact solve's least time on the card
over its stamped device time, in percent, per step of one traced episode:
the work (`harness.roofline.solve_work`) from the step's own live points,
manifolds and solve bodies, which the captured step counts, and the
config's sweeps; the time from the stamps around the step's `solve`
stage. Nothing is re-run from outside. The median over the active steps
with live points."""

import sys

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    got = program_trace.solve_shares_pct(steps, run.cfg.solver_iters)
    live = [r.counts["points"] for r in steps if r.counts.get("points")]
    print(f"solve_roofline_pct.stamped: {len(got)} steps, live points "
          f"median {program_trace.median(live)}", file=sys.stderr)
    return program_trace.median(got)
