"""solve_roofline_pct: the contact solve's least time on the card over its
measured device time, in percent.

The solve's inputs are made from the state the window ended with (in a
batch cell, its chunk 0) by the step's own stages up to the solve; the
call `ops.solver_kernel.solve` is timed with CUDA events behind a spin
kernel (`harness.timing.device_ms`), however many kernels it launches.
The work is counted from the live counts of those inputs
(`harness.roofline.solve_work`): live points and manifolds, dynamic
bodies, sweeps. Repeated calls solve again from the updated velocities:
the sweeps are fixed in number, so the work is the same."""

import sys

from harness import roofline, timing


def solve_inputs(state, cfg):
    """(solve arguments, live counts) of the step that follows `state`."""
    from nudge_tpu_torch.ops import setup_kernel, solver_kernel
    from nudge_tpu_torch.ops.cache import read_cached_impulses
    from nudge_tpu_torch.ops.contacts import collide
    from nudge_tpu_torch.ops.integrate import apply_gravity
    from nudge_tpu_torch.ops.solver import color_manifolds_cached

    bodies = apply_gravity(state.bodies, state.sleep, cfg)
    man, _ = collide(state, cfg)
    warm, pwarm = read_cached_impulses(state.cache, man, cfg)
    coloring, _ = color_manifolds_cached(man, bodies, cfg, state.colors)
    order = solver_kernel.color_order(man, bodies, coloring, cfg)
    con, velw, acc = setup_kernel.setup(bodies, man, warm, cfg,
                                        coloring=coloring, pwarm=pwarm,
                                        order=order)
    counts = dict(points=int(man.point_valid.sum()),
                  manifolds=int(man.valid.sum()),
                  bodies=int((bodies.inv_mass > 0).sum()),
                  sweeps=cfg.solver_iters)
    return (velw, con, acc), counts


def read(run):
    from nudge_tpu_torch.ops import solver_kernel

    (velw, con, acc), counts = solve_inputs(
        run.one_state(run.entry.state), run.cfg)
    if counts["points"] == 0:
        return None
    ms = timing.device_ms(lambda: solver_kernel.solve(velw, con, acc,
                                                      run.cfg))
    bound_ms, by = roofline.bound(*roofline.solve_work(**counts))
    print(f"solve_roofline_pct: {counts}, bound {bound_ms:.6f} ms "
          f"({by}), device {ms:.6f} ms", file=sys.stderr)
    return roofline.share_pct(bound_ms, ms)
