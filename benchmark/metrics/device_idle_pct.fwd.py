"""The device's idle share of the profiled window at the traced run's end:
100 x (1 - the union of the intervals in which the device ran anything,
over the window's wall time). The profiler's coverage against the kernels
`graph_ops` expects is printed before the result."""

NEEDS_PROFILE = True


def read(run):
    if run.profile.busy_s <= 0.0:
        return None
    return run.profile.idle_pct
