"""stage_ms.sleep: the device time of one step's `sleep` stage (sleeping's
bookkeeping, `update_sleep` with its asleep flood, wake flood and parked
pairs, then the kinetic energy and the metrics' reductions), from the
program's stage stamps in the captured step: the `sleep` stamp minus the
`advance` stamp before it. The median over the active steps of one traced
episode; nothing to read where the program has no `sleep` stamp (sleeping
off, or a program that folds it into `advance`). Printed before the
result, not gated: the awake share's range over those steps (the `bodies`
count, the bodies the solve sees, over the dynamic bodies), and the bodies
that fell asleep and woke over them (the `fell_asleep` and `woke`
counts)."""

import sys

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    got = [st["sleep"] for st in map(program_trace.stages_ms, steps)
           if st is not None and "sleep" in st]
    bodies = program_trace.counts_of(steps, "bodies")
    if got and bodies:
        n = run.system.n_dynamic
        print(f"stage_ms.sleep: {len(got)} active steps, awake share "
              f"{min(bodies) / n:.4f}-{max(bodies) / n:.4f} "
              f"({min(bodies)}-{max(bodies)} of {n}); fell asleep "
              f"{sum(program_trace.counts_of(steps, 'fell_asleep'))}, woke "
              f"{sum(program_trace.counts_of(steps, 'woke'))}",
              file=sys.stderr)
    return program_trace.median(got)
