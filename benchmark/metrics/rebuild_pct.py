"""rebuild_pct: the share of the active steps of one traced episode that
took the persistent broadphase's fat rebuild (the full grid broadphase
under the fat margin and capacities) and not the refilter of the cached
fat pairs, in percent, from the program's `rebuilt` count in the captured
step (the rebuild cond's predicate, 0 or 1). Nothing to read where the
program has no such count."""

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    got = program_trace.counts_of(steps, "rebuilt")
    return 100.0 * sum(got) / len(got) if got else None
