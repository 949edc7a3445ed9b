"""collide_ms.refilter.p50: the device time of the `collide` stage (gravity,
the refilter of the cached fat pairs, both narrowphases, compaction) of a
step that reused the persistent broadphase's fat-pair cache, from the
program's stage stamps and its `rebuilt` count (0) in the captured step.
The median over those steps of one traced episode; nothing to read where
the program has no such count or every step rebuilt."""

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    return program_trace.median(
        [st["collide"] for r, st in zip(steps, map(program_trace.stages_ms,
                                                   steps))
         if st is not None and r.counts.get("rebuilt") == 0])
