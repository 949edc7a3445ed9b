"""collide_ns_per_pair.p50: the device ns of one step's `collide` stage
(gravity, broadphase, both narrowphases, compaction) per candidate pair
the narrowphases ran on, from the program's stage stamps and its `pairs`
count in the captured step. The median over the active steps of one
traced episode with live pairs."""

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    return program_trace.median(program_trace.collide_ns_per_pair(steps))
