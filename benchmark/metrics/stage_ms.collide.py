"""stage_ms.collide: the device time of one step's `collide` stage (the
broadphase, both narrowphases and the compaction, with gravity), from the
program's stage stamps in the captured step: the stamp that ends it minus
the one before, summed over its stages
(`harness.program_trace.STAGE_GROUPS`). The median over the active steps
of one traced episode (a parked step has no stages)."""

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    return program_trace.median(program_trace.stage_group_ms(steps, "collide"))
