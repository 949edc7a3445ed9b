"""stage_ms.advance: the device time of one step's `advance` stage
(integration, the position fix, the kinetic energy and metrics, and the
graph's carry and metrics row), from the program's stage stamps in the
captured step: the stamp that ends it minus the one before, summed over
its stages (`harness.program_trace.STAGE_GROUPS`). The median over the
active steps of one traced episode (a parked step has no stages). Printed
before the result, not gated: the six stages' sum beside the replays'
device time from CUDA events, those of the same traced replays and the
benchmark's own around the untraced ones (`program_trace.tiling_note`)."""

import sys

from harness import program_trace


def read(run):
    tr = program_trace.episode(run)
    steps = tr.of("step")
    print(program_trace.tiling_note(run, tr), file=sys.stderr)
    return program_trace.median(program_trace.stage_group_ms(steps, "advance"))
