"""bwd_recompute_ms.p50: the device time of one replay of the captured
backward step (the program's `GradStep`) spent in the step recomputed with
grad, from its first stamp to the end of the recompute, from its own
stamps. The median over the backward replays of one traced gradient."""

from harness import program_trace


def read(run):
    got = [program_trace.span_ms(r, "start", "recompute")
           for r in program_trace.episode(run).of("grad")]
    return program_trace.median([v for v in got if v is not None])
