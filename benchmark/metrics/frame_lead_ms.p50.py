"""frame_lead_ms.p50: per frame, the host start of its `engine.step_jit`
call (the program's `step_jit` span) to the first stamp of its replay,
both on the host clock (the stamps mapped onto it at the call's end): the
host's work and the device's queue before the frame's step begins. The
median over one traced episode's frames."""

from harness import program_trace


def read(run):
    tr = program_trace.episode(run)
    return program_trace.median(program_trace.leads_ms(tr.spans,
                                                       tr.of("step"),
                                                       "step_jit"))
