"""bwd_adjoint_ms.p50: the device time of one replay of the captured backward
step (the program's `GradStep`) spent in `torch.autograd.grad` of the
recomputed step and the adjoints' carry, from the end of the recompute to
the replay's last stamp, from its own stamps. The median over the backward
replays of one traced gradient."""

from harness import program_trace


def read(run):
    got = [program_trace.span_ms(r, "recompute", "adjoint")
           for r in program_trace.episode(run).of("grad")]
    return program_trace.median([v for v in got if v is not None])
