"""bwd_between_ms.p50: the device's time between two backward replays of
one gradient, from the last stamp of a replay of the captured backward
step to the first stamp of the next: the checkpoint copies the host issues
before each replay, and any wait for the host. The median over one traced
gradient."""

from harness import program_trace


def read(run):
    gaps = program_trace.gaps_ns(program_trace.episode(run).of("grad"),
                                 by_call=True)
    return program_trace.median([(b - a) * 1e-6 for a, b in gaps])
