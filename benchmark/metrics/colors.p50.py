"""colors.p50: the colors the step's coloring used (the contact solve runs
one pass a color each sweep), as the captured step counts them (the
program's `colors` count, beside its `coloring` stage stamp). The median
over the active steps of one traced episode."""

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    return program_trace.median(program_trace.counts_of(steps, "colors"))
