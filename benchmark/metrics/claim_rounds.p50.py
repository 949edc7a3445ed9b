"""claim_rounds.p50: the claim rounds the cached coloring's kernel ran a
step (one cluster barrier each; the rounds stop once every valid manifold
is colored), as the captured step counts them (the program's
`claim_rounds` count, written by the kernel's wrapper inside the
`coloring` stage). The median over the active steps of one traced
episode; nothing to read where the program has no such count."""

from harness import program_trace


def read(run):
    steps = program_trace.episode(run).of("step")
    return program_trace.median(program_trace.counts_of(steps,
                                                        "claim_rounds"))
