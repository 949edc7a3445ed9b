"""graph_ops.bwd: device operations a replay of the captured backward step
(the program's `GradStep`) runs, on average over its last backward, as
`graph_ops.fwd` counts the forward's."""

from harness import timing


def read(run):
    kinds = timing.graph_ops(run.entry.grad_step())
    return float(sum(kinds.values())) or None
