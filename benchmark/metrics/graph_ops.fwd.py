"""graph_ops.fwd: device operations (kernels, copies, fills and conditional
nodes) a replay of the captured forward step runs, on average over the
last call of the traced episode: the step's graph outside its conditional
nodes plus each conditional body's operations times the share of replays
that ran it (`harness.timing.graph_ops` over the program's `Compiled`)."""

from harness import timing


def read(run):
    kinds = timing.graph_ops(run.compiled())
    return float(sum(kinds.values())) or None
