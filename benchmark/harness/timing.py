"""Device time and device operations without a profiler: a copy of the
arithmetic of the port's `utils/timing.py`, kept with the benchmark so
that a change to the program leaves the yardstick as it is.

    device_ms(fn)    mean device milliseconds a call of `fn`;
    graph_ops(c)     {kind: count} of what one replay of a captured step
                     (the program's `Compiled` or `GradStep`) runs on the
                     device, on average over its last rollout, read from
                     its graph and its own counters (`graph`, `bodies`,
                     `counts_read`, `replays`).

`device_ms` times calls with CUDA events while a spin kernel holds the
stream, so that the host has queued every call before the device reaches
the first event: the events then time the device work alone.
"""

from __future__ import annotations

import ctypes

import torch

# clock cycles the spin kernel holds the stream for: ~50-70 ms on an H100
# (1.59-1.98 GHz), far longer than the host takes to queue a few calls
SPIN_CYCLES = 100_000_000
SPIN_TRIES = 4
# CUgraphNodeType (cuda.h)
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 13: "conditional"}


def device_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds a call of `fn` over `reps` calls, from CUDA
    events around calls queued behind a spin kernel
    (`torch.cuda._sleep`): the calls' device work runs back to back and
    the events time it alone, not the host's launches. If the device had
    already reached the first event when the last call returned (a call
    that waits on the device, or a spin too short), the spin doubles and
    the calls are timed again; after SPIN_TRIES it raises."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        cycles *= 2
    raise RuntimeError(f"device_ms: the device reached the calls before the "
                       f"host had queued them, with a spin of up to "
                       f"{cycles // 2} cycles: the call waits on the device")


def _node_kinds(raw_graph: int) -> dict:
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"device_ops: {what} returned CUresult {err}")

    handle = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    kinds: dict = {}
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
              "cuGraphNodeGetType")
        kind = _NODE_KINDS.get(t.value, "other")
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def graph_ops(compiled) -> dict:
    """{kind: count} of the device operations one replay of a compiled step
    or backward step runs, on average over its last rollout: the nodes of
    its graph outside the conditional nodes, plus each conditional body's
    nodes times the share of replays that ran it (the body counters read
    back by control.Compiled.finish or control.GradStep.finish)."""
    total = dict(_node_kinds(compiled.graph.raw_cuda_graph()))
    for body, count in zip(compiled.bodies, compiled.counts_read):
        share = count / max(compiled.replays, 1)
        for kind, n in _node_kinds(body.graph).items():
            total[kind] = total.get(kind, 0) + n * share
    return total
