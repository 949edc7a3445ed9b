"""frame_gap_ms.p50: the device's gap between two frames, from the last
stamp of a frame's replay to the first stamp of the next frame's, with no
profiler attached. The median over one traced episode's frames. Printed
before the result, not gated: the share of those gaps in which each of the
program's host spans was the innermost one open ("outside": none, the
caller's own work such as the pose readback)."""

import sys

from harness import program_trace


def read(run):
    tr = program_trace.episode(run)
    gaps = program_trace.gaps_ns(tr.of("step"))
    shares = program_trace.gap_shares(tr.spans, gaps)
    print("frame_gap_ms.p50: gap shares " + ", ".join(
        f"{k} {100 * v:.1f}%" for k, v in sorted(shares.items(),
                                                  key=lambda kv: -kv[1])),
        file=sys.stderr)
    return program_trace.median([(b - a) * 1e-6 for a, b in gaps])
