"""cache_probe_len.p50: the cache-table slots the cache join reads a live
contact point, a step: the program's `cache_probes` count (the slots the
hash join's probe launch read for the valid points, inside the
`cache_read` stage) over its `points` count. 1 is a join in which every
point finds its key, or an empty slot, at its hash. The median over the
active steps of one traced episode; the hit share (`cache_hits` over
`points`, the points that found last step's row) printed beside it.
Nothing to read where the program has no such count."""

import sys

import numpy as np

from harness import program_trace


def per_point(replays, name: str) -> list:
    """Per active step with live points: its count `name` over `points`."""
    out = []
    for r in replays:
        n, got = r.counts.get("points"), r.counts.get(name)
        if program_trace.stages_ms(r) is not None and n and got is not None:
            out.append(got / n)
    return out


def read(run):
    steps = program_trace.episode(run).of("step")
    hits = per_point(steps, "cache_hits")
    if hits:
        print(f"cache_probe_len.p50: hit share p50 {np.median(hits):.6f}, "
              f"range {min(hits):.6f}-{max(hits):.6f} over {len(hits)} "
              "active steps", file=sys.stderr)
    return program_trace.median(per_point(steps, "cache_probes"))
