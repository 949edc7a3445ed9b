"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` also
`breakdown`, and last `limits`: each number the check compared, with its
limit. The same numbers end standard error. A run without a card, or
whose process has loaded JAX or the JAX package, prints no result and
exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import guard, registry  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    guard.cache_dirs(ROOT)
    import torch

    # one process with one host thread for its tensor work: the load is
    # the program's, not a thread pool's
    torch.set_num_threads(1)
    cell = registry.Cell(registry.load_spec(ROOT), args.workload)
    try:
        guard.require_cards(cell.chips)
        from harness.cell import run_cell

        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T_START)
        guard.refuse_forbidden()
    except guard.Refused as err:
        print(f"refused: {err}", file=sys.stderr)
        return 2
    for name, (value, limit) in result["limits"].items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
