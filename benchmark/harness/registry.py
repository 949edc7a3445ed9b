"""Find a cell's pieces by name: its entry in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`). Adding a cell, a mix or a metric adds files;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


class Cell:
    """One workload of `BENCHMARK.json` with its configuration, traffic mix
    and metric definitions loaded."""

    def __init__(self, spec: dict, name: str, bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are: {', '.join(sorted(cells))})")
        self.entry = cells[name]
        self.name = name
        self.bench_dir = bench_dir
        self.config = load_json(bench_dir / "configs",
                                self.entry["config"])
        self.traffic = load_json(bench_dir / "traffic",
                                 self.entry["traffic"])
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if self.reports(m)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if self.reports(m) and m["moves"] in names]

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports `metric`: every cell, unless the
        metric lists its cells."""
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def reader(self, metric: str):
        """The reader module of a per-layer metric."""
        return load_module(self.bench_dir / "metrics", metric)


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(folder: Path, name: str) -> dict:
    path = folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_module(folder: Path, name: str):
    """The module in `folder/<name>.py` (a name may hold dots)."""
    path = folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
