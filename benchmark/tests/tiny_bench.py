"""A copy of the benchmark with tiny cells added as files, for the CPU
tests: `tiny.rollout` (a 200-box pile, 2 calls of 4 steps), `tiny.frames`
(the same pile, 6 frames), `tinyb.rollout` (2 chunks of 4 piles of 8
boxes, 4 calls of 3 steps), `tiny.grad` (a 60-box pile, one gradient of 12
steps) and `tinyr.rollout` (the 200-box pile in the reference mode:
sleeping and the persistent broadphase, 4 calls of 1 step). Each tiny
cell takes its limits from the full-size cell of its traffic.

`tinyr`'s sleep settings are for the test only: `sleep_frames` 2 and a
`sleep_lin_vel` of 5 m/s put every body to sleep at its second step, so
that the 4 steps hold a fat rebuild (the first: the spawn's cache is
stale), a refilter (the second, in which the pile falls asleep) and two
parked steps, each compared in full."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny.rollout": ("tiny", "tiny_simulate", "pile20k.rollout"),
    "tiny.frames": ("tiny", "tiny_frames", "pile20k.frames"),
    "tinyb.rollout": ("tinyb", "tiny_megabatch", "batch4096x512.rollout"),
    "tiny.grad": ("tinyg", "tiny_grad", "pile20k.grad"),
    "tinyr.rollout": ("tinyr", "tiny_ref_simulate", "pile20k.rollout"),
}


def make(tmp: Path):
    """(spec, bench_dir): the benchmark copied under `tmp`, the tiny cells
    added by new files only."""
    bd = tmp / "benchmark"
    shutil.copytree(BENCH, bd, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pile = json.loads((bd / "configs/pile20k.json").read_text())
    pile["scene"]["n_bodies"] = 200
    pile["sim"].update(max_box_box_pairs=1600, max_manifolds=600,
                       broadphase="grid")
    batch = json.loads((bd / "configs/batch4096x512.json").read_text())
    batch["scene"].update(n_chunks=2, scenes_per_chunk=4, bodies_per_scene=8)
    batch["sim"].update(max_box_box_pairs=8 * 33, max_manifolds=3 * 33,
                        broadphase="grid")
    grad = json.loads(json.dumps(pile))
    grad["scene"]["n_bodies"] = 60
    grad["sim"].update(max_box_box_pairs=480, max_manifolds=180,
                       max_colors=8, solver_iters=6)
    ref = json.loads(json.dumps(pile))
    ref["sim"].update(sleeping=True, persistent_broadphase=True,
                      sleep_frames=2, sleep_lin_vel=5.0)
    files = {
        "configs/tiny.json": pile,
        "configs/tinyr.json": ref,
        "configs/tinyg.json": grad,
        "configs/tinyb.json": batch,
        "traffic/tiny_simulate.json": {"entry": "simulate",
                                       "calls_per_episode": 2,
                                       "steps_per_call": 4,
                                       "profile_calls": 1},
        "traffic/tiny_ref_simulate.json": {"entry": "simulate",
                                           "calls_per_episode": 4,
                                           "steps_per_call": 1,
                                           "profile_calls": 1},
        "traffic/tiny_frames.json": {"entry": "step_jit",
                                     "calls_per_episode": 6,
                                     "checked_frames": 2,
                                     "profile_calls": 2},
        "traffic/tiny_grad.json": {"entry": "rollout_grad",
                                   "steps_per_call": 12, "ke_weight": 1e-3,
                                   "checked_steps": 1, "profile_calls": 1},
        "traffic/tiny_megabatch.json": {"entry": "megabatch_simulate",
                                        "calls_per_episode": 4,
                                        "steps_per_call": 3,
                                        "profile_calls": 1},
    }
    for name, (config, traffic, like) in TINY.items():
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a CPU test's tiny cell"})
        files[f"limits/{name}.json"] = json.loads(
            (bd / f"limits/{like}.json").read_text())
        for m in spec["end_to_end"]:       # what its full-size cell reports
            if like in m.get("workloads", [like]) and "workloads" in m:
                m["workloads"].append(name)
    for rel, obj in files.items():
        path = bd / rel
        assert not path.exists(), rel
        path.write_text(json.dumps(obj))
    return spec, bd


def run(spec, bd, name: str, seed: int = 2 ** 31 + 17, control=None):
    """One CPU run of a tiny cell (the harness's look for a card skipped)."""
    from harness import registry
    from harness.cell import run_cell

    cell = registry.Cell(spec, name, bd)
    return run_cell(cell, seed, 0.01, False, "cpu", time.perf_counter(),
                    log=lambda s: None, control=control)
