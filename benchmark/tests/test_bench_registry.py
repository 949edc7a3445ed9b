"""The benchmark finds every piece of a cell by its name, and a cell, a
traffic mix and a per-layer metric added as new files are picked up with
no edit to a file that is there."""

import json
import re

import tiny_bench

from harness import check, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return registry.load_spec(tiny_bench.ROOT)


def test_every_cell_loads_by_name():
    s = spec()
    for w in s["workloads"]:
        cell = registry.Cell(s, w["name"])
        assert cell.config["chips"] == cell.chips == 1
        assert cell.traffic["entry"]
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        limits = check.load_limits(cell.bench_dir, cell.name)
        assert set(check.NAMES) - {"grad_gap_rel"} <= set(limits) \
            <= set(check.NAMES)


def test_spec_keeps_the_contract_names():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert m["moves"] in e2e
    for w in s["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = registry.Cell(s, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]


def test_new_files_are_picked_up(tmp_path):
    s, bd = tiny_bench.make(tmp_path)
    before = {p: p.read_bytes() for p in bd.rglob("*")
              if p.is_file() and p.name.startswith(("pile20k", "batch"))}
    (bd / "metrics" / "calls.count.py").write_text(
        "def read(run):\n    return len(run.spans)\n")
    s["per_layer"].append({"name": "calls.count", "unit": "calls",
                           "better": "lower", "source": "program_counter",
                           "layer": "device", "moves": "body_steps_per_s",
                           "workloads": ["tiny.rollout"]})
    cell = registry.Cell(s, "tiny.rollout", bd)
    assert cell.config["scene"]["n_bodies"] == 200
    assert cell.traffic["steps_per_call"] == 4
    assert [m["name"] for m in cell.per_layer] == ["calls.count"]

    class Run:
        spans = [1, 2, 3]

    assert cell.reader("calls.count").read(Run()) == 3
    result = tiny_bench.run(s, bd, "tiny.rollout")
    assert result["correct"], result["limits"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"body_steps_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert json.loads(json.dumps(result)) == result
    assert before == {p: p.read_bytes() for p in before}
