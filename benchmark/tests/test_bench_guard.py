"""A run refuses JAX and the JAX package by whole top-level names, and a
measurement path that finds no card fails instead of using the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import tiny_bench

from harness import guard


def test_forbidden_names_are_whole_top_level_names():
    mods = ["jax.numpy", "nudge_tpu.ops.grid", "nudge_tpu_torch.engine",
            "jaxtyping", "flax.linen", "jaxlib", "torch"]
    assert guard.forbidden_modules(mods) == ["flax", "jax", "jaxlib",
                                             "nudge_tpu"]
    assert guard.forbidden_modules(["nudge_tpu_torch", "nudge_tpu_torchx",
                                    "torch.cuda"]) == []
    with pytest.raises(guard.Refused, match="nudge_tpu"):
        guard.refuse_forbidden(["nudge_tpu_torch", "nudge_tpu"])
    guard.refuse_forbidden(["nudge_tpu_torch.ops.solver"])


def test_no_card_is_refused(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(guard.Refused, match="no CUDA device"):
        guard.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(guard.Refused, match="needs 4"):
        guard.require_cards(4)


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pile20k.rollout",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=tiny_bench.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_sources_import_no_jax():
    for path in tiny_bench.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in guard.FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_program():
    for path in (tiny_bench.BENCH / "reference").rglob("*.py"):
        text = path.read_text()
        assert "nudge_tpu" not in text, path
