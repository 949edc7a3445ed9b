"""The control comes out not correct: the reference computed with its
state and every stage's floats in bfloat16 (the precision below the
configuration's float32) put in the program's place. On the CPU at a
tiny size; with `-m gpu` on the card at each cell's own size on three
seeds, printing each number beside its limit:

    python -m pytest -p no:cacheprovider -m gpu -s \
        benchmark/tests/test_bench_control.py
"""

import time

import pytest
import tiny_bench

CELLS = ("pile20k.rollout", "batch4096x512.rollout", "pile20k.grad",
         "pile20k.frames")
SEEDS = (2 ** 31 + 101, 3_000_000_019, 424_242)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ("tiny.rollout", "tiny.frames",
                                  "tinyb.rollout", "tiny.grad"))
def test_control_fails_at_a_tiny_size(bench, name):
    import torch

    result = tiny_bench.run(*bench, name, control=torch.bfloat16)
    assert not result["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell's own size runs on the card")
    from harness import registry
    from harness.cell import run_cell

    cell = registry.Cell(registry.load_spec(tiny_bench.ROOT), name)
    result = run_cell(cell, seed, 0.01, False, "cuda:0", time.perf_counter(),
                      control=torch.bfloat16)
    print(f"\ncontrol {name} seed {seed}: "
          + " ".join(f"{k}={v!r}/{lim!r}"
                     for k, (v, lim) in result["limits"].items()))
    assert not result["correct"]
