"""The control comes out not correct: the reference computed with its
state and every stage's floats in bfloat16 (the precision below the
configuration's float32) put in the program's place. On the CPU at a
tiny size; with `-m gpu` on the card at each cell's own size on three
seeds, printing each number beside its limit:

    python -m pytest -p no:cacheprovider -m gpu -s \
        benchmark/tests/test_bench_control.py

With `-m gpu` also the reference mode at full size: BASELINE config 4's
20,480-box pile with sleeping and the persistent broadphase, stepped from
spawn in compiled calls of 100 to the first call that ends at or below
half its bodies awake, then one more call of 100 steps, whose steps 1 and
100 the reference takes from the program's states: the sound readings
pass `pile20k.rollout`'s limits, the control's fail them.
"""

import json
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
                                  "tinyb.rollout", "tiny.grad",
                                  "tinyr.rollout"))
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


# r5_c4_fidelity's scene, bench.py's scene, and a large seed
REF_SEEDS = (3, 0, 2 ** 31 + 211)
CALL, SHARE, MAX_STEPS = 100, 0.5, 6000   # steps a call, awake share


def reference_mode_config() -> dict:
    """`pile20k` (BASELINE config 4's capacities) in the reference mode."""
    config = json.loads((tiny_bench.BENCH / "configs/pile20k.json")
                        .read_text())
    config["sim"].update(sleeping=True, persistent_broadphase=True)
    return config


def reference_mode_readings(config: dict, seed: int, device) -> dict:
    """The check's numbers, sound and control, on one call of CALL steps
    from the first call boundary at or below SHARE of the bodies awake,
    stepped there from the seed's spawn in calls of CALL."""
    import torch

    from harness import calls, check, system
    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import persistent_bp

    sysm = system.build(config, seed, device)
    cfg, n = sysm.cfg, sysm.n_dynamic
    state, steps = sysm.state, 0
    while True:
        state, m = engine.simulate(state, cfg, CALL)
        steps += CALL
        awake = int(m.awake_count[-1])
        if awake <= SHARE * n or steps >= MAX_STEPS:
            break
    assert awake <= SHARE * n, f"{awake} of {n} awake after {steps} steps"
    s_in = state
    parked0 = engine.step.parked
    rebuilds0 = persistent_bp.persistent_broadphase.rebuilds
    s_out, m = engine.simulate(s_in, cfg, CALL)
    parked = engine.step.parked - parked0
    rebuilds = persistent_bp.persistent_broadphase.rebuilds - rebuilds0
    gate = [bool(g) for g in calls.gates(m, s_out).cpu()]
    s_1, m_1 = engine.simulate(s_in, cfg, 1)
    pre, m_pre = engine.simulate(s_in, cfg, CALL - 1)
    replay = sum(int((a != b[:CALL - 1]).sum()) + int((c != b[:1]).sum())
                 for a, b, c in zip(vars(m_pre).values(), vars(m).values(),
                                    vars(m_1).values()))
    spawn = system.reference_spawn(config, seed, cfg, device)
    limits = check.load_limits(tiny_bench.BENCH, "pile20k.rollout")
    out = {"entry_step": steps, "awake": awake, "bodies": n,
           "awake_end": int(m.awake_count[-1]),
           "parked_steps": parked, "rebuild_steps": rebuilds,
           "gates": gate}
    for name, control in (("sound", None), ("control", torch.bfloat16)):
        cmp = check.Comparison(cfg)
        cmp.spawn(sysm.state, spawn)
        cmp.worst("replay_mismatch", replay)
        judge = check.judge_with(cmp, cfg, control)
        t = time.perf_counter()
        judge(s_in, s_1, check.metrics_row(m, 0))
        judge(pre, s_out, check.metrics_row(m, CALL - 1))
        out[name + "_check_s"] = time.perf_counter() - t
        out[name], rows = cmp.judge(limits)
        out[name + "_numbers"] = {k: [v, lim] for k, v, lim in rows}
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("seed", REF_SEEDS)
def test_reference_mode_control_fails_on_the_card(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pile's own size runs on the card")
    got = reference_mode_readings(reference_mode_config(), seed, "cuda:0")
    print(f"\nreference mode seed {seed}: " + json.dumps(got))
    assert got["sound"], got["sound_numbers"]
    assert not got["control"], got["control_numbers"]
