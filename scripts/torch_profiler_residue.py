"""How a torch.profiler session slows the launches that come after it in
the same process, on the card.

    python3 scripts/torch_profiler_residue.py

Puts the 20,480-box pile (chip_smoke's reference mode) to sleep at spawn,
so every step parks, and times 50-step rollouts on the host clock
(synchronised), compiled (engine.simulate: graph replays) and eager
(engine.step in a loop), six of each; then holds a torch.profiler session
over three eager steps and times both again. Prints each rollout's
milliseconds and the card. chip_smoke.py runs every profiler window after
its timed phases because of what this shows.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, ROLLOUTS = 50, 6


def main():
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from nudge_tpu_torch import engine, scenes

    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_residue: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    b = scenes.scene_pile(cs.N_PILE, seed=cs.FIDELITY_SEED)
    cfg = cs.reference_config(b, cs.N_PILE)
    st = b.finalize(cfg, device="cuda")
    st = st.replace(sleep=st.sleep.replace(
        awake=torch.zeros_like(st.sleep.awake)))
    engine.simulate(st, cfg, 1)          # build the kernels, capture the step
    cs.eager_simulate(st, cfg, 1)

    def rollouts(label, sim):
        ms = []
        for _ in range(ROLLOUTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim(st, cfg, STEPS)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"{label}: ms per {STEPS} parked steps "
              + ", ".join(f"{t:.2f}" for t in ms))

    rollouts("compiled, before a profiler session", engine.simulate)
    rollouts("eager, before a profiler session", cs.eager_simulate)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cs.eager_simulate(st, cfg, 3)
        torch.cuda.synchronize()
    rollouts("compiled, after a profiler session", engine.simulate)
    rollouts("eager, after a profiler session", cs.eager_simulate)
    print(card)


if __name__ == "__main__":
    main()
