"""An earlier commit against this checkout, end to end on the card, in turns.

    python3 scripts/torch_ab.py DIR

DIR holds the earlier commit, unpacked with `git archive`. Runs, each in a
process of its own and in the order parent, change, change, parent:

  - the awake 20,480-box pile (chip_smoke.py's phase 5: scene_pile(20480),
    bench.tuned_config capacities) for 150 steps from spawn, in windows of
    25 steps;
  - the fidelity scene (scene_pile(20480, seed=3)) in the reference mode
    (sleeping and the persistent broadphase) for 300 steps from spawn, in
    windows of 100 steps;
  - config 3 (chip_smoke.py's phase 6: scene_pile(2048, sphere_frac=0.25),
    all three pair classes) for 300 steps from spawn, in windows of 50.

Each run prints its steps/s by window (host clock around windows that end
in torch.cuda.synchronize()) and its trajectory: the contact count and the
kinetic energy at the end of every window, and in the reference mode the
total energy E = KE + sum m g y. The script fails unless the four
trajectories are identical. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PILE_STEPS, PILE_WINDOW = 150, 25
REF_STEPS, REF_WINDOW = 300, 100
MIXED_STEPS, MIXED_WINDOW = 300, 50
CASES = {"pile": PILE_WINDOW, "ref": REF_WINDOW, "mixed": MIXED_WINDOW}


def chip_smoke():
    """This checkout's chip_smoke.py (its scene configs, not a tree's)."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(cs, st, cfg, steps, window, energy):
    import torch

    from nudge_tpu_torch import engine

    sps, traj = [], []
    for _ in range(steps // window):
        t0 = time.perf_counter()
        st, m = engine.simulate(st, cfg, window)
        torch.cuda.synchronize()
        sps.append(window / (time.perf_counter() - t0))
        point = [int(m.contact_count[-1]), float(m.kinetic_energy[-1])]
        if energy:
            point.append(cs.total_energy(st, cfg))
        traj.append(point)
    return dict(sps=sps, traj=traj)


def measure(root, label):
    """Run in a process of its own, with `root`'s package."""
    sys.path.insert(0, root)
    from nudge_tpu_torch import _build, scenes

    cs = chip_smoke()
    _build.library()
    dev = "cuda"
    b = scenes.scene_pile(cs.N_PILE)
    cfg = cs.pile_config(b, cs.N_PILE)
    pile = run(cs, b.finalize(cfg, device=dev), cfg, PILE_STEPS, PILE_WINDOW,
               False)
    b = scenes.scene_pile(cs.N_PILE, seed=cs.FIDELITY_SEED)
    cfg = cs.reference_config(b, cs.N_PILE)
    ref = run(cs, b.finalize(cfg, device=dev), cfg, REF_STEPS, REF_WINDOW,
              True)
    b, cfg = cs.mixed_scene()
    mixed = run(cs, b.finalize(cfg, device=dev), cfg, MIXED_STEPS,
                MIXED_WINDOW, False)
    print(json.dumps(dict(label=label, pile=pile, ref=ref, mixed=mixed)),
          flush=True)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        measure(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    sys.path.insert(0, REPO)
    print(chip_smoke().phase_device(), flush=True)
    parent = os.path.abspath(sys.argv[1])
    runs = []
    for label, root in (("parent", parent), ("change", REPO),
                        ("change", REPO), ("parent", parent)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", root, label], cwd=REPO,
                             check=True, capture_output=True, text=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(res)
        print(f"{label}: awake pile steps/s by window "
              f"{[round(x, 3) for x in res['pile']['sps']]}; reference "
              f"pile steps/s by window "
              f"{[round(x, 3) for x in res['ref']['sps']]}; config 3 "
              f"steps/s by window "
              f"{[round(x, 3) for x in res['mixed']['sps']]}", flush=True)
    for case, window in CASES.items():
        trajs = [r[case]["traj"] for r in runs]
        if any(t != trajs[0] for t in trajs[1:]):
            raise SystemExit(f"{case}: the trajectories differ: {trajs}")
        print(f"{case}: the four trajectories are identical: (contacts, KE"
              + (", E" if case == "ref" else "") + f") every {window} "
              f"steps {trajs[0]}", flush=True)


if __name__ == "__main__":
    main()
