"""Where a pass of the one-launch solve kernel spends its time, on the card.

    python3 scripts/torch_solve_probe.py

Builds copies of nudge_tpu_torch (under build/solve_probe/, git-ignored)
whose csrc/solve.cu (or csrc/common.cuh) differs from the committed one in
one place each, and times the solve kernel of each with CUDA events at
1, 5 and 20 sweeps on the 20,480-box pile after 40 steps (cached
coloring, and 4 colors with a spill color). Per pass = (time at 20 sweeps - time at 5) / (15 x colors).
The variants:

  kernel       csrc/solve.cu as committed;
  threads128   128 threads per CTA instead of 256;
  threads512   512 threads per CTA;
  cluster8     a cluster of 8 CTAs instead of 16;
  velw_only    each manifold only loads and stores its bodies' velw rows
               (the barrier, the velocity round trip and the stores);
  barrier_only each manifold does nothing (the barrier and the loop).

The last two give wrong velocities: only their times mean anything. The
pile's state is made once by the committed kernels and shared by every
variant. Needs one NVIDIA GPU; prints one line per variant and case.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "solve_probe")
STATE = os.path.join(OUT, "state.pt")

HEAD = "  auto q = [&](int f) { return __ldg(R + f * fm); };\n"
VELW = "  load_row(A.velw + kVelRow * b, oldb);\n"
VARIANTS = {
    "kernel": [],
    "threads128": [("constexpr int kSolveThreads = 256;",
                    "constexpr int kSolveThreads = 128;")],
    "threads512": [("constexpr int kSolveThreads = 256;",
                    "constexpr int kSolveThreads = 512;")],
    "cluster8": [("constexpr int kMaxCluster = 16;",
                  "constexpr int kMaxCluster = 8;")],
    "velw_only": [(VELW, VELW + """  if (fm > 0) {
    if (q(kRowImA) > 0.0f) store_row(A.velw + kVelRow * a, olda);
    if (q(kRowImB) > 0.0f) store_row(A.velw + kVelRow * b, oldb);
    return;
  }
""")],
    "barrier_only": [(HEAD, HEAD + "  if (fm > 0) return;\n")],
}


def make_tree(name, edits):
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "nudge_tpu_torch"),
                    os.path.join(root, "nudge_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    csrc = os.path.join(root, "nudge_tpu_torch", "csrc")
    for old, new in edits:
        for f in ("solve.cu", "common.cuh"):
            path = os.path.join(csrc, f)
            src = open(path).read()
            if old in src:
                open(path, "w").write(src.replace(old, new))
                break
        else:
            raise RuntimeError(f"{name}: no csrc file holds {old!r}")
    return root


def measure(root):
    """Run in a process of its own, with `root`'s copy of the package."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.ops import cache, contacts, integrate, setup_kernel
    from nudge_tpu_torch.ops import solver, solver_kernel
    from nudge_tpu_torch.utils import timing

    b = scenes.scene_pile(cs.N_PILE)
    cfg = cs.pile_config(b, cs.N_PILE)
    if os.path.exists(STATE):
        bodies, man, warm, pwarm, colors = torch.load(STATE,
                                                      weights_only=False)
    else:
        st, _ = engine.simulate(b.finalize(cfg), cfg, cs.COMPARE_AFTER)
        bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
        man, _ = contacts.collide(st, cfg)
        warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
        colors = st.colors
        torch.save((bodies, man, warm, pwarm, colors), STATE)
    name = os.path.basename(root)
    for mc in (cfg.max_colors, cs.SPILL_COLORS):
        c2 = cfg.replace(max_colors=mc)
        if mc == cfg.max_colors:
            col, _ = solver.color_manifolds_cached(man, bodies, c2, colors)
        else:
            col = solver.color_manifolds(man, bodies, c2)
        order = solver_kernel.color_order(man, bodies, col, c2)
        con, velw, work = setup_kernel.setup_cuda(bodies, man, warm, c2, col,
                                                  pwarm, order)
        ms = {}
        for iters in (1, 5, 20):
            c3 = c2.replace(solver_iters=iters)
            v, w = velw.clone(), work.clone()
            ms[iters] = timing.device_ms(
                lambda: solver_kernel.solve_cuda(v, con, w, c3), reps=5)
        n_col = int(col[1])
        per_pass = (ms[20] - ms[5]) / (15 * n_col) * 1e3
        print(f"{name}: {n_col} colors, {int(col[3])} spilled; solve "
              f"kernel {ms[1]:.4f} / {ms[5]:.4f} / {ms[20]:.4f} ms at 1 / 5 "
              f"/ 20 sweeps; {per_pass:.2f} us a pass", flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    os.makedirs(OUT, exist_ok=True)
    if os.path.exists(STATE):
        os.remove(STATE)
    for name, edits in VARIANTS.items():
        root = make_tree(name, edits)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--measure", root], check=True, cwd=REPO)


if __name__ == "__main__":
    main()
