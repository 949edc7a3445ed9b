"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the kernels under nudge_tpu_torch/csrc/ with nvcc;
  3. kernel vs twin: on the 20,480-box pile after 40 steps, each CUDA kernel
     (box-box narrowphase, setup, solve) against its plain PyTorch twin on
     the same CUDA tensors, with both times; the solve once more with only
     4 colors, so that the spill color's Jacobi path runs at full size;
  4. config 1: one box dropped on the ground, 500 steps, held to the rest
     gates of tests/test_engine.py;
  5. the slice: the 20,480-box pile (bench.tuned_config capacities, every
     body awake) for 150 steps through nudge_tpu_torch.engine.simulate, with
     every kernel's launch count;
  6. determinism: two 30-step runs of the pile are bitwise equal.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the lines before it hold the kernels' records and the card. The full nvcc
log goes to build/chip_smoke_build.log.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build")

N_PILE = 20480
COMPARE_AFTER = 40
SLICE_STEPS = 150
WINDOW = 25
REPEAT_STEPS = 30
CONFIG1_Y = 0.49499995     # docs/FIDELITY.md, the JAX engine's rest height
TIE_SHARE = 1e-3           # narrowphase pairs allowed to differ (near-ties)
SPILL_COLORS = 4           # colors for the forced-spill solve comparison

TPU_KERNEL_OF = {
    "box_box": "nudge_tpu/ops/narrowphase_kernel.py:535",
    "setup": "nudge_tpu/ops/setup_kernel.py:476",
    "solve": "nudge_tpu/ops/solver_kernel.py:597",
}
SOURCE_OF = {
    "box_box": "nudge_tpu_torch/csrc/narrowphase.cu",
    "setup": "nudge_tpu_torch/csrc/setup.cu",
    "solve": "nudge_tpu_torch/csrc/solve.cu",
}


def log(card, msg):
    print(f"[{card}] {msg}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the GPU port")
    import nudge_tpu_torch  # noqa: F401  (fails outside a checkout)

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    card = res.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    return card


def phase_build(card):
    from nudge_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.library()
    dt = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(lib.log)
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    log(card, f"build: {dt:.2f} s ({lib.path.name}); ptxas: "
        + " | ".join(regs))
    return dt


def pile_config(builder, n):
    """bench.tuned_config's capacities, rebuilt here (bench.py imports the
    JAX package): manifolds at 3x bodies, pairs at 8x, grid density 16.
    Sleeping and the persistent broadphase stay off (engine defaults)."""
    return builder.auto_config(
        max_box_box_pairs=max(1024, int(n * 8.0)),
        max_manifolds=max(512, int(n * 3.0)), grid_density=16,
        fat_pair_factor=2, sleeping=False, persistent_broadphase=False)


def timed(fn, reps=5, warm=2):
    """Mean milliseconds per call on the device (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Diff:
    """Checks kernel outputs against twin outputs within atol + rtol·|twin|
    and keeps the largest absolute error and the largest share of the
    tolerance that any element used."""

    def __init__(self, atol=1e-5, rtol=1e-4):
        self.atol, self.rtol = atol, rtol
        self.err = 0.0
        self.share = 0.0

    def check(self, name, a, b):
        import torch

        if a.numel() == 0:
            return
        d = torch.abs(a.float() - b.float())
        tol = self.atol + self.rtol * torch.abs(b.float())
        n_bad = int((~(d <= tol)).sum())
        err = float(d.max())
        if n_bad:
            raise AssertionError(f"{name}: {n_bad} of {a.numel()} elements "
                                 f"differ (max abs err {err:.3g})")
        self.err = max(self.err, err)
        self.share = max(self.share, float((d / tol).max()))

    def __str__(self):
        return (f"max abs err {self.err:.3g} ({100 * self.share:.1f}% of "
                f"atol {self.atol:g} + rtol {self.rtol:g})")


def phase_compare(card, dev):
    import torch

    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.ops import broadphase, cache, contacts, grid
    from nudge_tpu_torch.ops import integrate, setup_kernel, solver
    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.ops import solver_kernel

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    st, _ = engine.simulate(b.finalize(cfg, device=dev), cfg, COMPARE_AFTER)
    torch.cuda.synchronize()
    records = {}

    # --- narrowphase at the grid's candidate pairs ---
    wc = broadphase.world_colliders(st)
    bb, _, _ = grid.grid_broadphase(st, wc, cfg)
    k = npk.box_box_slots_cuda(st.boxes, wc, bb)
    p = npk.box_box_slots_plain(st.boxes, wc, bb)
    torch.cuda.synchronize()
    live = bb.valid
    n_live = int(live.sum())
    ints_same = live.clone()
    for key in ("point_valid", "feat"):
        ints_same &= (k[key] == p[key]).all(1)
    for key in ("body_a", "body_b"):
        ints_same &= k[key] == p[key]
    n_diff = int((live & ~ints_same).sum())
    if n_diff > TIE_SHARE * max(n_live, 1):
        raise AssertionError(f"box_box: {n_diff} of {n_live} live pairs "
                             "differ in their integer outputs")
    ok = ints_same & live
    pv = p["point_valid"] & ok[:, None]
    diff = Diff()
    diff.check("box_box.pos", k["pos"][pv], p["pos"][pv])
    diff.check("box_box.depth", k["depth"][pv], p["depth"][pv])
    diff.check("box_box.normal", k["normal"][ok], p["normal"][ok])
    ms = timed(lambda: npk.box_box_slots_cuda(st.boxes, wc, bb))
    plain_ms = timed(lambda: npk.box_box_slots_plain(st.boxes, wc, bb))
    records["box_box"] = dict(max_abs_err=diff.err, ms=ms, plain_ms=plain_ms)
    log(card, f"box_box: {bb.a.shape[0]} pair slots, {n_live} live, "
        f"{n_diff} differ (near-ties), {diff}; "
        f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")

    # --- setup at the step's manifolds ---
    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man = contacts.collide(st, cfg)
    warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
    col, _ = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    kcon, kvelw, kacc = setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                                pwarm)
    tcon, tvelw, tacc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                                 pwarm)
    torch.cuda.synchronize()
    diff = Diff()
    diff.check("setup.velw", kvelw, tvelw)
    for f in ("t1", "t2", "ra", "rb", "jna", "jnb", "jt1a", "jt1b", "jt2a",
              "jt2b", "mn", "mt1", "mt2", "bias", "pos_bias", "pwarm", "im_a",
              "im_b"):
        diff.check(f"setup.{f}", getattr(kcon, f), getattr(tcon, f))
    for i, (x, y) in enumerate(zip(kacc, tacc)):
        diff.check(f"setup.acc{i}", x, y)
    ms = timed(lambda: setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                               pwarm))
    plain_ms = timed(lambda: setup_kernel.setup_plain(bodies, man, warm, cfg,
                                                      col, pwarm))
    records["setup"] = dict(max_abs_err=diff.err, ms=ms, plain_ms=plain_ms)
    log(card, f"setup: {man.valid.shape[0]} manifold slots, "
        f"{int(man.valid.sum())} live, {int(col[1])} colors, "
        f"{int(col[3])} spilled; {diff}; "
        f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")

    # --- solve from the kernel's setup ---
    kv, ka, kp = solver_kernel.solve_cuda(kvelw, kcon, kacc, cfg)
    tv, ta, tp = solver_kernel.solve_plain(kvelw, kcon, kacc, cfg)
    torch.cuda.synchronize()
    diff = Diff()
    diff.check("solve.velw", kv, tv)
    for i, (x, y) in enumerate(zip(ka + (kp,), ta + (tp,))):
        diff.check(f"solve.acc{i}", x, y)
    ms = timed(lambda: solver_kernel.solve_cuda(kvelw, kcon, kacc, cfg), 3, 1)
    plain_ms = timed(lambda: solver_kernel.solve_plain(kvelw, kcon, kacc, cfg),
                     2, 1)
    log(card, f"solve: {cfg.solver_iters} sweeps; {diff}; "
        f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")

    # --- the spill color's Jacobi path: the same step colored with only
    # SPILL_COLORS colors, so most manifolds spill ---
    scfg = cfg.replace(max_colors=SPILL_COLORS)
    scol = solver.color_manifolds(man, bodies, scfg)
    scon, svelw, sacc = setup_kernel.setup_cuda(bodies, man, warm, scfg, scol,
                                                pwarm)
    kv, ka, kp = solver_kernel.solve_cuda(svelw, scon, sacc, scfg)
    tv, ta, tp = solver_kernel.solve_plain(svelw, scon, sacc, scfg)
    torch.cuda.synchronize()
    sdiff = Diff()
    sdiff.check("solve(spill).velw", kv, tv)
    for i, (x, y) in enumerate(zip(ka + (kp,), ta + (tp,))):
        sdiff.check(f"solve(spill).acc{i}", x, y)
    log(card, f"solve with {SPILL_COLORS} colors: {int(scol[3])} of "
        f"{int(man.valid.sum())} manifolds spilled; {sdiff}")
    records["solve"] = dict(max_abs_err=max(diff.err, sdiff.err), ms=ms,
                            plain_ms=plain_ms)
    return records


def phase_config1(card, dev):
    import torch

    from nudge_tpu_torch import engine, scenes

    b = scenes.scene_single_box(2.0)
    cfg = b.auto_config()
    t0 = time.perf_counter()
    st, m = engine.simulate(b.finalize(cfg, device=dev), cfg, 500)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    y = float(st.bodies.pos[1, 1])
    v = float(torch.linalg.norm(st.bodies.vel[1]))
    w = float(torch.linalg.norm(st.bodies.angvel[1]))
    ke = float(m.kinetic_energy[-1])
    if not (abs(y - 0.5) <= cfg.slop + 1e-3 and v < 1e-3 and w < 1e-2
            and bool(torch.isfinite(st.bodies.pos).all())
            and not bool(m.overflow.any()) and ke < 1e-5):
        raise AssertionError(f"config 1 gates: y={y} |v|={v} |w|={w} ke={ke}")
    log(card, f"config 1: 500 steps in {dt:.2f} s; final y {y:.8f} "
        f"(JAX reference {CONFIG1_Y}), |v| {v:.3g}, KE {ke:.3g}")


def finite_state(st):
    import torch

    b = st.bodies
    return all(bool(torch.isfinite(x).all())
               for x in (b.pos, b.quat, b.vel, b.angvel))


def phase_slice(card, dev):
    import torch

    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.ops import setup_kernel, solver_kernel

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    st = b.finalize(cfg, device=dev)
    counters = {"box_box": npk.box_box_slots, "setup": setup_kernel.setup,
                "solve": solver_kernel.solve}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t_all = 0.0
    for w0 in range(0, SLICE_STEPS, WINDOW):
        t0 = time.perf_counter()
        st, m = engine.simulate(st, cfg, WINDOW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_all += dt
        if bool(m.overflow.any()):
            raise AssertionError(f"overflow in steps {w0}..{w0 + WINDOW}: "
                                 f"bits {m.overflow_bits.tolist()}")
        if not finite_state(st):
            raise AssertionError(f"non-finite state after step {w0 + WINDOW}")
        depth = float(m.max_depth.max())
        if depth >= 0.5:
            raise AssertionError(f"max depth {depth} >= 0.5 by step "
                                 f"{w0 + WINDOW}")
        log(card, f"pile steps {w0}-{w0 + WINDOW}: {WINDOW / dt:.3f} steps/s, "
            f"contacts {int(m.contact_count[-1])}, manifolds "
            f"{int(m.manifold_demand[-1])}, pairs {int(m.pair_demand[-1])}, "
            f"max depth {depth:.4f}, KE {float(m.kinetic_energy[-1]):.4g}, "
            f"spill {int(m.spill_count.max())}")
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(card, f"pile: {SLICE_STEPS} steps in {t_all:.2f} s "
        f"({SLICE_STEPS / t_all:.3f} steps/s); launches {launches}")
    return launches


def phase_repeat(card, dev):
    import torch

    from nudge_tpu_torch import engine, scenes

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    runs = []
    for _ in range(2):
        st, m = engine.simulate(b.finalize(cfg, device=dev), cfg, REPEAT_STEPS)
        runs.append((st, m))
    torch.cuda.synchronize()
    (a, ma), (c, mc) = runs
    for f in ("pos", "quat", "vel", "angvel"):
        if not torch.equal(getattr(a.bodies, f), getattr(c.bodies, f)):
            raise AssertionError(f"repeat runs differ in bodies.{f}")
    for f in ("impulse", "pseudo", "valid"):
        if not torch.equal(getattr(a.cache, f), getattr(c.cache, f)):
            raise AssertionError(f"repeat runs differ in cache.{f}")
    if not torch.equal(ma.kinetic_energy, mc.kinetic_energy):
        raise AssertionError("repeat runs differ in kinetic energy")
    log(card, f"determinism: two {REPEAT_STEPS}-step pile runs bitwise equal")


def main():
    sys.path.insert(0, REPO)
    import torch

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build(card)
    records = phase_compare(card, dev)
    phase_config1(card, dev)
    launches = phase_slice(card, dev)
    phase_repeat(card, dev)
    kernels = [dict(name=k, route="cuda", source=SOURCE_OF[k],
                    replaces=TPU_KERNEL_OF[k], launches=launches[k],
                    **records[k]) for k in ("box_box", "setup", "solve")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
