"""The box-box, coloring and one-point kernels against their twins, and
setup's and the backward kernels' times, on the card.

    python3 scripts/torch_kernel_probe.py [--parent DIR]

Copies nudge_tpu_torch under build/kernel_probe/ (git-ignored):

  committed  this checkout's package;
  parent     with --parent, the nudge_tpu_torch of DIR (an earlier commit
             unpacked with `git archive`).

For each, in a process of its own:

  - ptxas's registers, stack frame and spills of the box-box, coloring,
    one-point, setup and solve kernels (forward and backward);
  - the box-box kernel against its twin on the 20,480-box pile after 40
    steps (the step's grid pairs: 163,840 slots, ~48,500 live) and on a
    copy of those pairs with only the first LOW_LIVE live (the tail dead,
    as the compaction leaves it): live pairs whose integer outputs differ,
    the largest float difference on the others, the device time and the
    wrapper's time (CUDA events);
  - the coloring at 24 and at 4 colors on the same step's manifolds:
    bitwise against the twin, ten launches from one input equal, device
    time and device kernels a call;
  - the one-point kernel against its twin on config 3 (chip_smoke.py's
    mixed scene) after 120 steps, on every live pair, with its device
    time, the device operations a call enqueues and the wrapper's time;
    and the same three of contacts.narrowphase_all on the same step's
    pairs of all three classes;
  - setup (`setup_kernel.setup_cuda`: its kernels and the warm start) on
    the pile's step-40 inputs (chip_smoke.py `step_inputs`): the device
    time, the device operations a call enqueues and the wrapper's time;
  - setup's backward (`setup_backward_cuda`) on the same inputs, and the
    solve's (`solve_backward_cuda`, from a tape of the twin's setup packed
    into the kernel's layout, as chip_smoke.py phase 18 runs it) there at
    the step's 6 colors and at 4 (the spill color): for each the full
    call's device time and device operations, the backward kernel's own
    device time from torch.profiler over PROFILED calls (CUDA events
    cannot tell one kernel of a call from the others; how many of the
    kernel's launches the profiler recorded is printed beside it) with the
    call's largest device kernels, and the wrapper's time.

The pile's and config 3's states are made once by the committed kernels
and shared by both trees. Needs one NVIDIA GPU; prints the card's name and power limit, then
one line per tree and case.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "kernel_probe")
STATE = os.path.join(OUT, "state.pt")
MIXED_STATE = os.path.join(OUT, "mixed_state.pt")
LOW_LIVE = 3000          # live pairs of the low-live copy (~the settled pile's)
REPS = 20                # calls a profiled time averages
PROFILED = 5             # calls under torch.profiler for a kernel's own time
GRAD_SEED = 7


def load(name, path):
    """A module of this checkout by its file (its helpers, not the
    parent's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_smoke():
    return load("probe_chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def timing():
    """nudge_tpu_torch/utils/timing.py (it imports only torch)."""
    return load("probe_timing", os.path.join(REPO, "nudge_tpu_torch", "utils",
                                             "timing.py"))


def make_tree(name, src_root=REPO):
    """A copy of src_root's package under OUT/name."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(src_root, "nudge_tpu_torch"),
                    os.path.join(root, "nudge_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def make_state(cs):
    import torch

    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.ops import contacts

    b = scenes.scene_pile(cs.N_PILE)
    cfg = cs.pile_config(b, cs.N_PILE)
    st, _ = engine.simulate(b.finalize(cfg), cfg, cs.COMPARE_AFTER)
    bx, wc, bb = cs.box_box_inputs(st, cfg)
    man, _ = contacts.collide(st, cfg)
    dyn = st.bodies.inv_mass > 0.0
    torch.save((bx, wc, bb, man.body_a, man.body_b, man.valid, dyn, st, cfg),
               STATE)


def make_mixed_state(cs):
    import torch

    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import broadphase, grid

    b, cfg = cs.mixed_scene()
    st, _ = engine.simulate(b.finalize(cfg), cfg, cs.MIXED_COMPARE_AFTER)
    wc = broadphase.world_colliders(st)
    torch.save((st, cfg, wc, *grid.grid_broadphase(st, wc, cfg)),
               MIXED_STATE)


def one_point_case(cs, name, st, cfg, wc, bb, bs, ss):
    import torch

    from nudge_tpu_torch.ops import contacts
    from nudge_tpu_torch.ops import narrowphase_1pt as p1pt

    args = (st.boxes, st.spheres, wc, bs, ss)
    k = p1pt.pairs_1pt_slots_cuda(*args)
    p = p1pt.pairs_1pt_slots_plain(*args)
    torch.cuda.synchronize()
    live = torch.cat([bs.valid, ss.valid])
    differ = [key for key in ("body_a", "body_b", "point_valid", "feat",
                              "pos", "depth", "normal", "friction")
              if not torch.equal(k[key][live], p[key][live])]
    call = lambda: p1pt.pairs_1pt_slots_cuda(*args)  # noqa: E731
    dev = timing().device_ms(call, reps=REPS)
    ops = cs.fmt_ops(timing().device_ops(call))
    ms = cs.timed(call, reps=REPS)

    def np_all():
        return contacts.narrowphase_all(st, wc, bb, bs, ss, cfg)

    all_dev = timing().device_ms(np_all, reps=REPS)
    all_ops = cs.fmt_ops(timing().device_ops(np_all))
    all_ms = cs.timed(np_all, reps=REPS)
    print(f"{name}: pairs_1pt config 3: {live.shape[0]} slots, "
          f"{int(live.sum())} live, live fields not bitwise equal to the "
          f"twin: {differ or 'none'}; device {dev:.4f} ms (a call enqueues "
          f"{ops}), wrapper {ms:.4f} ms; narrowphase_all ({bb.a.shape[0]} "
          f"box-box slots): device {all_dev:.4f} ms, a call enqueues "
          f"{all_ops}, wrapper {all_ms:.4f} ms", flush=True)


def box_box_case(cs, name, label, bx, wc, bb):
    import torch

    from nudge_tpu_torch.ops import narrowphase_kernel as npk

    k = npk.box_box_slots_cuda(bx, wc, bb)
    p = npk.box_box_slots_plain(bx, wc, bb)
    torch.cuda.synchronize()
    live = bb.valid
    same = live.clone()
    for key in ("point_valid", "feat"):
        same &= (k[key] == p[key]).all(1)
    for key in ("body_a", "body_b"):
        same &= k[key] == p[key]
    pv = p["point_valid"] & same[:, None]
    err = 0.0
    for key, mask in (("pos", pv), ("depth", pv), ("normal", same),
                      ("friction", same)):
        if bool(mask.any()):
            err = max(err, float((k[key][mask] - p[key][mask]).abs().max()))
    dead_valid = int(k["point_valid"][~live].any(1).sum())
    ms = cs.timed(lambda: npk.box_box_slots_cuda(bx, wc, bb), reps=REPS)
    call = lambda: npk.box_box_slots_cuda(bx, wc, bb)  # noqa: E731
    dev = timing().device_ms(call, reps=REPS)
    ops = cs.fmt_ops(timing().device_ops(call))
    print(f"{name}: box_box {label}: {live.shape[0]} slots, "
          f"{int(live.sum())} live, {int((live & ~same).sum())} live pairs "
          f"differ in integers, max float diff {err:.3g}, {dead_valid} dead "
          f"slots with a valid point; device {dev:.4f} ms (a call "
          f"enqueues {ops}), wrapper {ms:.4f} ms", flush=True)


def coloring_case(cs, name, body_a, body_b, valid, dyn, max_colors):
    import torch

    from nudge_tpu_torch.ops import coloring_kernel as ck

    args = (body_a, body_b, valid, dyn, dyn.shape[0], max_colors)
    p = ck.color_rounds_plain(*args)
    k = ck.color_rounds_cuda(*args)
    torch.cuda.synchronize()
    repeats = all(torch.equal(ck.color_rounds_cuda(*args), k)
                  for _ in range(9))
    ms = cs.timed(lambda: ck.color_rounds_cuda(*args), reps=REPS)
    call = lambda: ck.color_rounds_cuda(*args)  # noqa: E731
    dev = timing().device_ms(call, reps=REPS)
    ops = cs.fmt_ops(timing().device_ops(call))
    print(f"{name}: coloring {max_colors} colors: bitwise "
          f"{torch.equal(k, p)} ({int((k != p).sum())} of {k.shape[0]} "
          f"differ), ten launches equal {repeats}, {int(p.max()) + 1} "
          f"rounds; device {dev:.4f} ms (a call enqueues {ops}), "
          f"wrapper {ms:.4f} ms", flush=True)


def setup_case(cs, name, st, cfg):
    from nudge_tpu_torch.ops import setup_kernel

    bodies, man, warm, pwarm, col, order = cs.step_inputs(st, cfg)

    def call():
        return setup_kernel.setup_cuda(bodies, man, warm, cfg, col, pwarm,
                                       order)

    dev = timing().device_ms(call, reps=REPS)
    ops = cs.fmt_ops(timing().device_ops(call))
    ms = cs.timed(call, reps=REPS)
    print(f"{name}: setup awake pile: {int(man.valid.sum())} live "
          f"manifolds; device {dev:.4f} ms (a call enqueues {ops}), wrapper "
          f"{ms:.4f} ms", flush=True)


def kernel_ms(fn, kernel):
    """(mean device ms, launches recorded) of the device kernel whose name
    holds `kernel` over PROFILED calls of fn under torch.profiler, and the
    call's largest device kernels (ms a call each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    total, count, by_kernel = 0.0, 0, []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if kernel in e.key:
            total += t
            count += e.count
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_kernel.append((t / PROFILED / 1e3, e.key[:48]))
    top = "; ".join(f"{name} {ms:.4f}" for ms, name in sorted(by_kernel)[::-1][:4])
    return (total / count / 1e3 if count else float("nan")), count, top


def setup_backward_case(cs, name, inputs, cfg):
    import torch

    from nudge_tpu_torch.ops import setup_kernel, solver_kernel

    bodies, man, warm, pwarm, col, order = inputs
    dev = bodies.pos.device
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    live = torch.arange(m, device=dev) < order.offsets[cfg.max_colors]
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED)
    d_rows = torch.randn((solver_kernel.ROWS, m), generator=gen,
                         device=dev) * live
    d_rows[solver_kernel.ROW_OFFSET["relax"]:] = 0.0
    d_work = torch.randn((solver_kernel.WORK_ROWS, m), generator=gen,
                         device=dev) * live
    d_work[16:] = 0.0
    d_frame = torch.randn((2, m, 3), generator=gen, device=dev) \
        * man.valid[None, :, None]
    d_velw = torch.randn((n, solver_kernel.VEL_ROW), generator=gen,
                         device=dev)
    args = (bodies, man, warm, pwarm, col[2], order, cfg,
            setup_kernel.uses_pwarm(pwarm, cfg), d_rows, d_work, d_frame,
            d_velw)

    def call():
        return setup_kernel.setup_backward_cuda(*args)

    dev_ms = timing().device_ms(call, reps=REPS)
    ops = cs.fmt_ops(timing().device_ops(call))
    k_ms, k_n, top = kernel_ms(call, "setup_bwd_kernel")
    ms = cs.timed(call, reps=REPS)
    print(f"{name}: setup_bwd awake pile: {int(man.valid.sum())} live "
          f"manifolds; the call: device {dev_ms:.4f} ms (a call enqueues "
          f"{ops}), wrapper {ms:.4f} ms; setup_bwd_kernel alone {k_ms:.4f} "
          f"ms (profiler, {k_n} of {PROFILED} launches recorded); the call's "
          f"largest kernels, ms a call: {top}", flush=True)


def solve_backward_case(cs, name, inputs, cfg, label):
    import torch

    from nudge_tpu_torch.ops import setup_kernel, solver_kernel

    bodies, man, warm, pwarm, col, order = inputs
    dev = bodies.pos.device
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    tcon, tvelw, tacc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                                 pwarm)
    packed, work = setup_kernel.pack_constraints(tcon, tacc, order)
    tape = torch.empty((cfg.solver_iters, solver_kernel.TAPE_ROWS, m),
                       dtype=torch.float32, device=dev)
    solver_kernel._solve_launch(tvelw.clone(), packed, work.clone(), cfg,
                                tape)
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED)
    g_v = torch.randn((n, solver_kernel.VEL_ROW), generator=gen, device=dev)
    g_o = torch.randn((4, m, 4), generator=gen, device=dev) \
        * man.valid[None, :, None]

    def call():
        return solver_kernel.solve_backward_cuda(packed.rows, tape, packed,
                                                 cfg, g_v, g_o)

    dev_ms = timing().device_ms(call, reps=REPS)
    ops = cs.fmt_ops(timing().device_ops(call))
    k_ms, k_n, top = kernel_ms(call, "solve_bwd_kernel")
    ms = cs.timed(call, reps=REPS)
    print(f"{name}: solve_bwd awake pile, {label}: {int(tcon.n_colors)} "
          f"colors, {int(tcon.spill_count)} spilled, "
          f"{int(man.valid.sum())} live manifolds, {cfg.solver_iters} sweeps; "
          f"the call: device {dev_ms:.4f} ms (a call enqueues {ops}), wrapper "
          f"{ms:.4f} ms; solve_bwd_kernel alone {k_ms:.4f} ms (profiler, "
          f"{k_n} of {PROFILED} launches recorded); the call's largest "
          f"kernels, ms a call: {top}", flush=True)


def backward_cases(cs, name, st, cfg):
    from nudge_tpu_torch.ops import solver, solver_kernel

    inputs = cs.step_inputs(st, cfg)
    setup_backward_case(cs, name, inputs, cfg)
    solve_backward_case(cs, name, inputs, cfg, "the step's colors")
    bodies, man, warm, pwarm, _, _ = inputs
    scfg = cfg.replace(max_colors=cs.SPILL_COLORS)
    scol = solver.color_manifolds(man, bodies, scfg)
    sorder = solver_kernel.color_order(man, bodies, scol, scfg)
    solve_backward_case(cs, name, (bodies, man, warm, pwarm, scol, sorder),
                        scfg, f"{cs.SPILL_COLORS} colors")


def measure(root):
    """Run in a process of its own, with `root`'s copy of the package."""
    sys.path.insert(0, root)
    import torch

    from nudge_tpu_torch import _build

    cs = chip_smoke()
    name = os.path.basename(root)
    report = cs.ptxas_report(_build.library().log)
    print(f"{name}: ptxas " + "; ".join(
        f"{k} {r} regs, {fr} B stack frame, {ss}/{sl} B spill stores/loads"
        for k, (r, fr, ss, sl) in sorted(report.items())
        if k.startswith(("box_box", "color", "pairs_1pt", "setup", "warm",
                          "solve", "segment"))), flush=True)
    if not os.path.exists(STATE):
        make_state(cs)
    bx, wc, bb, body_a, body_b, valid, dyn, st, cfg = torch.load(
        STATE, weights_only=False)
    box_box_case(cs, name, "awake pile", bx, wc, bb)
    low = bb.valid & (torch.cumsum(bb.valid.int(), 0) <= LOW_LIVE)
    zero = torch.zeros_like(bb.a)
    box_box_case(cs, name, f"first {LOW_LIVE} live", bx, wc, bb.replace(
        a=torch.where(low, bb.a, zero), b=torch.where(low, bb.b, zero),
        valid=low))
    for mc in (24, cs.SPILL_COLORS):
        coloring_case(cs, name, body_a, body_b, valid, dyn, mc)
    setup_case(cs, name, st, cfg)
    backward_cases(cs, name, st, cfg)
    if not os.path.exists(MIXED_STATE):
        make_mixed_state(cs)
    one_point_case(cs, name, *torch.load(MIXED_STATE, weights_only=False))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    sys.path.insert(0, REPO)
    os.makedirs(OUT, exist_ok=True)
    for path in (STATE, MIXED_STATE):
        if os.path.exists(path):
            os.remove(path)
    print(chip_smoke().phase_device(), flush=True)
    trees = [make_tree("committed")]
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        trees.append(make_tree("parent", src_root=sys.argv[2]))
    failed = []
    for root in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", root], cwd=REPO)
        if res.returncode:
            failed.append(os.path.basename(root))
    if failed:
        raise SystemExit(f"trees that failed: {failed}")


if __name__ == "__main__":
    main()
