"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the kernels under nudge_tpu_torch/csrc/ with nvcc and
     prints each kernel's registers, stack frame and spills from ptxas
     (a template instance apart: the backward kernels' shape and mass
     instances, the 17-column per-body sum); the box-box kernel and every
     instance of the four backward kernels must have no stack frame and
     no spill;
  3. kernel vs twin: on the 20,480-box pile after 40 steps, each CUDA kernel
     (box-box narrowphase, setup, solve, coloring rounds) against its plain
     PyTorch twin on the same CUDA tensors, with both times, the kernel's
     device time from CUDA events and the device operations a call
     enqueues from a CUDA graph capture (nudge_tpu_torch/utils/timing.py;
     box-box, the solve and the coloring one kernel and nothing else):
     box-box on every live pair
     of the step's candidate pairs (floats bitwise, dead slots without a
     valid point); setup over the live slots of
     the solve's color-sorted order, unpacked to manifold order and held to
     the twin on every live manifold; the solve from the twin's setup
     packed into the kernel's layout, bitwise equal to the twin, its
     launches from one input bitwise equal to each other, one device
     kernel a call; the coloring bitwise, ten launches equal, one device
     kernel a call; the solve and the coloring once more with only 4
     colors, so that the spill paths run at full size; the cached
     coloring's claim rounds from the step's joined colors, with 24 and
     with 4 colors, bitwise their twin, the rounds the kernel counts those
     the twin's loop ran, ten launches equal, one device kernel a call
     (again at config 5's chunk 0 in phase 16); the cache's hash join
     (read_cached_impulses from the step's cache) bitwise the twins'
     sort-merge join, its traced hits the twin's, three kernels a call, and the cached coloring through it bitwise the same
     coloring through the twins, with its device time (again in phase
     16); then
     contacts.narrowphase_all on config 3 after 120 steps, as the step
     calls it (the box-box and the one-point (box-sphere, sphere-sphere)
     kernels writing one set of buffers), against the joined twins: the
     box-box rows as above, the one-point rows bitwise on every live pair,
     at most 3 device operations a call, with its device time; and the
     one-point kernel's call into its rows of those buffers, one device
     kernel a call, with its times;
  4. config 1: one box dropped on the ground, 500 steps, held to the rest
     gates of tests/test_engine.py;
  5. the awake pile: the 20,480-box pile (bench.tuned_config capacities,
     every body awake) for 150 steps through nudge_tpu_torch.engine.simulate
     (the compiled rollout: the step captured once as a CUDA graph and
     replayed), with every kernel's launch count;
  6. config 3: the 2,048-body mixed pile (25% spheres, walls) for 300 steps,
     its spheres held above the ground;
  7. fresh coloring: the 20,480-box pile with persistent_coloring=False for
     60 steps from the state of phase 3, the coloring kernel once a step;
  8. determinism: two 30-step compiled runs of the pile, and two of config
     3, are bitwise equal, and bitwise equal to 30 eager engine.step calls
     (every state leaf, every step's metrics);
  9. config 1 asleep and parked: the single box in the reference mode
     (sleeping + persistent broadphase) for 300 steps: asleep, velocity
     exactly 0, at rest height, and the all-asleep park taken on some steps
     with no kernel launch on them;
 10. wake on impact: tests/test_sleeping.py's stack and impactor with the
     persistent broadphase, 250 steps, the impactor fired, 200 steps: the
     stack sleeps before the impact and wakes with it;
 11. the slice: the 20,480-box pile in the reference mode (bench.py's
     reference mode: tuned_config capacities, sleeping and the persistent
     broadphase) on r5_c4_fidelity's scene (seed 3) from spawn for 3,000
     eager engine.step calls (the yardstick of phase 21) in windows of
     100, box-box, setup and the solve once per active step and no kernel
     on a parked one, held in every window to no overflow, a
     finite state, every sleeper's velocity exactly 0 under its awake
     load, max depth < 0.5 and, from step 300 on, a total energy that does
     not rise; at the end to a max depth (last window, and the
     final state's resting contacts) <= 0.02, awake < 25%, no coloring
     conflict and no dead body; then box-box against its twin once more at
     step 2,150, where few of the pair slots are live, with its device time;
 12. bench.py's headline scene (seed 0) the same way, its end depth
     reported instead of gated, its settled rate (the last 500 steps),
     and two 30-step runs from its final state, bitwise equal;
 13. config 3 in the reference mode for 1,500 steps: spheres above the
     ground, total energy that does not rise from step 600 on;
 14. profile: torch.profiler over 10 eager steps of the awake pile (phase
     3's state) and of the fidelity scene at step 2,150 of phase 11
     (settling, ~700 awake): device events a step, the device's busy share,
     the host's kernel and graph launch calls a step, and the
     solve's, setup's and box-box's device time and launches a step, with
     how many of the port's kernel launches the profiler recorded (it
     drops some at times: then these are lower bounds; nothing is gated);
 15. config 2: BASELINE.md's 10 x 10 x 10 box stack (1,000 boxes) and the
     base-10 pyramid (55 boxes), auto_config() as the reference's tests
     take it, 1,000 steps each in windows of 100 with the slice gates; at
     the end every box of the stack within 0.15 of its start height and
     0.35 in x and z, the pyramid's top box within 0.1 and 0.15; steps/s,
     the broadphase auto_config chose, drift and launches; then each
     scene's final state under the profiler as in phase 14;
 16. config 5 at full width: 4,096 scenes x 512 bodies as 128 flattened
     mega-scene chunks of 32 scenes (scenes.scene_pile_megachunks,
     pile_config's capacities, the grid table grown to the chunk's
     footprint by scenes.cover_footprint) for 30 steps through
     parallel.mesh.megabatch_simulate in windows of 5, each window held to
     no overflow, a finite state, max depth < 0.5, no cross-scene
     manifold (the gates' totals kept on the card by the watched step, in
     the chunk's graph), box-box, the cached coloring, setup and the solve
     launched once a chunk-step and the one-point and fresh coloring
     kernels not at all, chunks
     0 and 127 bitwise equal to themselves stepped alone by the eager
     engine.step, chunks 0 and 1 apart;
     build seconds, steps/s, body-steps/s and peak memory (the rates
     include the gates' per-step device reductions: Config5Watch); at
     chunk 0 of the last step box-box, setup and the solve against their
     twins as in phase 3, the cached coloring's time and the joins it ran,
     and one chunk-step under the profiler. Then the same 4,096 scenes as
     16 chunks of 256 (131,073 bodies a chunk) for 30 steps, with the same
     gates and the same comparisons at its chunk 0;
 17. the stacked batch, the API and the environments: scene_pile_stacked(
     8, 512) for 10 steps through batched_simulate (batched_step_chunked
     bitwise equal to batched_step, scene 3 to itself stepped alone by the
     eager engine.step), then
     box-box, setup and the solve against their twins at scene 3's next
     step; the nudge-parity API's step on config 3 after 30 steps against
     engine.step (persistent_coloring=False, as the API colors; positions
     and velocities within 1e-6, cache ids exact, one launch of each
     kernel); 16 BoxPushEnvs for 20 vec_steps of a damped push toward
     their goals, every reward up by more than 0.5, envs 0 and 15 bitwise
     equal to themselves stepped by the eager engine.step, then the three
     kernels against their twins at env 0's next step (2 bodies, sleeping
     on).
 18. the differentiable mode: each backward kernel against autograd of
     its twin on the same inputs and a seeded output adjoint, twice
     bitwise, with its device time and device operations a call (setup's
     and the solve's also with their backward kernel's device time alone,
     one kernel a launch): the
     narrowphase's backward (box-box, and the per-collider segment sum) on
     the pile's step-40 pairs and (the one-point kernel) on config 3's
     step-120 pairs, setup's on the pile's step-40 manifolds, the solve's
     there with its 6 colors and with 4 (the spill color's adjoint),
     against its float64 twin; then 5 differentiable steps of the pile
     (the state bitwise equal to 5 steps of the normal mode, the summed
     height's gradient to the initial velocities and positions finite,
     nonzero on every body in contact, two backward runs bitwise, times
     and peak memory) and one step against the twins (the solve in
     float64); 3 differentiable steps of config 3; the 4-body gradient of
     tests/test_autodiff.py (central differences, gradient descent, the
     CPU port's gradient, and the gradient with respect to the inverse
     masses, the static ground's too, and the boxes' frictions against
     the CPU port's); the ported examples diff_throw and policy_grad, each
     to its JAX original's gain. Each backward kernel's shape or mass
     instance too, on the same inputs: the narrowphases' half extents',
     radii's and frictions' adjoints, setup's inverse masses', inertias'
     and friction's, the solve's im rows and a static side's j rows
     (against the float64 twin), within the same tolerances, twice
     bitwise, the columns the instance without also gives bitwise its
     (the solve's: within the tolerance), with their device times;
 19. the mesh: config 5's 16 x 256 layout for 30 steps through
     megabatch_simulate(mesh=) on a one-rank NCCL mesh (parallel.mesh
     .scene_mesh) from phase 16's start, stack and metrics placed Shard(0)
     on the "scenes" mesh and bitwise phase 16's unsharded end state and
     last metrics; then two gloo ranks on the one
     card (NCCL refuses two ranks on one device), 4 chunks of 32 scenes
     for 10 steps, each rank's chunks Shard(0) and bitwise the same chunks
     stepped alone by the eager engine.step in its own process;
 20. the demo (nudge_tpu_torch.examples.demo --no-render, its first 300
     steps): its steps/s beside the card;
 21. the compiled rollout: phase 11's fidelity scene from spawn for 3,000
     steps through engine.simulate (the step captured once as a CUDA
     graph; the all-asleep park, the persistent broadphase's rebuild and
     sleeping's three skips conditional nodes of the graph), with phase
     11's window and end gates, bitwise phase 11's eager run (end state,
     every step's metrics, parks and rebuilds by window), box-box, the
     cached coloring, setup and the solve once per active step and nothing
     on a parked one; its impact and settled
     steps/s beside phase 11's eager ones; at step 2,150 10 compiled steps
     under the profiler as phase 14 (busy share, device events a step, one
     graph launch a step), the device operations a replay runs, 10
     replays under torch.cuda.set_sync_debug_mode("error") (no host
     read), and the warm-up's and the capture's seconds;
 22. the compiled gradient: engine.simulate with a leaf that requires
     grad (one _RolloutFn node: the captured step's replays forward, a
     captured backward step replayed once a step in reverse) against the
     eager engine.step loop under autograd, the eager loop first and the
     compiled gradient twice: the 20,480 pile for 5 steps from step 40
     (phase 18's cell), d/d vel and pos bitwise, the same launches of
     every kernel, the backward replays under the sync debug mode "error"
     (no host read), one graph launch a backward step, forward and
     backward ms a step, peak memory, capture seconds and the device
     operations of a backward replay; config 3 for 3 steps from step 120;
     the 4-body pile w.r.t. the inverse masses and frictions (within 1e-6
     of the largest element); a resting box that parks in the window; the
     512-box reference-mode pile with a rebuild in the window; the pile's
     gradient over 60 steps (time and memory). Phase 18's examples run the
     compiled gradient (diff_throw through engine.simulate, policy_grad
     through vec_step), one eager iteration of diff_throw timed beside.

Phases 5-7, 9-13, 15-22 each zero the kernels' launch counts
before they run and read them after, and run with the plain twins (in 18
also the backward kernels' plain versions) replaced by functions that
raise: the main paths go through the kernels only. The record line gives
each kernel's launches on the earlier slices' paths (`launches`; the
backward kernels': phase 18's pile, and config 3 for the one-point one),
on each path of phases 16-20 (`launches_by_path`) and its comparison with
its twin on each of those paths (`compare_by_path`; its `max_abs_err` is
the largest of every comparison). Nothing is cut: every phase runs at the
size its docstring gives. On the card engine.simulate, step_jit and the
parallel.mesh rollouts run the compiled step (nudge_tpu_torch/control.py);
phases 11-14 step eagerly (`eager_simulate`), and every "stepped alone"
comparison is against the eager engine.step. Every torch.profiler window
(phases 14, 15, 16 and 21) runs last, after phase 22, on copies of the
states its phase saw: a profiler session leaves CUPTI attached to the
process and slows every later launch, so no timed phase runs after one.

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
SPILL_COLORS = 4           # colors for the forced-spill comparisons
N_MIXED = 2048             # BASELINE config 3
SPHERE_FRAC = 0.25         # bench.py --sphere-frac 0.25
MIXED_COMPARE_AFTER = 120  # the impact has begun
MIXED_STEPS = 300
MIXED_WINDOW = 50
FRESH_STEPS = 60
FRESH_WINDOW = 20
SPHERE_MIN_Y = 0.2         # tests/test_sphere_kernel.py's gate
CONFIG1_REF_STEPS = 300    # tests/test_sleeping.py's single-box horizon
WAKE_BEFORE, WAKE_AFTER = 250, 200   # tests/test_sleeping.py's impact test
REF_STEPS = 3000           # docs/FIDELITY.md's r5_c4_fidelity horizon
FIDELITY_SEED = 3          # r5_c4_fidelity's scene (debug_limit_cycle.py)
REF_WINDOW = 100
REF_HALF = 50              # sync points inside a window (impact rate)
IMPACT_STEPS = 150         # the impact window bench.py reports
SETTLED_TAIL = 500         # the settled-pile rate: the last 500 steps
REF_ENERGY_FROM = 300
REF_DEPTH_END = 0.02       # the reference ends at 0.0077 ~ slop
AWAKE_END = 0.25           # bench.py's sleep-onset line (< 25% awake)
MIXED_REF_STEPS = 1500
MIXED_ENERGY_FROM = 600
# Total energy may not rise window over window by more than this share of
# itself: the pile's E is ~1e6 J, float32 positions round each body's m*g*y
# to ~1e-7 of it, so rounding stays ~100x under the bound, and a rise past
# it (12 J on the 20,480 pile: one box lifted by a metre) is a real energy
# source. The largest tolerance the gate allows.
ENERGY_RTOL = 1e-5
SOLVE_REPEATS = 10         # launches of the solve from one input, bitwise
PROFILE_STEPS = 10         # steps under torch.profiler per profiled state
PROFILE_LEAD_S = 1.0       # idle seconds at the start of a profiler window
DEVICE_REPS = 10           # calls a device time averages
SETTLED_AT = 2150          # the fidelity scene settling (~700 awake)
CONFIG2_STEPS = 1000       # BASELINE.md config 2: 1k steps
CONFIG2_WINDOW = 100
# config 2's end gates: every box of the stack near its start, the
# pyramid's top box near its start (tests/test_engine.py's base-4 pyramid
# gates). The JAX package's own 1,000-step CPU run of these scenes
# (auto_config, allpairs): the stack's boxes within 0.0537 of their start
# heights, but 35 of them, all in the top layers, slid more than 0.1 in x
# or z, up to 0.172; so the x/z gate is twice that value, not 0.1. Its
# pyramid's top box: dy -0.0561, dx -0.0028, dz 0.0061.
STACK_DY = 0.15
STACK_DXZ = 0.35
PYRAMID_TOP_DY = 0.1
PYRAMID_TOP_DXZ = 0.15

# BASELINE config 5 (BASELINE.md:28): 4,096 scenes x 512 bodies in
# flattened mega-scene chunks (scene_pile_megachunks) at pile_config's
# capacities, sleeping and the persistent broadphase off, as the reference
# measured it (r5_config5_megachunk, bench.py bench_megachunks): 128 chunks
# of 32 scenes (16,385 bodies, 131,080 pair slots, 49,155 manifold slots a
# chunk) for 30 impact steps, then the same 4,096 scenes as 16 chunks of
# 256 (131,073 bodies a chunk) for 30. Not cut.
C5_SCENES = 4096
C5_BODIES = 512
C5_LAYOUTS = ((32, 30), (256, 30))   # (scenes a chunk, steps)
C5_WINDOW = 5              # steps a window; chunks re-run alone per window
C5_SEED = 0
# phase 17: the stacked batch, the API pipeline, the environments
STACKED_SCENES, STACKED_STEPS, STACKED_PROBE = 8, 10, 3
API_SETTLE = 30
N_ENVS, ENV_STEPS = 16, 20
ENV_GAIN = 0.5             # tests/test_envs.py's reward improvement

# The least time the card could take for a kernel's work (bound_ms): bytes
# each input read once and each output written once, over HBM's 3.35 TB/s,
# against operations over the float32 peak outside the tensor cores, 67
# TFLOP/s (NVIDIA H100 SXM data sheet, 700 W), the larger of the two. Bytes
# and operations are counted per live item of this run, from the sources:
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# box-box, per live pair, counted from csrc/narrowphase.cu as one pair's
# sequential work (adds, multiplies, divides, square roots, abs, min/max
# and float compares): both cases run the two rotations (60),
# R, t, |R| and tB (96), the 6 face axes with their pick (53), the 9 edge
# axes with theirs (180), the case test (7) and friction (3): 399. The
# face case adds the frame and the incident quad (115), the 24 candidates
# (4 vertices 24, 4 corners 180, 16 edge crossings 368, depths 72), the
# four reduction passes (514) and the 4 points out (86): 1,770 in all.
# The edge case adds the axis (28), the supporting edges (81), their
# closest points (31) and the point out (56): 595 in all. Phase 3 weights
# them by the live pairs of each case (edge-case pairs carry feature ids
# >= 1024).
BOXBOX_OPS_FACE = 1770
BOXBOX_OPS_EDGE = 595
# one-point: ~200 per live pair (csrc/narrowphase_1pt.cu)
PAIRS_1PT_OPS_PER_PAIR = 200
# device operations a call of contacts.narrowphase_all may enqueue on a
# mixed scene: the box-box and the one-point kernels write one set of
# buffers and nothing else joins the pair classes' slots
NP_ALL_OPS = 3
# setup, per live manifold: 156 B of geometry, warm starts and ids, relax
# 4 B and 36 B of order, slot and body-sorted entries in; 556 B of rows, 64
# B of accumulators and 24 B of frame out; ~2,200 operations (three
# effective masses and the biases for each of 4 points). Per body: 68 B of
# state in, 48 B of velw out.
SETUP_BYTES_PER_MANIFOLD = 156 + 4 + 36 + 556 + 64 + 24
SETUP_BYTES_PER_BODY = 68 + 48
SETUP_OPS_PER_MANIFOLD = 2200
# solve, per live manifold: 556 B of rows, 64 B of accumulators and its 4 B
# slot in (the accumulators out, 64 B, count per manifold slot); ~750
# operations a sweep (the 4-point chain with the pseudo channel). Per body
# velw in and out.
SOLVE_BYTES_PER_MANIFOLD = 556 + 64 + 4
SOLVE_OPS_PER_MANIFOLD = 750
# A backward kernel's bound counts the work the gradient needs, not the
# work of the algorithm that computes it: a vector-Jacobian product needs
# the forward once and its adjoint, at most a small multiple of the
# forward's operations (the cheap-gradient principle; Griewank and
# Walther, Evaluating Derivatives, ch. 4), for the live items only. The
# bound takes three times the forward's operations.
BWD_OPS_FACTOR = 3

TPU_KERNEL_OF = {
    "box_box": "nudge_tpu/ops/narrowphase_kernel.py:535",
    "pairs_1pt": "nudge_tpu/ops/narrowphase_kernel.py:762",
    "coloring": "nudge_tpu/ops/coloring_kernel.py:246",
    # no TPU kernel: the reference's cached coloring runs its claim rounds
    # as an XLA while loop
    "coloring_cached": "nudge_tpu/ops/solver.py:202",
    # no TPU kernel: the reference's cache joins are an XLA sort
    "join": "nudge_tpu/ops/cache.py:58",
    "setup": "nudge_tpu/ops/setup_kernel.py:476",
    "solve": "nudge_tpu/ops/solver_kernel.py:597",
    # the backward kernels supply the gradient the TPU kernels never had
    # (the reference differentiates their XLA twins instead)
    "box_box_bwd": "nudge_tpu/ops/narrowphase_kernel.py:535",
    "pairs_1pt_bwd": "nudge_tpu/ops/narrowphase_kernel.py:762",
    "setup_bwd": "nudge_tpu/ops/setup_kernel.py:476",
    "solve_bwd": "nudge_tpu/ops/solver_kernel.py:597",
}
SOURCE_OF = {
    "box_box": "nudge_tpu_torch/csrc/narrowphase.cu",
    "pairs_1pt": "nudge_tpu_torch/csrc/narrowphase_1pt.cu",
    "coloring": "nudge_tpu_torch/csrc/coloring.cu",
    "coloring_cached": "nudge_tpu_torch/csrc/coloring.cu",
    "join": "nudge_tpu_torch/csrc/join.cu",
    "setup": "nudge_tpu_torch/csrc/setup.cu",
    "solve": "nudge_tpu_torch/csrc/solve.cu",
    "box_box_bwd": "nudge_tpu_torch/csrc/narrowphase.cu",
    "pairs_1pt_bwd": "nudge_tpu_torch/csrc/narrowphase_1pt.cu",
    "setup_bwd": "nudge_tpu_torch/csrc/setup.cu",
    "solve_bwd": "nudge_tpu_torch/csrc/solve_bwd.cu",
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


# the entry functions of nudge_tpu_torch/csrc/
DEVICE_KERNELS = ("box_box_kernel", "pairs_1pt_kernel", "setup_kernel",
                  "warm_apply_kernel", "solve_kernel", "color_kernel",
                  "box_box_bwd_kernel", "pairs_1pt_bwd_kernel",
                  "setup_bwd_kernel", "setup_body_sum_kernel", "solve_bwd_kernel",
                  "segment_sum_kernel", "set_if_kernel", "join_insert_kernel",
                  "join_probe_kernel")
# kernels that must keep every value in registers: no stack frame, no spill
NO_SPILL_KERNELS = ("box_box_kernel", "solve_bwd_kernel", "setup_bwd_kernel",
                    "box_box_bwd_kernel", "pairs_1pt_bwd_kernel")


def ptxas_report(build_log):
    """{kernel: (registers, stack frame bytes, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output, by the name in DEVICE_KERNELS
    that the mangled name holds."""
    import re

    out, name, frame = {}, None, (0, 0, 0)
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            short = next((k for k in DEVICE_KERNELS if k in name), name)
            # a template instance: the backward kernels' shape and mass
            # instances (bool true), the 17-column per-body sum
            short += ("<shape/mass>" if "ILb1E" in name else
                      "<17>" if "ILi17E" in name else "")
            out[short] = (int(m.group(1)), *frame)
            name, frame = None, (0, 0, 0)
    return out


def phase_build(card):
    from nudge_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.library()
    dt = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(lib.log)
    report = ptxas_report(lib.log)
    log(card, f"build: {dt:.2f} s ({lib.path.name}); ptxas (registers, "
        "stack frame, spill stores, spill loads in bytes): " + "; ".join(
            f"{k} {r} regs, {fr} B frame, {ss}/{sl} B spill"
            for k, (r, fr, ss, sl) in sorted(report.items())))
    for base in NO_SPILL_KERNELS:
        names = [k for k in report if k.split("<")[0] == base]
        if base not in report:
            raise AssertionError(f"the build log holds no ptxas report for "
                                 f"{base}")
        for k in names:
            _, frame, st, ld = report[k]
            if frame or st or ld:
                raise AssertionError(f"{k}: {frame} B stack frame, {st} B "
                                     f"spill stores, {ld} B spill loads, "
                                     "not 0")
    return dt


def mixed_scene():
    """BASELINE config 3: scene_pile(2048, sphere_frac=0.25), which rings
    the pile with walls, at pile_config's capacities (box-box pairs 16,384,
    manifolds 6,144, grid density 16); the box-sphere and sphere-sphere
    pair caps are auto_config's."""
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_MIXED, sphere_frac=SPHERE_FRAC)
    return b, pile_config(b, N_MIXED)


def pile_config(builder, n):
    """bench.tuned_config's capacities, rebuilt here (bench.py imports the
    JAX package): manifolds at 3x bodies, pairs at 8x, grid density 16.
    Sleeping and the persistent broadphase stay off (engine defaults)."""
    return builder.auto_config(
        max_box_box_pairs=max(1024, int(n * 8.0)),
        max_manifolds=max(512, int(n * 3.0)), grid_density=16,
        fat_pair_factor=2, sleeping=False, persistent_broadphase=False)


def reference_config(builder, n):
    """bench.py's reference mode (`bench.py:324`): tuned_config's
    capacities with sleeping and the persistent broadphase on. At 20,480
    bodies: 163,840 tight and 327,680 fat box-box pair slots, 61,440
    manifold slots and parked-pair rows, grid density 16."""
    return pile_config(builder, n).replace(sleeping=True,
                                           persistent_broadphase=True)


def counters():
    """The launch-counting wrapper of each kernel, by kernel name."""
    from nudge_tpu_torch.ops import cache, coloring_kernel, narrowphase_1pt
    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.ops import setup_kernel, solver_kernel

    return {"box_box": npk.box_box_slots,
            "pairs_1pt": narrowphase_1pt.pairs_1pt_slots_cuda,
            "coloring": coloring_kernel.color_rounds,
            "coloring_cached": coloring_kernel.color_rounds_cached,
            "join": cache.hash_join,
            "setup": setup_kernel.setup, "solve": solver_kernel.solve}


def grad_counters():
    """The launch-counting wrapper of each backward kernel (phase 18)."""
    from nudge_tpu_torch.ops import narrowphase_1pt, setup_kernel
    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.ops import solver_kernel

    return {"box_box_bwd": npk.box_box_adjoint_cuda,
            "pairs_1pt_bwd": narrowphase_1pt.pairs_1pt_adjoint_cuda,
            "setup_bwd": setup_kernel.setup_backward_cuda,
            "solve_bwd": solver_kernel.solve_backward_cuda}


class KernelsOnly:
    """Zeroes every launch count on entry and, while active, replaces each
    kernel's plain twin with a function that raises: a run inside it goes
    through the kernels or fails. `launches` holds the counts on exit.
    With `backward`, the backward kernels' counts too, and their plain
    versions (autograd of the twins, the segment sum's index_add) raise as
    well."""

    def __init__(self, backward=False):
        from nudge_tpu_torch.ops import cache, coloring_kernel, contacts
        from nudge_tpu_torch.ops import narrowphase
        from nudge_tpu_torch.ops import narrowphase_1pt, segment, setup_kernel
        from nudge_tpu_torch.ops import narrowphase_kernel as npk
        from nudge_tpu_torch.ops import solver_kernel

        self.twins = [(npk, "box_box_slots_plain"), (narrowphase, "box_box"),
                      (narrowphase_1pt, "pairs_1pt_slots_plain"),
                      (contacts, "narrowphase_joined_plain"),
                      (narrowphase, "box_sphere"),
                      (narrowphase, "sphere_sphere"),
                      (coloring_kernel, "color_rounds_plain"),
                      (coloring_kernel, "color_rounds_cached_plain"),
                      (cache, "_join_plain"), (cache, "join_i32_plain"),
                      (setup_kernel, "setup_plain"),
                      (solver_kernel, "solve_plain")]
        self.counters = counters()
        if backward:
            self.twins += [(contacts, "narrowphase_backward_plain"),
                           (setup_kernel, "setup_backward_plain"),
                           (solver_kernel, "solve_backward_plain"),
                           (segment, "segment_sum_plain")]
            self.counters.update(grad_counters())
        self.saved = []
        self.launches = {}

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        for fn in self.counters.values():
            fn.launches = 0
        for mod, name in self.twins:
            self.saved.append((mod, name, getattr(mod, name)))

            def refuse(*_, _name=name, **__):
                raise AssertionError(f"plain twin {_name} ran on the main path")

            setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        import torch

        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        torch.cuda.synchronize()
        self.launches = {k: fn.launches for k, fn in self.counters.items()}
        return False


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


def bound(n_bytes, n_ops):
    """bound_ms and bound_by for a kernel that must move n_bytes and do
    n_ops float operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def short_name(name):
    """A device kernel's name without namespaces, template arguments and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1] or name


def fmt_ops(ops):
    return ", ".join(f"{n} {k}{'s' * (n != 1)}"
                     for k, n in sorted(ops.items())) or "nothing"


def one_kernel(label, ops):
    """Fail unless a call enqueued one kernel and no other device
    operation (`timing.device_ops`)."""
    if ops != {"kernel": 1}:
        raise AssertionError(f"{label}: a call enqueues {fmt_ops(ops)}, not "
                             "one kernel")


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


def compare_solve(label, packed, work, velw, con, acc, cfg, bitwise):
    """The solve kernel from packed inputs against solve_plain from the
    same constraints (bit for bit when `bitwise`); SOLVE_REPEATS launches
    from one input bitwise equal; one kernel and nothing else enqueued a
    call. Returns (Diff, wrapper ms, device ms)."""
    import torch

    from nudge_tpu_torch.ops import solver_kernel
    from nudge_tpu_torch.utils import timing

    def run(v, w):
        v, a, p = solver_kernel.solve_cuda(v, packed, w, cfg)
        return [v, *a, p]

    k = run(velw.clone(), work.clone())
    tv, ta, tp = solver_kernel.solve_plain(velw, con, acc, cfg)
    torch.cuda.synchronize()
    diff = Diff()
    for name, x, y in zip(("velw", "acc_n", "acc_t1", "acc_t2", "pacc"), k,
                          [tv, *ta, tp]):
        if bitwise and not torch.equal(x, y):
            raise AssertionError(f"{label}.{name}: not bitwise equal to the "
                                 "twin")
        diff.check(f"{label}.{name}", x, y)
    for rep in range(1, SOLVE_REPEATS):
        again = run(velw.clone(), work.clone())
        for x, y in zip(again, k):
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: launch {rep + 1} from the "
                                     "same input differs from the first")
    v, w = velw.clone(), work.clone()
    ms = timed(lambda: run(v, w))
    one_kernel(label, timing.device_ops(lambda: run(v, w)))
    return diff, ms, timing.device_ms(lambda: run(v, w), DEVICE_REPS)


def box_box_inputs(st, cfg):
    """(boxes, world colliders, box-box pairs) as a step from `st` hands
    them to the box-box kernel: contacts.collide's own, captured."""
    from nudge_tpu_torch.ops import contacts

    seen = []
    real = contacts.box_box_slots

    def grab(bx, wc, bb):
        seen.append((bx, wc, bb))
        return real(bx, wc, bb)

    contacts.box_box_slots = grab
    try:
        contacts.collide(st, cfg)
    finally:
        contacts.box_box_slots = real
    return seen[0]


def check_box_box_rows(label, k, p, live):
    """Box-box kernel slots `k` against twin slots `p` of the same pairs:
    every dead slot without a valid point, every live slot's ids equal, no
    more than TIE_SHARE of the live pairs differing in their other integer
    outputs, the floats of the rest bitwise equal. Returns (Diff, live
    pairs that differ)."""
    import torch

    n_live = int(live.sum())
    if bool(k["point_valid"][~live].any()):
        raise AssertionError(f"box_box ({label}): a dead slot has a valid "
                             "point")
    for key in ("ga", "gb"):
        if not torch.equal(k[key][live], p[key][live]):
            raise AssertionError(f"box_box ({label}): {key} differs on live "
                                 "pairs")
    ints_same = live.clone()
    for key in ("point_valid", "feat"):
        ints_same &= (k[key] == p[key]).all(1)
    for key in ("body_a", "body_b"):
        ints_same &= k[key] == p[key]
    n_diff = int((live & ~ints_same).sum())
    if n_diff > TIE_SHARE * max(n_live, 1):
        raise AssertionError(f"box_box ({label}): {n_diff} of {n_live} live "
                             "pairs differ in their integer outputs")
    ok = ints_same & live
    pv = p["point_valid"] & ok[:, None]
    diff = Diff()
    diff.check("box_box.pos", k["pos"][pv], p["pos"][pv])
    diff.check("box_box.depth", k["depth"][pv], p["depth"][pv])
    diff.check("box_box.normal", k["normal"][ok], p["normal"][ok])
    diff.check("box_box.friction", k["friction"][ok], p["friction"][ok])
    if diff.err != 0.0:
        raise AssertionError(f"box_box ({label}): floats not bitwise equal "
                             f"to the twin on live pairs ({diff})")
    return diff, n_diff


def compare_box_box(card, label, bx, wc, bb):
    """The box-box kernel against its twin on every live pair
    (check_box_box_rows); one kernel and nothing else enqueued a call; the
    kernel's device time. Returns the record fields."""
    import torch

    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.utils import timing

    k = npk.box_box_slots_cuda(bx, wc, bb)
    p = npk.box_box_slots_plain(bx, wc, bb)
    torch.cuda.synchronize()
    live = bb.valid
    n_live = int(live.sum())
    n_slots = live.shape[0]
    diff, n_diff = check_box_box_rows(label, k, p, live)
    n_edge = int((live & (p["feat"][:, 0] >= 1024)).sum())
    ms = timed(lambda: npk.box_box_slots_cuda(bx, wc, bb))
    plain_ms = timed(lambda: npk.box_box_slots_plain(bx, wc, bb))
    one_kernel(f"box_box ({label})", timing.device_ops(
        lambda: npk.box_box_slots_cuda(bx, wc, bb)))
    dev_ms = timing.device_ms(lambda: npk.box_box_slots_cuda(bx, wc, bb),
                              DEVICE_REPS)
    # pair_valid in and point_valid out for every slot; per live pair its
    # two indices in and the rest of the slot's row out
    out_bytes = sum(v[0].numel() * v.element_size() for v in k.values())
    wc_bytes = sum(t.numel() * t.element_size() for t in wc)
    rec = dict(max_abs_err=diff.err, ms=ms, plain_ms=plain_ms,
               device_ms=dev_ms,
               **bound(wc_bytes + n_slots * (1 + 4)
                       + n_live * (8 + out_bytes - 4),
                       (n_live - n_edge) * BOXBOX_OPS_FACE
                       + n_edge * BOXBOX_OPS_EDGE))
    log(card, f"box_box ({label}): {n_slots} pair slots, {n_live} live "
        f"({n_edge} edge case), {n_diff} differ (near-ties), {diff}; "
        f"dead slots without a valid point; one kernel a call; kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f} ms), twin "
        f"{plain_ms:.3f} ms; bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return rec


def compare_coloring(card, man, dyn, max_colors):
    """The coloring kernel against its twin, bit for bit; SOLVE_REPEATS
    launches from one input equal; one kernel and nothing else enqueued a
    call. Returns (wrapper ms, twin ms, device ms)."""
    import torch

    from nudge_tpu_torch.ops import coloring_kernel as ck
    from nudge_tpu_torch.utils import timing

    args = (man.body_a, man.body_b, man.valid, dyn, dyn.shape[0], max_colors)
    k = ck.color_rounds_cuda(*args)
    p = ck.color_rounds_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(
            f"coloring ({max_colors} colors): {int((k != p).sum())} of "
            f"{k.shape[0]} raw colors differ")
    for rep in range(1, SOLVE_REPEATS):
        if not torch.equal(ck.color_rounds_cuda(*args), k):
            raise AssertionError(f"coloring ({max_colors} colors): launch "
                                 f"{rep + 1} from the same input differs")
    ms = timed(lambda: ck.color_rounds_cuda(*args))
    plain_ms = timed(lambda: ck.color_rounds_plain(*args))
    one_kernel(f"coloring ({max_colors} colors)",
               timing.device_ops(lambda: ck.color_rounds_cuda(*args)))
    dev_ms = timing.device_ms(lambda: ck.color_rounds_cuda(*args),
                              DEVICE_REPS)
    log(card, f"coloring with {max_colors} colors: bitwise equal, "
        f"{SOLVE_REPEATS} launches equal, one device kernel a call; "
        f"{int(p.max()) + 1} rounds used, "
        f"{int(((p < 0) & man.valid).sum())} of {int(man.valid.sum())} "
        f"manifolds left uncolored; kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms), twin {plain_ms:.3f} ms")
    return ms, plain_ms, dev_ms


def cached_start(man, bodies, cfg, ccache):
    """The colors the cached coloring's claim rounds start from at a step:
    each manifold's color joined from `ccache`, or -1, as
    solver.color_manifolds_cached hands them to
    coloring_kernel.color_rounds_cached."""
    from nudge_tpu_torch.ops import solver

    real, got = solver.color_rounds_cached, []

    def spy(*args):
        got.append(args[4].clone())
        return real(*args)

    solver.color_rounds_cached = spy
    try:
        solver.color_manifolds_cached(man, bodies, cfg, ccache)
    finally:
        solver.color_rounds_cached = real
    return got[0]


def compare_coloring_cached(card, label, man, dyn, start, max_colors):
    """The cached coloring's kernel against its twin from the same joined
    start colors, bit for bit, and the rounds it counts (the `claim_rounds`
    count) against those the twin's loop ran; SOLVE_REPEATS launches from
    one input equal; one kernel and nothing else enqueued a call. The
    kernel writes the colors in place, so each call starts from a copy of
    `start`, and its device time is the copy and the call less the copy
    alone. Returns the kernel record (bound: bytes of the live rows, the
    claim tables and the masks)."""
    import torch

    from nudge_tpu_torch import trace
    from nudge_tpu_torch.ops import coloring_kernel as ck
    from nudge_tpu_torch.utils import timing

    n = dyn.shape[0]
    buf = torch.empty_like(start)
    what = f"cached coloring ({label}, {max_colors} colors)"

    def call():
        buf.copy_(start)
        return ck.color_rounds_cached_cuda(man.body_a, man.body_b, man.valid,
                                           dyn, buf, n, max_colors)

    with trace.on(), trace.span("coloring_cached"):
        k = call().clone()
    rounds = [s.counts["claim_rounds"] for s in trace.collect().spans
              if "claim_rounds" in s.counts]
    p = ck.color_rounds_cached_plain(man.body_a, man.body_b, man.valid, dyn,
                                     start.clone(), n, max_colors)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"{what}: {int((k != p).sum())} of {k.shape[0]} "
                             "raw colors differ from the twin's")
    new = man.valid & (start < 0)
    left = int((new & (p < 0)).sum())
    want = (0 if not bool(new.any()) else max_colors - 1 if left
            else int(p[new].max()) + 1)
    if rounds != [want]:
        raise AssertionError(f"{what}: the kernel counts rounds {rounds}, "
                             f"the twin's loop ran {want}")
    for rep in range(1, SOLVE_REPEATS):
        if not torch.equal(call(), k):
            raise AssertionError(f"{what}: launch {rep + 1} from the same "
                                 "input differs")
    one_kernel(what, timing.device_ops(
        lambda: ck.color_rounds_cached_cuda(man.body_a, man.body_b,
                                            man.valid, dyn, buf, n,
                                            max_colors)))
    ms = timed(call)
    plain_ms = timed(lambda: ck.color_rounds_cached_plain(
        man.body_a, man.body_b, man.valid, dyn, start.clone(), n, max_colors),
        1, 0)
    copy_ms = timing.device_ms(lambda: buf.copy_(start), DEVICE_REPS)
    dev_ms = timing.device_ms(call, DEVICE_REPS) - copy_ms
    n_live = int(man.valid.sum())
    words = (max_colors + 31) // 32
    # per live manifold body ids, start color in, raw color out; the live
    # flag of every slot; per body the dynamic flag, two claim keys and the
    # mask words written and read
    rec = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
               **bound(n_live * 16 + man.valid.shape[0]
                       + n * (1 + 16 + 8 * words), 0))
    log(card, f"{what}: bitwise equal, {SOLVE_REPEATS} launches equal, one "
        f"device kernel a call; {n_live} live, {int((start >= 0).sum())} "
        f"cached, {int(new.sum())} to color, {left} left uncolored; "
        f"{rounds[0]} rounds (latency floor {rounds[0]} rounds + 2 "
        f"barriers); kernel {ms:.4f} ms a call with its copy (device "
        f"{dev_ms:.4f} ms, copy {copy_ms:.4f}), twin {plain_ms:.3f} ms; "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def compare_join(card, label, st, inputs, cfg):
    """The hash join (csrc/join.cu) at a step's manifolds against the
    twins, bit for bit: read_cached_impulses from the step's cache against
    the twin's sort-merge join (its CPU route) on the same CUDA tensors,
    with the traced hits equal to the twin's and at least one cache-table
    slot read a live point; and the cached coloring with its join of last
    step's colors (`_join` or `join_i32`, as the step picks) against the
    same coloring through the twins. The read join's device time and
    operations a call (three kernels: reset, insert, probe), and its bound by the bytes of live rows: a key
    (12 B) and a payload (16 B) a live cache row, a key a live point, a
    payload (16 B) written for every point."""
    import torch

    from nudge_tpu_torch import trace
    from nudge_tpu_torch.ops import cache, solver
    from nudge_tpu_torch.utils import timing

    bodies, man = inputs[0], inputs[1]
    c = st.cache
    m, p = man.feat.shape
    what = f"cache join ({label})"
    i32 = torch.int32

    def kernel():
        return cache.read_cached_impulses(c, man, cfg)

    def twin(payload):
        return cache._join_plain(
            c.ga, c.gb, c.feat, payload, c.valid,
            man.ga[:, None].expand(m, p).reshape(-1),
            man.gb[:, None].expand(m, p).reshape(-1), man.feat.reshape(-1),
            man.point_valid.reshape(-1))

    joined = torch.cat([c.impulse, c.pseudo[:, None]], -1)
    with trace.on(), trace.span("join"):
        kw, kp = kernel()
    counts = trace.collect().spans[0].counts
    t = twin(joined)
    for name, a, b in (("impulse", kw, t[:, 0:3].reshape(m, p, 3)),
                       ("pseudo", kp, t[:, 3].reshape(m, p))):
        if not torch.equal(a.view(i32), b.contiguous().view(i32)):
            raise AssertionError(f"{what}: {name} differs from the twin's")
    for rep in range(1, SOLVE_REPEATS):
        again = kernel()
        if not (torch.equal(again[0], kw) and torch.equal(again[1], kp)):
            raise AssertionError(f"{what}: call {rep + 1} differs")
    rows = torch.arange(1, c.valid.shape[0] + 1, device=c.valid.device)
    hits = int((twin(rows.to(torch.float32)[:, None])[:, 0] > 0).sum())
    points = int(man.point_valid.sum())
    if counts["cache_hits"] != hits or counts["cache_probes"] < points:
        raise AssertionError(f"{what}: traced counts {counts}, the twin's "
                             f"hits {hits} of {points} live points")
    ops = timing.device_ops(kernel)
    if ops != {"kernel": 3}:
        raise AssertionError(f"{what}: a call enqueues {fmt_ops(ops)}")

    # the cached coloring through the kernel's join and through the twins'
    real = cache._join, cache.join_i32
    k_col = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    cache._join, cache.join_i32 = cache._join_plain, cache.join_i32_plain
    try:
        t_col = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    finally:
        cache._join, cache.join_i32 = real
    from nudge_tpu_torch.state import flatten

    k_leaves, t_leaves = flatten(k_col)[0], flatten(t_col)[0]
    if len(k_leaves) != len(t_leaves) or not all(
            torch.equal(a, b) for a, b in zip(k_leaves, t_leaves)):
        raise AssertionError(f"{what}: the cached coloring through the "
                             "kernel's join differs from the twins'")

    ms = timed(kernel)
    plain_ms = timed(lambda: twin(joined), 3, 1)
    dev_ms = timing.device_ms(kernel, DEVICE_REPS)
    live_c = int(c.valid.sum())
    rec = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
               hits=hits, points=points, probes=counts["cache_probes"],
               **bound(28 * live_c + 12 * points + 16 * m * p, 0))
    log(card, f"{what}: bitwise equal, {SOLVE_REPEATS} calls equal, "
        f"{fmt_ops(ops)} a call; {live_c} live cache rows, {points} live "
        f"points, {hits} hits, {counts['cache_probes']} probes "
        f"({counts['cache_probes'] / max(points, 1):.4f} a point); cached "
        f"coloring through it equal to the twins'; kernel {ms:.4f} ms a "
        f"call (device {dev_ms:.4f} ms), twin {plain_ms:.3f} ms; bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def step_inputs(st, cfg):
    """What a step from `st` hands setup and the solve (every body awake):
    (bodies after gravity, manifolds, warm starts, pseudo warm starts, the
    cached coloring, the solve's order)."""
    from nudge_tpu_torch.ops import cache, contacts, integrate, solver
    from nudge_tpu_torch.ops import solver_kernel

    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = contacts.collide(st, cfg)
    warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
    col, _ = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    order = solver_kernel.color_order(man, bodies, col, cfg)
    return bodies, man, warm, pwarm, col, order


def compare_setup_solve(card, label, inputs, cfg):
    """Setup over the live slots of the solve's order against its twin,
    compared in manifold order after unpacking; then the solve from the
    twin's setup packed into the kernel's layout, so both sides start from
    the same bits (compare_solve). Returns the setup and solve records."""
    import torch

    from nudge_tpu_torch.ops import setup_kernel, solver_kernel
    from nudge_tpu_torch.utils import timing

    bodies, man, warm, pwarm, col, order = inputs
    live = man.valid
    n_live = int(live.sum())
    kcon, kvelw, kwork = setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                                 pwarm, order)
    tcon, tvelw, tacc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                                 pwarm)
    torch.cuda.synchronize()
    diff = Diff()
    diff.check("setup.velw", kvelw, tvelw)
    ucon = setup_kernel.unpack_constraints(kcon)
    for f in ("n", "t1", "t2", "ra", "rb", "jna", "jnb", "jt1a", "jt1b",
              "jt2a", "jt2b", "mn", "mt1", "mt2", "bias", "pos_bias", "pwarm",
              "mu", "im_a", "im_b", "relax"):
        diff.check(f"setup.{f}", getattr(ucon, f)[live], getattr(tcon, f)[live])
    for f in ("point_valid", "body_a", "body_b"):
        if not torch.equal(getattr(ucon, f)[live], getattr(tcon, f)[live]):
            raise AssertionError(f"setup.{f} differs on live manifolds")
    diff.check("setup.frame", kcon.frame[:, live],
               torch.stack([tcon.t1, tcon.t2])[:, live])
    for i, (x, y) in enumerate(zip(setup_kernel.unpack_acc(kwork, order),
                                   tacc)):
        diff.check(f"setup.acc{i}", x[live], y[live])
    ms = timed(lambda: setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                               pwarm, order))
    order_ms = timed(lambda: solver_kernel.color_order(man, bodies, col, cfg))
    plain_ms = timed(lambda: setup_kernel.setup_plain(bodies, man, warm, cfg,
                                                      col, pwarm))

    def setup_call():
        return setup_kernel.setup_cuda(bodies, man, warm, cfg, col, pwarm,
                                       order)

    dev_ms = timing.device_ms(setup_call, DEVICE_REPS)
    setup_ops = timing.device_ops(setup_call)
    n_bodies = bodies.pos.shape[0]
    records = {"setup": dict(
        max_abs_err=diff.err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
        **bound(n_live * SETUP_BYTES_PER_MANIFOLD
                + n_bodies * SETUP_BYTES_PER_BODY,
                n_live * SETUP_OPS_PER_MANIFOLD))}
    log(card, f"setup ({label}): {man.valid.shape[0]} manifold slots, "
        f"{n_live} live, {int(col[1])} colors, {int(col[3])} spilled; {diff}; "
        f"kernel {ms:.3f} ms (device {dev_ms:.4f} ms, a call enqueues "
        f"{fmt_ops(setup_ops)}), color order "
        f"{order_ms:.3f} ms, twin {plain_ms:.3f} ms")

    packed, work = setup_kernel.pack_constraints(tcon, tacc, order)
    diff, ms, dev = compare_solve("solve", packed, work, tvelw, tcon, tacc,
                                  cfg, bitwise=int(col[3]) == 0)
    # the twin has just run on these inputs (compare_solve): one timed call
    plain_ms = timed(lambda: solver_kernel.solve_plain(tvelw, tcon, tacc, cfg),
                     1, 0)
    log(card, f"solve ({label}): {cfg.solver_iters} sweeps x {int(col[1])} "
        f"colors in one launch of a {solver_kernel.solve_cluster_size()}-CTA "
        f"cluster; {diff}; one kernel a call; kernel {ms:.3f} ms (device "
        f"{dev:.4f} ms), twin {plain_ms:.3f} ms")
    records["solve"] = dict(
        max_abs_err=diff.err, ms=ms, plain_ms=plain_ms, device_ms=dev,
        **bound(n_live * SOLVE_BYTES_PER_MANIFOLD
                + n_bodies * 2 * 48 + man.valid.shape[0] * 64,
                n_live * cfg.solver_iters * SOLVE_OPS_PER_MANIFOLD))
    return records


def compare_step(card, label, st, cfg):
    """Box-box, setup and the solve against their twins at a step from
    `st`, on the inputs the step hands them (compare_box_box,
    compare_setup_solve). Returns (kernel records, step_inputs)."""
    records = {"box_box": compare_box_box(card, label,
                                          *box_box_inputs(st, cfg))}
    inputs = step_inputs(st, cfg)
    records.update(compare_setup_solve(card, label, inputs, cfg))
    return records, inputs


def phase_compare(card, dev):
    import torch

    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.ops import setup_kernel, solver, solver_kernel

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    st, _ = engine.simulate(b.finalize(cfg, device=dev), cfg, COMPARE_AFTER)
    torch.cuda.synchronize()
    label = f"awake pile, step {COMPARE_AFTER}"

    # --- narrowphase at the step's candidate pairs (the grid's), setup
    # and the solve at the step's manifolds ---
    records, inputs = compare_step(card, label, st, cfg)
    bodies, man, warm, pwarm, _, _ = inputs
    n_live = int(man.valid.sum())

    # --- the spill color's Jacobi path: the same step colored with only
    # SPILL_COLORS colors, so most manifolds spill ---
    scfg = cfg.replace(max_colors=SPILL_COLORS)
    scol = solver.color_manifolds(man, bodies, scfg)
    sorder = solver_kernel.color_order(man, bodies, scol, scfg)
    scon, svelw, sacc = setup_kernel.setup_plain(bodies, man, warm, scfg, scol,
                                                 pwarm)
    spacked, swork = setup_kernel.pack_constraints(scon, sacc, sorder)
    sdiff, sms, sdev = compare_solve("solve(spill)", spacked, swork, svelw,
                                     scon, sacc, scfg, bitwise=False)
    log(card, f"solve with {SPILL_COLORS} colors: {int(scol[3])} of "
        f"{n_live} manifolds spilled; {sdiff}; kernel {sms:.3f} ms (device "
        f"{sdev:.4f} ms)")
    records["solve"]["max_abs_err"] = max(records["solve"]["max_abs_err"],
                                          sdiff.err)

    # --- the coloring rounds at the step's manifolds, bit for bit ---
    dyn = bodies.inv_mass > 0.0
    for mc in (cfg.max_colors, SPILL_COLORS):
        ms, plain_ms, _ = compare_coloring(card, man, dyn, mc)
        if mc == cfg.max_colors:
            # body ids in and the raw color out per live manifold; the live
            # flag of every slot and the dynamic flag per body
            records["coloring"] = dict(
                max_abs_err=0, ms=ms, plain_ms=plain_ms,
                **bound(n_live * (4 + 4 + 4) + man.valid.shape[0]
                        + dyn.shape[0], 0))

    # --- the cached coloring's rounds from the step's joined colors, bit
    # for bit (with SPILL_COLORS the cached colors above the last are
    # clamped to it) ---
    start = cached_start(man, bodies, cfg, st.colors)
    for mc in (cfg.max_colors, SPILL_COLORS):
        rec = compare_coloring_cached(card, label, man, dyn, start, mc)
        if mc == cfg.max_colors:
            records["coloring_cached"] = rec
    records["join"] = compare_join(card, label, st, inputs, cfg)
    return records, st


def phase_compare_1pt(card, dev):
    """contacts.narrowphase_all on config 3 after MIXED_COMPARE_AFTER
    steps, as the step calls it (the box-box and the one-point kernels
    writing one set of buffers), against the joined twins: the box-box
    rows by check_box_box_rows, every live one-point row bitwise, every
    dead row without a valid point; at most NP_ALL_OPS device operations a
    call. Then the one-point kernel's call as narrowphase_all makes it (its
    rows of those buffers): one kernel and nothing else, its times.
    Returns (the one-point record fields, the state it compared at)."""
    import torch

    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import broadphase, contacts, grid
    from nudge_tpu_torch.ops import narrowphase_1pt as p1pt
    from nudge_tpu_torch.utils import timing

    b, cfg = mixed_scene()
    st, _ = engine.simulate(b.finalize(cfg, device=dev), cfg,
                            MIXED_COMPARE_AFTER)
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    n_bb = bb.a.shape[0]
    k = contacts.narrowphase_all(st, wc, bb, bs, ss, cfg)
    p = contacts.narrowphase_joined_plain(st, wc, bb, bs, ss)
    torch.cuda.synchronize()
    _, n_tie = check_box_box_rows("narrowphase_all", {
        key: v[:n_bb] for key, v in k.items()}, {
        key: v[:n_bb] for key, v in p.items()}, bb.valid)
    rows = {key: v[n_bb:] for key, v in k.items()}
    twin = {key: v[n_bb:] for key, v in p.items()}
    live = torch.cat([bs.valid, ss.valid])
    n_live = int(live.sum())
    n_slots = live.shape[0]
    if n_live == 0:
        raise AssertionError("pairs_1pt: no live box-sphere or sphere-sphere "
                             "pair to compare")
    if bool(rows["point_valid"][~live].any()):
        raise AssertionError("pairs_1pt: a dead slot has a valid point")
    for key in rows:
        if not torch.equal(rows[key][live], twin[key][live]):
            raise AssertionError(f"pairs_1pt: {key} not bitwise equal to the "
                                 "twin on live pairs")
    pv = twin["point_valid"] & live[:, None]

    def np_all():
        return contacts.narrowphase_all(st, wc, bb, bs, ss, cfg)

    all_ops = timing.device_ops(np_all)
    if sum(all_ops.values()) > NP_ALL_OPS:
        raise AssertionError(f"narrowphase_all: a call enqueues "
                             f"{fmt_ops(all_ops)}, more than {NP_ALL_OPS} "
                             "device operations")
    all_ms = timing.device_ms(np_all, DEVICE_REPS)
    args = (st.boxes, st.spheres, wc, bs, ss)

    def call():
        return p1pt.pairs_1pt_slots_cuda(*args, out=rows)

    ms = timed(call)
    plain_ms = timed(lambda: p1pt.pairs_1pt_slots_plain(*args))
    dev_ms = timing.device_ms(call, DEVICE_REPS)
    one_kernel("pairs_1pt", timing.device_ops(call))
    log(card, f"narrowphase_all: config 3 after {MIXED_COMPARE_AFTER} "
        f"steps, {n_bb} box-box slots ({int(bb.valid.sum())} live, {n_tie} "
        f"differ from the twin in integers: near-ties) and {n_slots} "
        f"one-point slots ({int(bs.valid.sum())} box-sphere, "
        f"{int(ss.valid.sum())} sphere-sphere live, {int(pv.sum())} "
        f"contacts), the one-point rows bitwise equal to the twin on every "
        f"live pair, dead slots without a valid point; a call enqueues "
        f"{fmt_ops(all_ops)}, device {all_ms:.4f} ms. pairs_1pt into its "
        f"rows: one kernel a call; kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms), twin {plain_ms:.3f} ms")
    # per slot its valid flag (1 B) in and point_valid (4 B) out; per live
    # pair its two indices (8 B) in and the rest of its row (112 B) out
    wc_bytes = sum(t.numel() * t.element_size() for t in wc)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                **bound(wc_bytes + n_slots * (1 + 4) + n_live * (8 + 112),
                        n_live * PAIRS_1PT_OPS_PER_PAIR)), st


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


def run_windows(card, label, st, cfg, steps, window, pairs_by_class=False):
    """Steps `st` through engine.simulate in windows of `window` steps and
    holds each window to the slice gates: no overflow, a finite state, max
    depth < 0.5. Returns (state, seconds stepping)."""
    import torch

    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import broadphase, grid
    from nudge_tpu_torch.utils.debug import finite_state

    t_all = 0.0
    for w0 in range(0, steps, window):
        t0 = time.perf_counter()
        st, m = engine.simulate(st, cfg, window)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_all += dt
        w1 = w0 + window
        if bool(m.overflow.any()):
            raise AssertionError(f"{label}: overflow in steps {w0}..{w1}: "
                                 f"bits {m.overflow_bits.tolist()}")
        if not finite_state(st):
            raise AssertionError(f"{label}: non-finite state after step {w1}")
        depth = float(m.max_depth.max())
        if depth >= 0.5:
            raise AssertionError(f"{label}: max depth {depth} >= 0.5 by step "
                                 f"{w1}")
        pairs = f"pairs {int(m.pair_demand[-1])}"
        if pairs_by_class:        # one more broadphase, outside the timing
            wc = broadphase.world_colliders(st)
            bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
            pairs = (f"pairs bb/bs/ss {int(bb.count)}/{int(bs.count)}/"
                     f"{int(ss.count)}")
        log(card, f"{label} steps {w0}-{w1}: {window / dt:.3f} steps/s, "
            f"contacts {int(m.contact_count[-1])}, manifolds "
            f"{int(m.manifold_demand[-1])}, {pairs}, max depth {depth:.4f}, "
            f"KE {float(m.kinetic_energy[-1]):.4g}, "
            f"spill {int(m.spill_count.max())}")
    return st, t_all


def need_launches(label, launches, kernels):
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} was not launched")


def eager_simulate(st, cfg, steps):
    """`steps` eager engine.step calls (a Python loop, each step with its
    predicate reads), the metrics stacked as engine.simulate stacks them:
    the yardstick the compiled rollout is held to."""
    import torch

    from nudge_tpu_torch import engine

    ms = []
    for _ in range(steps):
        st, m = engine.step(st, cfg)
        ms.append(m)
    return st, type(ms[0])(**{k: torch.stack([getattr(m, k) for m in ms])
                              for k in vars(ms[0])})


def per_active_step(label, launches, active):
    """Box-box, the cached coloring's rounds, setup and the solve once per
    active step; the one-point kernel and the fresh coloring's not at all
    (the reference pile's path)."""
    want = {"box_box": active, "coloring_cached": active, "setup": active,
            "solve": active, "pairs_1pt": 0, "coloring": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, not {want} "
                             f"({active} active steps)")


def phase_slice(card, dev):
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    st = b.finalize(cfg, device=dev)
    with KernelsOnly() as run:
        st, t_all = run_windows(card, "pile", st, cfg, SLICE_STEPS, WINDOW)
    need_launches("pile", run.launches, ("box_box", "setup", "solve"))
    log(card, f"pile: {SLICE_STEPS} steps in {t_all:.2f} s "
        f"({SLICE_STEPS / t_all:.3f} steps/s); launches {run.launches}")
    return run.launches


def phase_mixed(card, dev):
    """Config 3 for MIXED_STEPS steps; every dynamic sphere's centre must
    stay above SPHERE_MIN_Y."""
    b, cfg = mixed_scene()
    st = b.finalize(cfg, device=dev)
    with KernelsOnly() as run:
        st, t_all = run_windows(card, "config 3", st, cfg, MIXED_STEPS,
                                MIXED_WINDOW, pairs_by_class=True)
    need_launches("config 3", run.launches,
                  ("box_box", "pairs_1pt", "setup", "solve"))
    sp = st.spheres
    body = sp.body[sp.valid].long()
    body = body[st.bodies.inv_mass[body] > 0]
    low = float(st.bodies.pos[body, 1].min())
    if low <= SPHERE_MIN_Y:
        raise AssertionError(f"config 3: a sphere's centre is at y={low} "
                             f"<= {SPHERE_MIN_Y}")
    log(card, f"config 3: {MIXED_STEPS} steps in {t_all:.2f} s "
        f"({MIXED_STEPS / t_all:.3f} steps/s); {body.shape[0]} dynamic "
        f"spheres, lowest centre y {low:.4f}; launches {run.launches}")
    return run.launches


def phase_fresh(card, st):
    """The 20,480 pile with persistent_coloring=False from the state of
    phase 3: the coloring kernel must run once per step."""
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE).replace(persistent_coloring=False)
    with KernelsOnly() as run:
        st, t_all = run_windows(card, "fresh coloring", st, cfg, FRESH_STEPS,
                                FRESH_WINDOW)
    need_launches("fresh coloring", run.launches, ("box_box", "setup", "solve"))
    if run.launches["coloring"] != FRESH_STEPS:
        raise AssertionError(f"fresh coloring: the coloring kernel ran "
                             f"{run.launches['coloring']} times in "
                             f"{FRESH_STEPS} steps")
    log(card, f"fresh coloring: {FRESH_STEPS} steps in {t_all:.2f} s "
        f"({FRESH_STEPS / t_all:.3f} steps/s); launches {run.launches}")
    return run.launches


def repeat(card, label, b, cfg, dev):
    """Two REPEAT_STEPS-step compiled runs (engine.simulate) from the same
    start must be bitwise equal, and equal, bit for bit in every state leaf
    and every step's metrics, to REPEAT_STEPS eager engine.step calls."""
    import torch

    from nudge_tpu_torch import engine

    runs = []
    for _ in range(2):
        st, m = engine.simulate(b.finalize(cfg, device=dev), cfg, REPEAT_STEPS)
        runs.append((st, m))
    eager = eager_simulate(b.finalize(cfg, device=dev), cfg, REPEAT_STEPS)
    torch.cuda.synchronize()
    (a, ma), (c, mc) = runs
    for f in ("pos", "quat", "vel", "angvel"):
        if not torch.equal(getattr(a.bodies, f), getattr(c.bodies, f)):
            raise AssertionError(f"{label} repeat runs differ in bodies.{f}")
    for f in ("impulse", "pseudo", "valid"):
        if not torch.equal(getattr(a.cache, f), getattr(c.cache, f)):
            raise AssertionError(f"{label} repeat runs differ in cache.{f}")
    if not torch.equal(ma.kinetic_energy, mc.kinetic_energy):
        raise AssertionError(f"{label} repeat runs differ in kinetic energy")
    if not (bitwise(a, eager[0]) and bitwise(ma, eager[1])):
        raise AssertionError(f"{label}: the compiled run differs from the "
                             "eager steps")
    log(card, f"determinism: two {REPEAT_STEPS}-step {label} runs bitwise "
        f"equal; compiled equals eager, bitwise (every state leaf, every "
        f"step's metrics)")


def phase_repeat(card, dev):
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_PILE)
    repeat(card, "pile", b, pile_config(b, N_PILE), dev)
    repeat(card, "config 3", *mixed_scene(), dev)


def total_energy(st, cfg):
    """KE + sum of m*g*h over the dynamic bodies (KE as StepMetrics counts
    it, h along -gravity), in float64."""
    import torch

    b = st.bodies
    m_inv = b.inv_mass.double()
    mass = torch.where(m_inv > 0, 1.0 / m_inv.clamp_min(1e-12), 0.0)
    v = b.vel.double()
    g = torch.tensor(cfg.gravity, dtype=torch.float64, device=b.pos.device)
    return float(0.5 * torch.sum(mass * (v * v).sum(-1))
                 - torch.sum(mass * (b.pos.double() @ g)))


def phase_config1_parked(card, dev):
    """Config 1 in the reference mode: the box falls asleep, and the park
    (no kernel launch) takes over."""
    import torch

    from nudge_tpu_torch import engine, scenes

    b = scenes.scene_single_box(2.0)
    cfg = b.auto_config(sleeping=True, persistent_broadphase=True)
    st = b.finalize(cfg, device=dev)
    parked = 0
    awake = []
    with KernelsOnly() as run:
        t0 = time.perf_counter()
        for _ in range(CONFIG1_REF_STEPS):
            before = sum(fn.launches for fn in counters().values())
            p0 = engine.step.parked
            st, m = engine.step(st, cfg)
            awake.append(m.awake_count)
            if engine.step.parked > p0:
                parked += 1
                if sum(fn.launches for fn in counters().values()) != before:
                    raise AssertionError("config 1 asleep: a kernel was "
                                         "launched on a parked step")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    need_launches("config 1 asleep", run.launches, ("box_box", "setup",
                                                    "solve"))
    awake = torch.stack(awake).tolist()
    y = float(st.bodies.pos[1, 1])
    still = not (bool(st.bodies.vel[1].any()) or bool(st.bodies.angvel[1].any()))
    if (bool(st.sleep.awake[1]) or awake[-1] != 0 or not still
            or abs(y - 0.5) >= 0.02 or parked == 0):
        raise AssertionError(f"config 1 asleep gates: awake {awake[-1]}, "
                             f"velocity zero {still}, y {y}, parked steps "
                             f"{parked}")
    log(card, f"config 1 asleep: {CONFIG1_REF_STEPS} steps in {dt:.2f} s; "
        f"asleep from step {awake.index(0) + 1}, parked on {parked} steps "
        f"with no kernel launch; y {y:.8f}, velocity exactly 0; launches "
        f"{run.launches}")


def phase_wake(card, dev):
    """tests/test_sleeping.py's impact test with the persistent
    broadphase: the stack sleeps, the impactor wakes it."""
    import torch

    from nudge_tpu_torch import engine
    from nudge_tpu_torch.scenes import SceneBuilder
    from nudge_tpu_torch.utils.debug import finite_state

    b = SceneBuilder()
    b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    for i in range(3):
        b.add_box((0.5, 0.5, 0.5), (0, 0.5 + i * 1.001, 0))
    b.add_box((0.5, 0.5, 0.5), (-6.0, 0.5, 0), mass=4.0)
    cfg = b.auto_config(sleeping=True, sleep_frames=30,
                        persistent_broadphase=True)
    with KernelsOnly() as run:
        st, _ = engine.simulate(b.finalize(cfg, device=dev), cfg, WAKE_BEFORE)
        asleep_before = not bool(st.sleep.awake[1:4].any())
        parked_pairs = int((st.sleep.pairs[:, 0] >= 0).sum())
        vel = st.bodies.vel.clone()
        vel[4] = torch.tensor([8.0, 0.0, 0.0], device=dev)
        awake = st.sleep.awake.clone()
        awake[4] = True
        st = st.replace(bodies=st.bodies.replace(vel=vel),
                        sleep=st.sleep.replace(awake=awake))
        st, m = engine.simulate(st, cfg, WAKE_AFTER)
    need_launches("wake", run.launches, ("box_box", "setup", "solve"))
    woke = int(m.awake_count.max())
    if not (asleep_before and parked_pairs >= 2 and woke >= 4
            and finite_state(st)):
        raise AssertionError(f"wake gates: stack asleep before {asleep_before}"
                             f", parked pairs {parked_pairs}, awake after "
                             f"{woke}, finite {finite_state(st)}")
    log(card, f"wake: stack asleep after {WAKE_BEFORE} steps with "
        f"{parked_pairs} parked pairs; the impact woke {woke} bodies; "
        f"launches {run.launches}")


def run_reference(card, label, st, cfg, steps, energy_from, spheres=False,
                  keep_at=None, sim=eager_simulate):
    """Steps `st` in the reference mode through `sim` (the eager steps, or
    engine.simulate's compiled rollout) in windows of REF_WINDOW, syncing
    every REF_HALF steps, and holds every window to no overflow, a finite
    state, sleepers at exactly zero velocity, max depth < 0.5, total energy that does not rise from step
    `energy_from` on (ENERGY_RTOL) and, with `spheres`, every dynamic
    sphere's centre above SPHERE_MIN_Y. Returns (state, dict of the
    trajectory: cumulative seconds at every REF_HALF steps, awake count,
    rebuilds and parks per window, the last window's max depth, every
    step's metrics by REF_HALF, and a copy of the state after `keep_at`
    steps, a multiple of REF_HALF)."""
    import torch

    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import persistent_bp
    from nudge_tpu_torch.utils.debug import finite_state

    times, awake, rebuilds, parks, metrics = [0.0], [], [], [], []
    kept = None
    e_prev = depth = None
    sp_body = st.spheres.body[st.spheres.valid].long()
    sp_body = sp_body[st.bodies.inv_mass[sp_body] > 0]
    for w0 in range(0, steps, REF_WINDOW):
        rb0 = persistent_bp.persistent_broadphase.rebuilds
        pk0 = engine.step.parked
        ms = []
        for h in range(REF_WINDOW // REF_HALF):
            t0 = time.perf_counter()
            st, m = sim(st, cfg, REF_HALF)
            torch.cuda.synchronize()
            times.append(times[-1] + time.perf_counter() - t0)
            ms.append(m)
            metrics.append(m)
            if w0 + (h + 1) * REF_HALF == keep_at:
                kept = clone_state(st)
        w1 = w0 + REF_WINDOW
        rebuilds.append(persistent_bp.persistent_broadphase.rebuilds - rb0)
        parks.append(engine.step.parked - pk0)
        over = any(bool(m.overflow.any()) for m in ms)
        depth = max(float(m.max_depth.max()) for m in ms)
        spill = max(int(m.spill_count.max()) for m in ms)
        m = ms[-1]
        awake.append(int(m.awake_count[-1]))
        energy = total_energy(st, cfg)
        if over:
            bits = sorted({int(x) for mm in ms for x in mm.overflow_bits})
            raise AssertionError(f"{label}: overflow in steps {w0}..{w1}: "
                                 f"bits {bits}")
        if not finite_state(st):
            raise AssertionError(f"{label}: non-finite state after step {w1}")
        # sleepers are static for the solve, so the kernels never write
        # velocity into one, even under an awake load
        asleep = (st.bodies.inv_mass > 0) & ~st.sleep.awake
        if (bool(st.bodies.vel[asleep].any())
                or bool(st.bodies.angvel[asleep].any())):
            raise AssertionError(f"{label}: a sleeper has nonzero velocity "
                                 f"after step {w1}")
        if depth >= 0.5:
            raise AssertionError(f"{label}: max depth {depth} >= 0.5 in "
                                 f"steps {w0}..{w1}")
        if (e_prev is not None and w0 >= energy_from
                and energy > e_prev + ENERGY_RTOL * abs(e_prev)):
            raise AssertionError(f"{label}: total energy rose from {e_prev} "
                                 f"to {energy} in steps {w0}..{w1}")
        low = ""
        if spheres:
            y = float(st.bodies.pos[sp_body, 1].min())
            if y <= SPHERE_MIN_Y:
                raise AssertionError(f"{label}: a sphere's centre is at "
                                     f"y={y} <= {SPHERE_MIN_Y} at step {w1}")
            low = f", lowest sphere y {y:.4f}"
        log(card, f"{label} steps {w0}-{w1}: "
            f"{REF_WINDOW / (times[-1] - times[-3]):.3f} steps/s, awake "
            f"{awake[-1]}, rebuilds {rebuilds[-1]}, parked {parks[-1]}, "
            f"contacts {int(m.contact_count[-1])}, manifolds "
            f"{int(m.manifold_demand[-1])}, pairs {int(m.pair_demand[-1])}, "
            f"max depth {depth:.4f}, KE {float(m.kinetic_energy[-1]):.6g}, "
            f"E {energy:.10g}, spill {spill}{low}")
        e_prev = energy
    return st, dict(times=times, awake=awake, rebuilds=rebuilds,
                    parks=parks, depth=depth, kept=kept, metrics=metrics)


def next_step_conflicts(st, cfg):
    """(conflicts, spill, manifolds) of the coloring that a step from `st`
    runs, as the solve sees it (sleepers static); the spill color, where
    conflicts are allowed, is left out."""
    import types

    import torch

    from nudge_tpu_torch.ops import contacts, integrate, solver
    from nudge_tpu_torch.utils.debug import coloring_conflicts

    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man, _ = contacts.collide(st, cfg)
    asleep = ~st.sleep.awake
    bodies = bodies.replace(
        inv_mass=torch.where(asleep, 0.0, bodies.inv_mass),
        inv_inertia=torch.where(asleep[:, None], 0.0, bodies.inv_inertia))
    (color, _, _, spill, spill_color), _ = solver.color_manifolds_cached(
        man, bodies, cfg, st.colors)
    con = types.SimpleNamespace(color=color, body_a=man.body_a,
                                body_b=man.body_b,
                                valid=man.valid & (color != spill_color))
    return (int(coloring_conflicts(con, bodies)), int(spill),
            int(man.valid.sum()))


def clone_state(st):
    import torch

    from nudge_tpu_torch.state import tree_map

    return tree_map(torch.clone, st)


def repeat_from(card, label, st, cfg):
    """Two REPEAT_STEPS-step runs from clones of `st`: bodies, contact
    cache, sleep state and every persistent-broadphase array bitwise
    equal."""
    import dataclasses

    import torch

    from nudge_tpu_torch import engine

    a, _ = engine.simulate(clone_state(st), cfg, REPEAT_STEPS)
    c, _ = engine.simulate(clone_state(st), cfg, REPEAT_STEPS)
    torch.cuda.synchronize()
    for g in ("bodies", "cache", "sleep", "bp"):
        for f in dataclasses.fields(getattr(a, g)):
            if not torch.equal(getattr(getattr(a, g), f.name),
                               getattr(getattr(c, g), f.name)):
                raise AssertionError(f"{label} repeat runs differ in "
                                     f"{g}.{f.name}")
    log(card, f"determinism: two {REPEAT_STEPS}-step {label} runs from its "
        "final state bitwise equal (bodies, cache, sleep, bp)")


def resting_depth(st, cfg):
    """(max depth, overflow) over every contact of `st` with every body
    counted awake: sleepers keep no live contacts, so the metric of a
    parked step is 0 while the resting pile still has its depths."""
    import torch

    from nudge_tpu_torch.ops import contacts

    woke = st.replace(
        sleep=st.sleep.replace(awake=torch.ones_like(st.sleep.awake)),
        bp=st.bp.replace(stale=torch.ones_like(st.bp.stale)))
    man, _ = contacts.collide(woke, cfg)
    depth = torch.amax(torch.where(man.point_valid, man.depth, 0.0))
    return float(depth), bool(man.overflow)


def reference_pile(card, label, dev, seed, fidelity, keep_at=None,
                   sim=eager_simulate):
    """The 20,480 pile in the reference mode from spawn for REF_STEPS
    steps through `sim`, with run_reference's window gates, box-box, setup
    and the solve once per active step and no other kernel, then awake <
    AWAKE_END, no coloring conflict and no dead body at the end; with
    `fidelity` also the last window's max depth and the final state's
    resting depth at most REF_DEPTH_END. Returns (launch counts, final
    state, config, run_reference's trajectory)."""
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_PILE, seed=seed)
    cfg = reference_config(b, N_PILE)
    st = b.finalize(cfg, device=dev)
    with KernelsOnly() as run:
        st, tr = run_reference(card, label, st, cfg, REF_STEPS,
                               REF_ENERGY_FROM, keep_at=keep_at, sim=sim)
    per_active_step(label, run.launches, REF_STEPS - sum(tr["parks"]))
    t = tr["times"]
    impact = IMPACT_STEPS / t[IMPACT_STEPS // REF_HALF]
    settled = SETTLED_TAIL / (t[-1] - t[-1 - SETTLED_TAIL // REF_HALF])
    dyn = st.bodies.inv_mass > 0
    dead = int((dyn & ~st.sleep.awake
                & (st.bodies.pos[:, 1] < cfg.kill_plane_y)).sum())
    conflicts, spill, n_man = next_step_conflicts(st, cfg)
    rest, rest_over = resting_depth(st, cfg)
    awake = tr["awake"][-1]
    log(card, f"{label}: {REF_STEPS} steps in {t[-1]:.2f} s; impact steps "
        f"0-{IMPACT_STEPS} {impact:.3f} steps/s; last {SETTLED_TAIL} steps "
        f"{settled:.3f} steps/s; awake by window {tr['awake']}; rebuilds "
        f"{sum(tr['rebuilds'])} (by window {tr['rebuilds']}); parked steps "
        f"{sum(tr['parks'])}; last window max depth {tr['depth']:.4f}; "
        f"resting depth of the final state {rest:.4f} (overflow "
        f"{rest_over}); {dead} dead; {conflicts} coloring conflicts over "
        f"{n_man} manifolds ({spill} spilled); launches {run.launches}")
    ok = awake < AWAKE_END * N_PILE and conflicts == 0 and dead == 0
    if fidelity:
        ok = ok and max(tr["depth"], rest) <= REF_DEPTH_END and not rest_over
    if not ok:
        raise AssertionError(
            f"{label} end gates: awake {awake} (< {AWAKE_END * N_PILE}), "
            f"conflicts {conflicts}, dead {dead}"
            + (f", max depth {tr['depth']} and resting depth {rest} (<= "
               f"{REF_DEPTH_END})" if fidelity else ""))
    return run.launches, st, cfg, tr


def phase_reference_pile(card, dev):
    """The slice, on r5_c4_fidelity's own scene (scene_pile(20480, seed=3),
    scripts/debug_limit_cycle.py), stepped eagerly: every end gate.
    Returns (launch counts, its state at step SETTLED_AT, config, the
    eager run: its final state and trajectory, phase 21's yardstick)."""
    launches, st, cfg, tr = reference_pile(
        card, "reference pile", dev, FIDELITY_SEED, fidelity=True,
        keep_at=SETTLED_AT)
    return launches, tr["kept"], cfg, dict(state=st, **tr)


def phase_bench_pile(card, dev):
    """bench.py's headline scene (scene_pile(20480), seed 0) in the
    reference mode: its settled rate, and two bitwise-equal runs from its
    final state. Its last-window depth is reported, not gated: the
    reference's own run of this scene was not quiet either (BENCH_r05:
    4,062 awake after 3,600 steps, KE rising 4.2 -> 47.13)."""
    launches, st, cfg, _ = reference_pile(card, "bench pile", dev, 0,
                                          fidelity=False)
    with KernelsOnly():
        repeat_from(card, "bench pile", st, cfg)
    return launches


def phase_reference_mixed(card, dev):
    """Config 3 in the reference mode: the settle gate of BASELINE config
    3 (energy non-increasing after settle)."""
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_MIXED, sphere_frac=SPHERE_FRAC)
    cfg = reference_config(b, N_MIXED)
    st = b.finalize(cfg, device=dev)
    with KernelsOnly() as run:
        st, tr = run_reference(card, "config 3 reference", st, cfg,
                               MIXED_REF_STEPS, MIXED_ENERGY_FROM,
                               spheres=True)
    need_launches("config 3 reference", run.launches,
                  ("box_box", "pairs_1pt", "setup", "solve"))
    t = tr["times"]
    log(card, f"config 3 reference: {MIXED_REF_STEPS} steps in {t[-1]:.2f} s "
        f"({MIXED_REF_STEPS / t[-1]:.3f} steps/s); awake by window "
        f"{tr['awake']}; rebuilds {sum(tr['rebuilds'])}; parked steps "
        f"{sum(tr['parks'])}; launches {run.launches}")
    return run.launches


# Profiler windows queued by profile_steps, run by run_profiles after every
# timed phase: a torch.profiler session leaves CUPTI attached to the
# process, and every later launch pays for it
# (scripts/torch_profiler_residue.py on an H100 80GB HBM3 at 700 W: 50
# parked compiled steps of the 20,480 pile 6.00-6.57 ms before a session,
# 28.83-30.52 ms after it; 50 eager ones 6.29-7.90 and 7.80-10.27 ms).
DEFERRED = []


def profile_steps(card, label, st, cfg, steps=PROFILE_STEPS,
                  sim=eager_simulate, check=None):
    """Queue profile_now on a copy of `st`, and `check` (if given) on what
    it returns, for run_profiles."""
    st = clone_state(st)

    def run():
        got = profile_now(card, label, st, cfg, steps, sim)
        if check is not None:
            check(got)

    DEFERRED.append(run)


def run_profiles():
    while DEFERRED:
        DEFERRED.pop(0)()


def profile_now(card, label, st, cfg, steps, sim):
    """torch.profiler over `steps` unsynchronised steps through `sim` (the
    eager steps, or engine.simulate's compiled rollout) from a copy of
    `st` (after one step outside it): device events a step, the device's
    busy share of the host-clock window, the host's launch calls a step
    (kernel launches and graph launches, from the CUDA runtime events),
    and the device time a step of the solve, of setup and of the box-box
    narrowphase, with their launches.

    The profiler drops device events early in a window at times
    (nudge_tpu_torch/utils/timing.py), so the window opens PROFILE_LEAD_S
    before the steps, and the line says how many of the port's kernel
    launches, counted by their wrappers, the profiler recorded: where it
    recorded fewer, every number of the line is a lower bound. Nothing
    here is gated (phase 21 gates its graph launches a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    s, _ = sim(clone_state(st), cfg, 1)
    torch.cuda.synchronize()
    ours = {"box_box": ("box_box_kernel",), "pairs_1pt": ("pairs_1pt_kernel",),
            "coloring": ("color_kernel",),
            "coloring_cached": ("color_kernel",), "solve": ("solve_kernel",),
            "join": ("join_insert_kernel", "join_probe_kernel"),
            "setup": ("setup_kernel", "warm_apply_kernel")}
    before = {k: fn.launches for k, fn in counters().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        s, m = sim(s, cfg, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = sum((fn.launches - before[k]) * len(ours[k])
                   for k, fn in counters().items())
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA and \
                e.name.startswith(("cudaLaunchKernel", "cudaGraphLaunch",
                                   "cuLaunchKernel", "cudaMemcpyAsync",
                                   "cudaMemsetAsync")):
            name = e.name.split("_v")[0]     # cudaGraphLaunch_v10000
            calls[name] = calls.get(name, 0) + 1
    recorded = sum(1 for e in ev
                   if short_name(e.name) in sum(ours.values(), ()))
    busy_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    kernels = {}
    for e in ev:
        k = short_name(e.name)
        n, t = kernels.get(k, (0, 0.0))
        kernels[k] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    solve = kernels.get("solve_kernel", (0, 0.0))
    setup = [kernels.get(k, (0, 0.0)) for k in ("setup_kernel",
                                                "warm_apply_kernel")]
    box = kernels.get("box_box_kernel", (0, 0.0))
    per = steps
    log(card, f"profile {label}: {per} steps, {wall_ms / per:.2f} ms a step "
        f"under the profiler, {len(ev) / per:.1f} device events a step, "
        f"device busy {100 * busy_ms / wall_ms:.1f}% ({busy_ms / per:.3f} ms "
        f"a step); solve {solve[1] / per:.4f} ms a step in {solve[0]} "
        f"launches; setup {setup[0][1] / per:.4f} + warm start "
        f"{setup[1][1] / per:.4f} ms a step in {setup[0][0]} + {setup[1][0]} "
        f"launches; box-box {box[1] / per:.4f} ms a step in {box[0]} "
        f"launches; awake {int(m.awake_count[-1])}, manifolds "
        f"{int(m.manifold_demand[-1])}, spill {int(m.spill_count.max())}; "
        f"the profiler recorded {recorded} of the {launched} device kernels "
        f"that the port's wrappers launched in the window; host launch "
        f"calls a step " + ", ".join(f"{k} {n / per:.1f}"
                                     for k, n in sorted(calls.items())))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    log(card, f"profile {label}: top device kernels (launches, ms over "
        f"{per} steps): " + "; ".join(f"{k} {n} {t:.3f}"
                                      for k, (n, t) in top))
    return dict(ms=wall_ms / per, events=len(ev) / per,
                busy=100 * busy_ms / wall_ms,
                graph_launches=calls.get("cudaGraphLaunch", 0) / per)


def phase_profile(card, pile_state, settled, ref_cfg):
    """Device events, busy share and the solve's, setup's and box-box's
    device time on the awake pile (phase 3's state) and on the fidelity
    scene settling in the reference mode (step SETTLED_AT of phase 11)."""
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(N_PILE)
    profile_steps(card, "awake pile (step 40)", pile_state,
                  pile_config(b, N_PILE))
    profile_steps(card, f"reference pile (fidelity scene, step {SETTLED_AT})",
                  settled, ref_cfg)


def drift(st, p0):
    """(largest |dy|, largest |dx| or |dz|) of the dynamic bodies from
    their start positions `p0`."""
    dyn = st.bodies.inv_mass > 0
    d = (st.bodies.pos - p0)[dyn].abs()
    return float(d[:, 1].max()), float(d[:, [0, 2]].max())


def phase_config2(card, dev):
    """BASELINE config 2 at full size: scene_stack() (1,000 boxes in 10 x
    10 columns) and scene_pyramid() (base 10, 55 boxes), auto_config() as
    the reference's tests take it, CONFIG2_STEPS steps each in windows with
    the slice gates, the plain twins raising; at the end each box of the
    stack within STACK_DY of its start height and STACK_DXZ in x and z, the
    pyramid's top box within PYRAMID_TOP_DY and PYRAMID_TOP_DXZ."""
    import torch

    from nudge_tpu_torch import scenes
    from nudge_tpu_torch.ops import contacts

    launches = {}
    for label, b in (("stack", scenes.scene_stack()),
                     ("pyramid", scenes.scene_pyramid())):
        cfg = b.auto_config()
        st = b.finalize(cfg, device=dev)
        p0 = st.bodies.pos.clone()
        top = int(torch.nonzero(st.bodies.inv_mass > 0)[-1])
        base = contacts._base_broadphase(cfg).__name__
        with KernelsOnly() as run:
            st, t_all = run_windows(card, f"config 2 {label}", st, cfg,
                                    CONFIG2_STEPS, CONFIG2_WINDOW)
        need_launches(f"config 2 {label}", run.launches,
                      ("box_box", "setup", "solve"))
        dy, dxz = drift(st, p0)
        t = (st.bodies.pos[top] - p0[top]).tolist()
        n_dyn = int((st.bodies.inv_mass > 0).sum())
        log(card, f"config 2 {label}: {n_dyn} boxes, "
            f"broadphase {cfg.broadphase} -> {base}, {CONFIG2_STEPS} steps "
            f"in {t_all:.2f} s ({CONFIG2_STEPS / t_all:.3f} steps/s); drift "
            f"of any box: |dy| {dy:.5f}, |dx|,|dz| {dxz:.5f}; top box (body "
            f"{top}) dx {t[0]:.5f} dy {t[1]:.5f} dz {t[2]:.5f}; launches "
            f"{run.launches}")
        if label == "stack":
            ok = dy <= STACK_DY and dxz <= STACK_DXZ
        else:
            ok = (abs(t[1]) <= PYRAMID_TOP_DY
                  and max(abs(t[0]), abs(t[2])) <= PYRAMID_TOP_DXZ)
        if not ok:
            raise AssertionError(f"config 2 {label}: drift past its gates")
        launches[label] = run.launches
        profile_steps(card, f"config 2 {label} (step {CONFIG2_STEPS})", st,
                      cfg)
    return launches


def leaves(tree):
    from nudge_tpu_torch.state import tree_map

    flat = []
    tree_map(flat.append, tree)
    return flat


def same_state(a, b):
    """True iff every leaf of two states is bitwise equal."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def bitwise(a, b):
    """True iff two trees have the same leaves bit for bit (floats by
    their bits: -0.0 and NaN payloads too)."""
    import torch

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


class Config5Watch:
    """While active, each step that parallel.mesh runs adds to device
    totals, read once on exit: its overflow bits, its max depth, and the
    cross-scene manifolds of its contacts (both bodies dynamic and in
    different scenes; scene i holds bodies [1 + i*k, 1 + (i+1)*k)). The
    totals are updated in place by the watched step, so they count in the
    chunk's captured graph as they would in the eager step; one watch
    serves a layout's windows (its step is the graph's cache key)."""

    def __init__(self, k, dev):
        import torch

        from nudge_tpu_torch import engine
        from nudge_tpu_torch.parallel import mesh

        self.k = k
        self.cross = self.over = self.depth = None
        self.totals = (torch.zeros((), dtype=torch.int64, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev),
                       torch.zeros((), dtype=torch.float32, device=dev))
        real_collide, real_step = engine.collide, mesh.step
        cross, over, depth = self.totals

        def collide(state, cfg, rebuild=None):
            man, bp = real_collide(state, cfg, rebuild=rebuild)
            a, b = man.body_a.long(), man.body_b.long()
            scene_a = torch.div(a - 1, self.k, rounding_mode="floor")
            scene_b = torch.div(b - 1, self.k, rounding_mode="floor")
            cross.add_(torch.sum(man.valid & (a > 0) & (b > 0)
                                 & (scene_a != scene_b)))
            return man, bp

        def step(state, cfg):
            state, m = real_step(state, cfg)
            over.bitwise_or_(m.overflow_bits)
            torch.maximum(depth, m.max_depth, out=depth)
            return state, m

        self.real = [(engine, "collide", real_collide),
                     (mesh, "step", real_step)]
        self.watched = [(engine, "collide", collide), (mesh, "step", step)]

    def __enter__(self):
        for t in self.totals:
            t.zero_()
        for mod, name, fn in self.watched:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)
        self.cross, self.over, self.depth = (
            int(self.totals[0]), int(self.totals[1]), float(self.totals[2]))
        return False


def cached_coloring(st, cfg, inputs):
    """(ms a call, the joins it ran) of the cached coloring at a step from
    `st`: CUDA events around the call (the claim rounds one kernel
    launch)."""
    from nudge_tpu_torch.ops import cache, solver

    bodies, man = inputs[0], inputs[1]
    ran = []
    real = {"_join": cache._join, "join_i32": cache.join_i32}

    def counted(name, what):
        def fn(*a, **k):
            ran.append(what)
            return real[name](*a, **k)
        return fn

    cache._join = counted("_join", "4-key")
    cache.join_i32 = counted("join_i32", "packed")
    try:
        solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    finally:
        cache._join, cache.join_i32 = real["_join"], real["join_i32"]
    ms = timed(lambda: solver.color_manifolds_cached(man, bodies, cfg,
                                                     st.colors), 3, 1)
    return ms, ran


def config5_layout(card, dev, spc, steps, keep=None):
    """4,096 scenes as chunks of `spc` scenes, `steps` steps through
    parallel.mesh.megabatch_simulate in windows of C5_WINDOW, each window
    held to no overflow, a finite state, max depth < 0.5, no cross-scene
    manifold, box-box, the cached coloring, setup and the solve launched
    once a chunk-step and the one-point and fresh coloring kernels not at
    all, the first and last
    chunks bitwise equal to the same chunks stepped alone, chunks 0 and 1
    apart. Then at chunk 0 of the last step: box-box, setup and the solve
    against their twins (compare_step), the cached coloring's time and
    joins, its claim rounds' kernel against its twin at the step's joined
    colors (compare_coloring_cached), and one chunk-step under the
    profiler. With `keep` (a dict),
    the stack before its first step and after its last go there with the
    config (phase 19 steps the same stack over a mesh). Returns (launches,
    kernel records)."""
    import torch

    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.parallel import mesh
    from nudge_tpu_torch.utils.debug import finite_state

    n_chunks = C5_SCENES // spc
    label = f"config 5 ({n_chunks} x {spc} x {C5_BODIES})"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proto = scenes.scene_pile_batch(spc, C5_BODIES, seed=C5_SEED)
    cfg = scenes.cover_footprint(proto, pile_config(proto, proto.num_bodies))
    batch, _ = scenes.scene_pile_megachunks(n_chunks, spc, C5_BODIES, cfg=cfg,
                                            seed=C5_SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if keep is not None:
        keep.update(start=clone_state(batch), cfg=cfg)
    stack_gb = sum(x.numel() * x.element_size() for x in leaves(batch)) / 1e9
    log(card, f"{label}: built in {build_s:.2f} s (two numpy scene "
        f"loops, one template upload, the stack on the card): "
        f"{proto.num_bodies} bodies, {cfg.max_box_box_pairs} pair slots, "
        f"{cfg.max_manifolds} manifold slots, grid {cfg.grid_table_dims} a "
        f"chunk; stack {stack_gb:.3f} GB")
    last = n_chunks - 1
    t_all, launches = 0.0, {}
    watch = Config5Watch(C5_BODIES, dev)
    for w0 in range(0, steps, C5_WINDOW):
        w1 = w0 + C5_WINDOW
        alone = {c: clone_state(mesh.take(batch, c)) for c in (0, last)}
        with KernelsOnly() as run, watch:
            t0 = time.perf_counter()
            batch, m = mesh.megabatch_simulate(cfg, C5_WINDOW)(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        t_all += dt
        for k, v in run.launches.items():
            launches[k] = launches.get(k, 0) + v
        want = n_chunks * C5_WINDOW
        if any(run.launches[k] != want for k in ("box_box", "coloring_cached",
                                                 "setup", "solve")) \
                or run.launches["pairs_1pt"] or run.launches["coloring"]:
            raise AssertionError(f"{label}: launches {run.launches} in steps "
                                 f"{w0}..{w1}, not {want} of box-box, the "
                                 "cached coloring, setup and the solve and "
                                 "none of the others")
        if watch.over:
            raise AssertionError(f"{label}: overflow in steps {w0}..{w1}: "
                                 f"bits {watch.over}")
        if not finite_state(batch):
            raise AssertionError(f"{label}: non-finite state after step {w1}")
        if watch.depth >= 0.5:
            raise AssertionError(f"{label}: max depth {watch.depth} >= 0.5 in "
                                 f"steps {w0}..{w1}")
        if watch.cross:
            raise AssertionError(f"{label}: {watch.cross} cross-scene "
                                 f"manifolds in steps {w0}..{w1}")
        for c, st in alone.items():
            st, _ = eager_simulate(st, cfg, C5_WINDOW)
            if not bitwise(mesh.take(batch, c), st):
                raise AssertionError(f"{label}: chunk {c} in the stack differs "
                                     f"from chunk {c} stepped alone (eager "
                                     f"engine.step) in steps {w0}..{w1}")
        if torch.equal(batch.bodies.pos[0], batch.bodies.pos[1]):
            raise AssertionError(f"{label}: chunks 0 and 1 are equal")
        log(card, f"{label} steps {w0}-{w1}: {C5_WINDOW / dt:.3f} steps/s "
            f"({dt * 1e3 / (C5_WINDOW * n_chunks):.2f} ms a chunk-step), "
            f"contacts {int(m.contact_count.sum())}, manifolds "
            f"{int(m.manifold_demand.sum())} (largest chunk "
            f"{int(m.manifold_demand.max())}), pairs "
            f"{int(m.pair_demand.sum())}, max depth {watch.depth:.4f}, KE "
            f"{float(m.kinetic_energy.sum()):.6g}, spill "
            f"{int(m.spill_count.max())}; 0 cross-scene manifolds; chunks 0 "
            f"and {last} bitwise equal to themselves stepped alone by the "
            f"eager engine.step")
    rate = steps / t_all
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(card, f"{label}: {steps} steps in {t_all:.2f} s: {rate:.4f} steps/s, "
        f"{rate * C5_SCENES * C5_BODIES:.1f} body-steps/s; peak memory "
        f"{peak_gb:.3f} GB; launches {launches}")
    if keep is not None:
        keep.update(end=batch, end_metrics=m)
    st0 = mesh.take(batch, 0)
    where = f"{label} chunk 0, step {steps}"
    records, inputs = compare_step(card, where, st0, cfg)
    col_ms, joins = cached_coloring(st0, cfg, inputs)
    log(card, f"{where}: cached coloring {col_ms:.3f} ms a call, joins "
        f"{joins}; solve device {records['solve']['device_ms']:.4f} ms")
    bodies, man = inputs[0], inputs[1]
    start = cached_start(man, bodies, cfg, st0.colors)
    for mc in (cfg.max_colors, SPILL_COLORS):
        rec = compare_coloring_cached(card, where, man, bodies.inv_mass > 0.0,
                                      start, mc)
        if mc == cfg.max_colors:
            records["coloring_cached"] = rec
    records["join"] = compare_join(card, where, st0, inputs, cfg)
    profile_steps(card, where, st0, cfg, steps=1)
    return launches, records


def phase_config5(card, dev, keep=None):
    """Config 5 at full width in both layouts (config5_layout), the
    kernels against their twins at each layout's chunk 0; the MESH_SPC
    layout's stack before and after into `keep`. Returns (launches by
    layout, kernel records by layout)."""
    launches, records = {}, {}
    for spc, steps in C5_LAYOUTS:
        path = f"config 5 ({C5_SCENES // spc} x {spc} x {C5_BODIES})"
        launches[path], records[path] = config5_layout(
            card, dev, spc, steps, keep if spc == MESH_SPC else None)
    return launches, records


def api_step(st, cfg):
    """One step composed from the seven nudge-parity calls
    (tests/test_checkpoint_api.py's pipeline): (bodies, cache)."""
    from nudge_tpu_torch import api
    from nudge_tpu_torch.ops.integrate import apply_position_correction

    bodies = api.apply_gravity(st.bodies, st.sleep, cfg)
    contacts, _ = api.collide(st, cfg)
    warm, pwarm = api.read_cached_impulses(st.cache, contacts)
    con, bodies, acc = api.setup_contact_constraints(bodies, contacts, warm,
                                                     cfg, pwarm=pwarm)
    bodies, acc, pseudo, pseudo_acc = api.apply_impulses(con, bodies, acc, cfg)
    cache = api.write_cached_impulses(
        contacts, api.update_cached_impulses(con, acc), pseudo_acc)
    bodies = api.advance(bodies, st.sleep, cfg)
    if cfg.split_impulse:
        bodies = apply_position_correction(bodies, pseudo, st.sleep, cfg)
    return bodies, cache


def env_push(obs):
    """tests/test_envs.py's push along the bearing, damped by the velocity
    so that no agent overshoots its goal (obs [..., 9])."""
    import torch

    d, v = obs[..., 6:9], obs[..., 3:6]
    return (1.5 * torch.stack([d[..., 0], d[..., 2]], -1)
            - torch.stack([v[..., 0], v[..., 2]], -1))


def eager_env(env, s, obs, steps):
    """One environment stepped `steps` env steps by env_push, each env
    step's physics steps by the eager engine.step."""
    for _ in range(steps):
        sim = env._push(s.sim, env_push(obs))
        sim, _ = eager_simulate(sim, env.cfg, env.frame_skip)
        s, obs, _, _, _ = env._finish(s, sim)
    return s


def phase_batch_api_envs(card, dev):
    """The stacked batch, the API and the environments on the card, the
    plain twins raising: scene_pile_stacked(8, 512) for STACKED_STEPS
    steps through batched_simulate (batched_step_chunked equal to
    batched_step, scene STACKED_PROBE equal to itself alone, bitwise); the
    API pipeline against engine.step on config 3 after API_SETTLE steps
    (fresh coloring, as the API colors: positions and velocities within
    1e-6, cache ids exact); N_ENVS BoxPushEnvs pushed toward their goals
    for ENV_STEPS vec_steps by a damped push, every reward up by ENV_GAIN.
    Box-box, setup and the solve against their twins (compare_step) at
    the stacked batch's scene STACKED_PROBE after its rollout and at env
    0's scene after the pushes, woken as its next step would be. Returns
    (launches by path, kernel records by path)."""
    import torch

    from nudge_tpu_torch import engine, envs, scenes
    from nudge_tpu_torch.parallel import mesh
    from nudge_tpu_torch.utils.debug import finite_state

    from nudge_tpu_torch import api

    launches, records = {}, {}
    batch, cfg = scenes.scene_pile_stacked(STACKED_SCENES, C5_BODIES,
                                           device=dev)
    label = f"stacked batch ({STACKED_SCENES} x {C5_BODIES})"
    with KernelsOnly() as run:
        t0 = time.perf_counter()
        rolled, m = mesh.batched_simulate(cfg, STACKED_STEPS)(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        one, m1 = mesh.batched_step(cfg)(batch)
        chunked, m2 = mesh.batched_step_chunked(cfg, n_chunks=2)(batch)
    want = STACKED_SCENES * (STACKED_STEPS + 2)
    if any(run.launches[k] != want for k in ("box_box", "setup", "solve")):
        raise AssertionError(f"{label}: launches {run.launches}, not {want}")
    if bool(m.overflow.any()) or not finite_state(rolled) \
            or float(m.max_depth.max()) >= 0.5:
        raise AssertionError(f"{label}: overflow, non-finite or too deep")
    if not (same_state(one, chunked)
            and torch.equal(m1.contact_count, m2.contact_count)):
        raise AssertionError(f"{label}: batched_step_chunked differs from "
                             "batched_step")
    alone, _ = eager_simulate(clone_state(mesh.take(batch, STACKED_PROBE)),
                              cfg, STACKED_STEPS)
    if not bitwise(mesh.take(rolled, STACKED_PROBE), alone):
        raise AssertionError(f"{label}: scene {STACKED_PROBE} differs from "
                             "itself stepped alone (eager engine.step)")
    launches[label] = run.launches
    log(card, f"{label}: {STACKED_STEPS} steps in {dt:.2f} s "
        f"({STACKED_STEPS / dt:.3f} steps/s), contacts "
        f"{m.contact_count[-1].tolist()}; batched_step_chunked(2) bitwise "
        f"equal to batched_step; scene {STACKED_PROBE} bitwise equal to "
        f"itself stepped alone by the eager engine.step; launches "
        f"{run.launches}")
    records[label], _ = compare_step(
        card, f"{label} scene {STACKED_PROBE}, step {STACKED_STEPS}",
        clone_state(mesh.take(rolled, STACKED_PROBE)), cfg)

    b, cfg = mixed_scene()
    cfg = cfg.replace(persistent_coloring=False)
    with KernelsOnly() as run:
        st, _ = engine.simulate(b.finalize(cfg, device=dev), cfg, API_SETTLE)
        ref, _ = engine.step(st, cfg)
    with KernelsOnly() as run:
        bodies, cache = api_step(st, cfg)
    # the fresh coloring's kernel, so none of the cached one's (and of the
    # cache's joins only the warm start's)
    if run.launches != {"box_box": 1, "pairs_1pt": 1, "coloring": 1,
                        "coloring_cached": 0, "join": 1, "setup": 1,
                        "solve": 1}:
        raise AssertionError(f"API step: launches {run.launches}, not one of "
                             "each kernel that the fresh-coloring step runs")
    err = max(float((bodies.pos - ref.bodies.pos).abs().max()),
              float((bodies.vel - ref.bodies.vel).abs().max()))
    if err > 1e-6 or not all(torch.equal(getattr(cache, f),
                                          getattr(ref.cache, f))
                             for f in ("ga", "gb", "feat", "valid")):
        raise AssertionError(f"API step: differs from engine.step (pos/vel "
                             f"{err:.3g})")
    launches["API step (config 3)"] = run.launches
    log(card, f"API step (config 3 after {API_SETTLE} steps, "
        f"{int(cache.valid.sum())} contacts): equal to engine.step within "
        f"{err:.3g} (positions, velocities), cache ids exact; one launch of "
        "each kernel")

    env = envs.BoxPushEnv(device=dev)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(N_ENVS)]
    with KernelsOnly() as run:
        t0 = time.perf_counter()
        states, obs = envs.vec_reset(env, gens)
        start = (clone_state(states), obs.clone())
        first = None
        for _ in range(ENV_STEPS):
            states, obs, rew, done, _ = envs.vec_step(env, states,
                                                      env_push(obs))
            first = rew if first is None else first
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    for i in (0, N_ENVS - 1):
        alone = eager_env(env, mesh.take(start[0], i), start[1][i], ENV_STEPS)
        if not bitwise(mesh.take(states, i), alone):
            raise AssertionError(f"environments: env {i} differs from itself "
                                 "stepped by the eager engine.step")
    need_launches("environments", run.launches, ("box_box", "setup", "solve"))
    gain = rew - first
    if float(gain.min()) <= ENV_GAIN or bool(done.any()) \
            or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"environments: reward gains {gain.tolist()} "
                             f"(each must pass {ENV_GAIN}), done "
                             f"{done.tolist()}")
    launches[f"environments ({N_ENVS})"] = run.launches
    log(card, f"environments: {N_ENVS} BoxPushEnvs x {ENV_STEPS} vec_steps "
        f"(frame_skip {env.frame_skip}) in {dt:.2f} s; reward from "
        f"{float(first.min()):.3f}..{float(first.max()):.3f} to "
        f"{float(rew.min()):.3f}..{float(rew.max()):.3f}, smallest gain "
        f"{float(gain.min()):.3f}; envs 0 and {N_ENVS - 1} bitwise equal to "
        f"themselves stepped by the eager engine.step; launches "
        f"{run.launches}")
    env0 = api.wake(clone_state(mesh.take(states.sim, 0)), env._agent)
    records[f"environments ({N_ENVS})"], _ = compare_step(
        card, f"environment 0, step {ENV_STEPS}", env0, env.cfg)
    return launches, records


# --- phase 18: the differentiable mode ----------------------------------
# Each backward kernel against autograd of its twin, on the same inputs and
# the same seeded random output adjoint: every gradient tensor within
# GRAD_RTOL of its own largest element. The backward kernels replay the
# forward's own float operations, so kernel and twin take every branch
# alike; what differs is the order of the float sums (a collider's or a
# body's adjoint summed over its up to ~30 pairs or manifolds, a row's
# adjoint over 20 sweeps, each term rounded to ~6e-8 of itself): measured
# ~1e-6 of the largest element on a host build of the kernels, so 1e-4
# leaves a factor of ~100 for the card's other sum orders.
GRAD_RTOL = 1e-4
GRAD_SEED = 18
DIFF_STEPS = 5             # W: differentiable steps of the 20,480 pile
BACKWARD_REPS = 3          # device_ms calls of a backward kernel
# The 4-body test of tests/test_autodiff.py: scene_pile(4, seed=0),
# max_colors 8, 12 sweeps, 12 steps, loss |pos[1] - (1, 0, 3)|^2; central
# differences at eps 1e-3 in 2 directions of RandomState(1) within 8%;
# 15 gradient-descent steps at lr 4 to below 0.3x the first loss.
AUTODIFF_STEPS = 12
AUTODIFF_TARGET = (1.0, 0.0, 3.0)
FD_EPS = 1e-3
FD_RTOL = 0.08
GD_LR = 4.0
GD_ITERS = 15
GD_SHARE = 0.3
# The card's 4-body gradient against the CPU port's: the two run the same
# float operations except setup (within 1e-6 of its twin on the card) and
# the color sweeps (the card skips the unused ones, exact no-ops), over 12
# steps of contact. Measured on an H100: 1.49e-8 apart at max |g| 1.386
# (1.1e-8 of it, PERF.md); the gate is 5e-8 of the largest element.
CPU_GRAD_RTOL = 5e-8
# The solve's backward is held to autograd of its float64 twin (from the
# same float32 inputs): autograd of the float32 twin through 20 sweeps
# loses ~1e-3 of the gradient's norm to cancellation (the twin's scatter
# new = old + (new - old) passes +g and -g to old, and the sums grow to
# ~1e3 times the output adjoint: 4.30 off at max |g| 1,656 at 4 colors),
# while the kernel's reverse visit takes the write's exact derivative.
# Field by field, against the field's largest element (this phase's
# per-field log line, H100, the pile's step 40; PERF.md): at 6
# colors the kernel is within 8.4e-7 everywhere; at 4 colors (the spill
# color) within 8.3e-6 except at a few manifolds where the kernel agrees
# with autograd of the float32 twin to ~4e-9 and both part from the
# float64 twin (pos_bias up to 1.1e-4): there the float32 forward itself
# parts from the float64 one, not the backward. So every element must be
# within SOLVE64_RTOL (6 colors) or SPILL64_RTOL (4 colors) of the field's
# largest element from the float64 twin, except, at 4 colors, a corner:
# an element farther than SOLVE64_RTOL from the float64 twin but within
# SOLVE64_RTOL of the float32 twin. Corners are counted and logged.
SOLVE64_RTOL = 4e-6
SPILL64_RTOL = 4e-5
# One step of the pile through the kernels against one through the twins
# with the solve in float64 (the rest of the twins in float32), both on
# the card: the gradients with respect to the initial velocities and
# positions. The two forwards can part where a box-box pair meets a
# near-tie (phase 3 allows TIE_SHARE of the live pairs) and do in setup's
# last bits, so the gate is on the norm: measured on an H100 2.63e-7
# (d/dv) and 9.74e-8 (d/dx) relative L2 (PERF.md); the gate is 1e-6.
W1_RTOL = 1e-6
# The examples' gates, from their JAX originals run once on a CPU
# (PERF.md): diff_throw reaches its 1e-3 stop at iteration 14 of 30 (final
# loss 3e-5 from 4.95); policy_grad's mean return rises from -53.5 at the
# first update to -29.7 at the 20th, 18.3 above the untrained policy's
# ~-48 (HORIZON x 4). The port must stop below THROW_LOSS, and end with a
# mean return more than POLICY_GAIN above both the untrained policy's and
# its own first update's. Both run deterministically from fixed seeds.
THROW_LOSS = 1e-3
POLICY_GAIN = 10.0


def grad_check(name, k, t, diff, rtol=GRAD_RTOL):
    """Raise unless the kernel's gradient `k` is finite and within rtol of
    the twin's `t` at its largest element; keep the largest error in
    `diff` (a dict of err, share)."""
    import torch

    if k.numel() == 0:
        return
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{name}: non-finite gradient from the kernel")
    err = float((k - t).abs().max())
    big = float(t.abs().max())
    if not err <= rtol * big:
        raise AssertionError(f"{name}: max |kernel - twin| {err:.3g} against "
                             f"max |twin| {big:.3g} (tolerance {rtol:g} of "
                             "it)")
    diff["err"] = max(diff["err"], err)
    diff["share"] = max(diff["share"], err / (rtol * big) if big else 0.0)


def grad_check64(name, k, q, rtol, diff, t=None):
    """Raise unless every element of the kernel's gradient `k` is finite
    and within rtol of the field's largest element from the float64
    twin's `q`, or is a corner: given the float32 twin's `t`, an element
    farther than SOLVE64_RTOL from `q` but within it of `t` (both float32
    runs agree, the float64 one parts). Keep in `diff` the largest error,
    the largest share of the tolerance off the corners and where, the
    corners' count and largest error, and each field's readings (the
    kernel's and the float32 twin's largest distance to `q` over the
    field's largest element)."""
    import torch

    if k.numel() == 0:
        return
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{name}: non-finite gradient from the kernel")
    big = float(q.abs().max())
    e = (k.double() - q).abs()
    corner = torch.zeros_like(e, dtype=torch.bool)
    if t is not None:
        corner = (e > SOLVE64_RTOL * big) & (
            (k - t).abs() <= SOLVE64_RTOL * big)
    bad = (e > rtol * big) & ~corner
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements of the kernel's gradient "
            f"farther than {rtol:g} x {big:.4g} from the float64 twin's (max "
            f"{float(e[bad].max()):.3g})")
    err = float(e[~corner].max()) if bool((~corner).any()) else 0.0
    diff["err"] = max(diff["err"], float(e.max()))
    diff["corners"] = diff.get("corners", 0) + int(corner.sum())
    if bool(corner.any()):
        diff["corner_err"] = max(diff.get("corner_err", 0.0),
                                 float(e[corner].max()))
    scale = big if big else 1.0
    reading = f"{name.split(' d')[-1]} {float(e.max()) / scale:.3g}"
    if t is not None:
        reading += f"/{float((t.double() - q).abs().max()) / scale:.3g}"
    diff.setdefault("fields", []).append(reading)
    share = err / (rtol * big) if big else 0.0
    if share >= diff["share"]:
        diff["share"], diff["worst"] = share, name


def fmt_diff(diff):
    return (f"max abs err {diff['err']:.3g} ({100 * diff['share']:.1f}% of "
            f"{GRAD_RTOL:g} x the largest element)")


def bitwise_again(name, first, again):
    import torch

    for x, y in zip(first, again):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: two backward runs from one input "
                                 "differ")


def backward_record(ms, plain_ms, dev_ms, diff, n_bytes, n_ops):
    return dict(max_abs_err=diff["err"], ms=ms, plain_ms=plain_ms,
                device_ms=dev_ms, **bound(n_bytes, n_ops))


def compare_np_backward(card, label, st, cfg, kernel):
    """narrowphase_all's backward (`contacts.narrowphase_backward_cuda`:
    the box-box and one-point backward kernels, then the per-collider
    segment sum) against autograd of the joined twins, on the step's
    candidate pairs from `st`, with a seeded output adjoint on every live
    pair whose integer outputs the kernel and the twin agree on (a
    near-tie's swapped points have another gradient). Twice bitwise.
    `kernel` ("box_box" or "pairs_1pt") names the record, whose device
    time is that backward kernel's alone. Returns the record."""
    import torch

    from nudge_tpu_torch.ops import broadphase, contacts, grid, segment
    from nudge_tpu_torch.ops import narrowphase_1pt as p1pt
    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.utils import timing

    dev = st.bodies.pos.device
    wc = broadphase.world_colliders(st)
    bb, bs, ss = grid.grid_broadphase(st, wc, cfg)
    k = contacts.narrowphase_all(st, wc, bb, bs, ss, cfg)
    p = contacts.narrowphase_joined_plain(st, wc, bb, bs, ss)
    live = torch.cat([bb.valid, bs.valid, ss.valid])
    same = live.clone()
    for key in ("point_valid", "feat"):
        same &= (k[key] == p[key]).all(1)
    for key in ("body_a", "body_b"):
        same &= k[key] == p[key]
    n, n_bb = live.shape[0], bb.a.shape[0]
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED)
    w = same.to(torch.float32)
    grads = {key: torch.randn(shape, generator=gen, device=dev) * w.reshape(
        (n,) + (1,) * len(shape[1:])) for key, shape in
        (("pos", (n, 4, 3)), ("depth", (n, 4)), ("normal", (n, 3)))}
    args = (st, wc, bb, bs, ss, grads)
    kg = contacts.narrowphase_backward_cuda(*args)
    bitwise_again(f"{label} backward", kg,
                  contacts.narrowphase_backward_cuda(*args))
    tg = contacts.narrowphase_backward_plain(*args)
    torch.cuda.synchronize()
    diff = {"err": 0.0, "share": 0.0}
    for name, x, y in zip(("box_pos", "box_quat", "sph_pos"), kg, tg):
        grad_check(f"{label} d{name}", x, y, diff)
    ms = timed(lambda: contacts.narrowphase_backward_cuda(*args))
    plain_ms = timed(lambda: contacts.narrowphase_backward_plain(*args), 1, 1)
    n_live_bb = int(bb.valid.sum())
    n_live_1 = int(live[n_bb:].sum())
    # the bound counts the gradient's work: per slot its valid flag in; per
    # live pair two indices, its output adjoints (76 B box-box: four points'
    # pos and depth and the normal; 28 B one-point: point 0's and the
    # normal) in and 56 B of pose adjoints out; BWD_OPS_FACTOR times the
    # forward's operations
    if kernel == "box_box":
        def call():
            return npk.box_box_adjoint_cuda(
                st.boxes, wc, bb, grads["pos"][:n_bb], grads["depth"][:n_bb],
                grads["normal"][:n_bb])
        n_edge = int((bb.valid & (p["feat"][:n_bb, 0] >= 1024)).sum())
        n_bytes = (sum(t.numel() * t.element_size() for t in wc)
                   + n_bb + n_live_bb * (8 + 76 + 56))
        n_ops = BWD_OPS_FACTOR * ((n_live_bb - n_edge) * BOXBOX_OPS_FACE
                                  + n_edge * BOXBOX_OPS_EDGE)
        n_item = (f"{n_bb} pair slots, {n_live_bb} live ({n_edge} in the "
                  "edge case)")
    else:
        def call():
            return p1pt.pairs_1pt_adjoint_cuda(
                st.boxes, st.spheres, wc, bs, ss, grads["pos"][n_bb:],
                grads["depth"][n_bb:], grads["normal"][n_bb:])
        n_1 = n - n_bb
        n_bytes = (sum(t.numel() * t.element_size() for t in wc)
                   + n_1 + n_live_1 * (8 + 28 + 56))
        n_ops = BWD_OPS_FACTOR * n_live_1 * PAIRS_1PT_OPS_PER_PAIR
        n_item = f"{n_1} one-point slots, {n_live_1} live"
    one_kernel(f"{kernel}_bwd", timing.device_ops(call))
    dev_ms = timing.device_ms(call, BACKWARD_REPS)
    # the call's other parts: the collider sort and the segment sum
    nb = st.boxes.half.shape[0]
    keys, perm = contacts.collider_entries(bb, bs, ss, nb)
    rows = torch.zeros((2 * n, 7), device=dev)
    sort_ms = timing.device_ms(
        lambda: contacts.collider_entries(bb, bs, ss, nb), BACKWARD_REPS)
    sum_ms = timing.device_ms(
        lambda: segment.segment_sum(keys, perm, rows,
                                    nb + st.spheres.radius.shape[0]),
        BACKWARD_REPS)
    call_ops = timing.device_ops(
        lambda: contacts.narrowphase_backward_cuda(*args))
    call_ms = timing.device_ms(
        lambda: contacts.narrowphase_backward_cuda(*args), BACKWARD_REPS)
    rec = backward_record(ms, plain_ms, dev_ms, diff, n_bytes, n_ops)
    rec.update(compare_np_shapes(card, label, args, gen, w, kg, kernel,
                                 call_ms, dev_ms))
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["shape_max_abs_err"])
    log(card, f"{kernel}_bwd ({label}): {n_item}, {int(same.sum())} of "
        f"{int(live.sum())} live rows with the twin's integers; {fmt_diff(diff)}; "
        f"two runs bitwise; one kernel a call; device: the call {call_ms:.4f} "
        f"ms ({fmt_ops(call_ops)}) = the kernel {dev_ms:.4f} + the collider "
        f"sort (segment.entries) {sort_ms:.4f} + the segment sum "
        f"{sum_ms:.4f} + the rest; wrapper {ms:.4f} ms, twin autograd "
        f"{plain_ms:.3f} ms; bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return rec


def compare_np_shapes(card, label, args, gen, w, kg, kernel, call_ms,
                      kernel_ms):
    """The narrowphase backward kernels' shape instances: the colliders'
    half extents', radii's and frictions' adjoints (`shapes=True`, with a
    seeded adjoint of the slots' friction too) against autograd of the
    joined twins, twice bitwise, the pose columns bitwise those of the
    pose-only call `kg`; the shape instance's call and kernel times beside
    the pose-only ones. Returns the record's extra keys."""
    import torch

    from nudge_tpu_torch.ops import contacts
    from nudge_tpu_torch.ops import narrowphase_1pt as p1pt
    from nudge_tpu_torch.ops import narrowphase_kernel as npk
    from nudge_tpu_torch.utils import timing

    st, wc, bb, bs, ss, grads = args
    n, n_bb = w.shape[0], bb.a.shape[0]
    dev = w.device
    sgrads = dict(grads, friction=torch.randn(n, generator=gen, device=dev)
                  * w)
    sargs = (st, wc, bb, bs, ss, sgrads)
    ks = contacts.narrowphase_backward_cuda(*sargs, shapes=True)
    bitwise_again(f"{label} shape backward", ks,
                  contacts.narrowphase_backward_cuda(*sargs, shapes=True))
    for name, x, y in zip(("box_pos", "box_quat", "sph_pos"), ks, kg):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: the shape instance's d{name} is "
                                 "not the pose-only call's, bit for bit")
    ts = contacts.narrowphase_backward_plain(*sargs, shapes=True)
    torch.cuda.synchronize()
    diff = {"err": 0.0, "share": 0.0}
    for name, x, y in zip(contacts.SHAPE_LEAVES, ks[3:], ts[3:]):
        grad_check(f"{label} d{name}", x, y, diff)
    shp = torch.empty((n, npk.SHAPE_INPUTS), device=dev)
    if kernel == "box_box":
        def call():
            return npk.box_box_adjoint_cuda(
                st.boxes, wc, bb, grads["pos"][:n_bb], grads["depth"][:n_bb],
                grads["normal"][:n_bb], g_friction=sgrads["friction"][:n_bb],
                out_shape=shp[:n_bb])
    else:
        def call():
            return p1pt.pairs_1pt_adjoint_cuda(
                st.boxes, st.spheres, wc, bs, ss, grads["pos"][n_bb:],
                grads["depth"][n_bb:], grads["normal"][n_bb:],
                g_friction=sgrads["friction"][n_bb:], out_shape=shp[n_bb:])
    one_kernel(f"{kernel}_bwd (shape)", timing.device_ops(call))
    shape_kernel_ms = timing.device_ms(call, BACKWARD_REPS)
    shape_call_ms = timing.device_ms(
        lambda: contacts.narrowphase_backward_cuda(*sargs, shapes=True),
        BACKWARD_REPS)
    log(card, f"{kernel}_bwd ({label}) shape instance: half extents, radii "
        f"and frictions {fmt_diff(diff)}; two runs bitwise; pose columns "
        f"bitwise the pose-only call's; device: the kernel {shape_kernel_ms:.4f} ms "
        f"(pose-only {kernel_ms:.4f}), the call {shape_call_ms:.4f} ms "
        f"(pose-only {call_ms:.4f})")
    return dict(shape_max_abs_err=diff["err"],
                shape_device_ms=shape_kernel_ms, shape_call_ms=shape_call_ms)


def compare_setup_backward(card, label, inputs, cfg):
    """setup's backward (`setup_backward_cuda`: the backward kernel, then
    the per-body segment sum) against autograd of `setup_plain` and
    `pack_constraints` on the step's inputs, with seeded adjoints of every
    float row of the live slots, their accumulators, frames and velw.
    Twice bitwise. Returns the record."""
    import torch

    from nudge_tpu_torch.ops import setup_kernel, solver_kernel
    from nudge_tpu_torch.utils import timing

    bodies, man, warm, pwarm, col, order = inputs
    dev = bodies.pos.device
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    live = torch.arange(m, device=dev) < order.offsets[cfg.max_colors]
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED)
    d_rows = torch.randn((solver_kernel.ROWS, m), generator=gen,
                         device=dev) * live
    off = solver_kernel.ROW_OFFSET
    d_rows[off["relax"]:] = 0.0       # relax, point_valid, body ids
    d_work = torch.randn((solver_kernel.WORK_ROWS, m), generator=gen,
                         device=dev) * live
    d_work[16:] = 0.0                 # scratch: overwritten by the solve
    d_frame = torch.randn((2, m, 3), generator=gen, device=dev) \
        * man.valid[None, :, None]
    d_velw = torch.randn((n, solver_kernel.VEL_ROW), generator=gen,
                         device=dev)
    use = setup_kernel.uses_pwarm(pwarm, cfg)
    args = (bodies, man, warm, pwarm, col[2], order, cfg, use, d_rows,
            d_work, d_frame, d_velw)
    kg = setup_kernel.setup_backward_cuda(*args)
    bitwise_again("setup_bwd", kg, setup_kernel.setup_backward_cuda(*args))
    pargs = (bodies, man, warm, cfg, col, pwarm, order, d_rows, d_work,
             d_frame, d_velw)
    tg = setup_kernel.setup_backward_plain(*pargs)
    torch.cuda.synchronize()
    diff = {"err": 0.0, "share": 0.0}
    for name, x, y in zip(setup_kernel.GRAD_INPUTS, kg, tg):
        grad_check(f"setup_bwd d{name}", x, y, diff)
    ms = timed(lambda: setup_kernel.setup_backward_cuda(*args))
    plain_ms = timed(lambda: setup_kernel.setup_backward_plain(*pargs), 1, 1)
    call = lambda: setup_kernel.setup_backward_cuda(*args)  # noqa: E731
    ops = timing.device_ops(call)
    dev_ms = timing.device_ms(call, BACKWARD_REPS)
    # the backward kernel alone (the wrapper adds the static keys' sort and
    # the per-body sums)
    ins, consts = setup_kernel._setup_args(bodies, man, warm, pwarm, col[2],
                                           order, cfg)

    def kernel():
        return setup_kernel._setup_bwd_launch(ins, consts, cfg, use, d_rows,
                                              d_work, d_frame, d_velw)

    one_kernel("setup_bwd", timing.device_ops(kernel))
    kernel_ms = timing.device_ms(kernel, BACKWARD_REPS)
    n_live = int(man.valid.sum())
    # per live manifold the forward's inputs (156 B), the adjoints of its
    # rows, accumulators and frame (~630 B) in, 61 adjoints out; per body
    # velw's adjoint in and 13 adjoints out; BWD_OPS_FACTOR times the
    # forward's ~2,200 operations a manifold
    rec = backward_record(ms, plain_ms, dev_ms, diff,
                          n_live * (156 + 630 + 61 * 4) + n * (48 + 52),
                          n_live * BWD_OPS_FACTOR * SETUP_OPS_PER_MANIFOLD)
    rec["kernel_device_ms"] = kernel_ms
    # the mass instance: inv_mass', inv_inertia's and friction's adjoints
    # too, the others bitwise the instance without
    km = setup_kernel.setup_backward_cuda(*args, mass=True)
    bitwise_again("setup_bwd mass", km,
                  setup_kernel.setup_backward_cuda(*args, mass=True))
    for name, x, y in zip(setup_kernel.GRAD_INPUTS, km, kg):
        if not torch.equal(x, y):
            raise AssertionError(f"setup_bwd: the mass instance's d{name} is "
                                 "not the instance without's, bit for bit")
    mdiff = {"err": 0.0, "share": 0.0}
    for name, x, y in zip(setup_kernel.MASS_INPUTS, km[len(kg):],
                          tg[len(kg):]):
        grad_check(f"setup_bwd d{name}", x, y, mdiff)
    static = bodies.inv_mass == 0.0
    if not float(km[-3][static].abs().max()) > 0.0:
        raise AssertionError("setup_bwd: no static body's inverse mass "
                             "takes a gradient")

    def mass_kernel():
        return setup_kernel._setup_bwd_launch(ins, consts, cfg, use, d_rows,
                                              d_work, d_frame, d_velw, True)

    one_kernel("setup_bwd (mass)", timing.device_ops(mass_kernel))
    rec["mass_device_ms"] = timing.device_ms(mass_kernel, BACKWARD_REPS)
    rec["mass_call_ms"] = timing.device_ms(
        lambda: setup_kernel.setup_backward_cuda(*args, mass=True),
        BACKWARD_REPS)
    rec["mass_max_abs_err"] = mdiff["err"]
    rec["max_abs_err"] = max(rec["max_abs_err"], mdiff["err"])
    log(card, f"setup_bwd ({label}) mass instance: inv_mass, inv_inertia "
        f"and friction {fmt_diff(mdiff)}; the other adjoints bitwise the "
        f"instance without's; a static body's inverse mass takes one; the "
        f"kernel alone {rec['mass_device_ms']:.4f} ms (without "
        f"{kernel_ms:.4f}), the call {rec['mass_call_ms']:.4f} ms (without "
        f"{dev_ms:.4f})")
    log(card, f"setup_bwd ({label}): {n_live} live manifolds; "
        f"{fmt_diff(diff)}; two runs bitwise; a call enqueues "
        f"{fmt_ops(ops)}; wrapper {ms:.4f} ms (device {dev_ms:.4f} ms; the "
        f"kernel alone {kernel_ms:.4f} ms, one kernel), twin autograd "
        f"{plain_ms:.3f} ms; bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return rec


class Deterministic:
    """While active, torch's deterministic algorithms: the twins' index_add
    sums in a fixed order on the card, so a twin's result (setup's warm
    start, the solve's spill color) is the same on every run."""

    def __enter__(self):
        import torch

        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        import torch

        torch.use_deterministic_algorithms(self.was)
        return False


def compare_solve_backward(card, label, inputs, cfg, spill=False,
                           mass=False, ref=None):
    """The solve's backward (`solve_backward_cuda`: the reverse-sweep
    kernel, then the static bodies' segment sum) against autograd of
    `solve_plain` in float64, from the twin's setup: the kernel side
    differentiates `pack_constraints` (plain) into `SolveFn`, so both
    return the adjoints of the twin's velw, constraint fields and
    accumulators, from one seeded adjoint of the output velw and
    accumulators. A static side's j rows and the inverse masses' and relax
    rows are left out: their adjoints end at inverse masses and inertias
    (no gradient), and the kernel gives them none. Each field within
    SOLVE64_RTOL of its largest element; with `spill` (few colors: the
    spill color's Jacobi adjoint) within SPILL64_RTOL, and autograd of the
    float32 twin also runs, to tell the corners (grad_check64). With
    `mass` the kernel's mass instance, every row's adjoint held to the
    float64 twin, the inverse masses' and a static side's j rows too.
    `ref`, a dict: the float64 twin's adjoints are kept there, or taken
    from there when a call on the same inputs kept them. Twice bitwise.
    Returns the record, its error against the float64 twin."""
    import dataclasses

    import torch

    from nudge_tpu_torch.ops import setup_kernel, solver_kernel
    from nudge_tpu_torch.utils import timing

    bodies, man, warm, pwarm, col, order = inputs
    dev = bodies.pos.device
    with Deterministic():
        tcon, tvelw, tacc = setup_kernel.setup_plain(bodies, man, warm, cfg,
                                                     col, pwarm)
    m, n = man.valid.shape[0], bodies.pos.shape[0]
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED)
    g_v = torch.randn((n, solver_kernel.VEL_ROW), generator=gen, device=dev)
    g_o = torch.randn((4, m, 4), generator=gen, device=dev) \
        * man.valid[None, :, None]
    fields = [f for f, _ in solver_kernel.ROW_FIELDS
              if f not in ("body_a", "body_b", "point_valid")]
    with Deterministic():
        if ref:
            qv, qf, qa, plain_ms = ref["q"]
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the float64 twin from the same (float32) inputs: the reference
            qv, qf, qa = solver_kernel.solve_backward_plain(
                tvelw.double(), tcon.replace(**{f: getattr(tcon, f).double()
                                                for f in fields}),
                tuple(x.double() for x in tacc), cfg, g_v.double(),
                g_o.double())
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)  # one call: seconds
            if ref is not None:
                ref["q"] = (qv, qf, qa, plain_ms)
        tv, tf, ta = None, {f: None for f in fields}, (None,) * 3
        if spill:
            tv, tf, ta = solver_kernel.solve_backward_plain(
                tvelw, tcon, tacc, cfg, g_v, g_o)

    def kernel_grads():
        leaves = {f: getattr(tcon, f).detach().requires_grad_()
                  for f in fields}
        v = tvelw.detach().requires_grad_()
        a = [x.detach().requires_grad_() for x in tacc]
        packed, work = setup_kernel.pack_constraints(
            tcon.replace(**leaves), tuple(a), order)
        packed = dataclasses.replace(packed, mass_grad=mass)
        vo, ao, po = solver_kernel.solve_cuda(v, packed, work, cfg)
        got = torch.autograd.grad([vo, *ao, po], [v, *leaves.values(), *a],
                                  [g_v, *g_o], allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(got, [v, *leaves.values(), *a])]

    kg = kernel_grads()
    bitwise_again(f"solve_bwd ({label})", kg, kernel_grads())
    torch.cuda.synchronize()
    rtol = SPILL64_RTOL if spill else SOLVE64_RTOL
    diff = {"err": 0.0, "share": 0.0}
    grad_check64("solve_bwd dvelw", kg[0], qv, rtol, diff, tv)
    dyn = {"a": tcon.im_a > 0.0, "b": tcon.im_b > 0.0}
    for i, f in enumerate(fields):
        if f == "relax" or (f in ("im_a", "im_b") and not mass):
            continue
        x, y, z = kg[1 + i], tf[f], qf[f]
        if f.startswith("j") and not mass:
            keep = dyn[f[-1]]
            x, z = x[keep], z[keep]
            y = None if y is None else y[keep]
        grad_check64(f"solve_bwd d{f}", x, z, rtol, diff, y)
    for i in range(3):
        grad_check64(f"solve_bwd dacc{i}", kg[-3 + i], qa[i], rtol, diff,
                     ta[i])
    # the backward alone, from a tape of the same forward
    packed, work = setup_kernel.pack_constraints(tcon, tacc, order)
    tape = torch.empty((cfg.solver_iters, solver_kernel.TAPE_ROWS, m),
                       dtype=torch.float32, device=dev)
    solver_kernel._solve_launch(tvelw.clone(), packed, work.clone(), cfg,
                                tape)

    def call():
        return solver_kernel.solve_backward_cuda(packed.rows, tape, packed,
                                                 cfg, g_v, g_o, mass)

    ms = timed(call)
    ops = timing.device_ops(call)
    dev_ms = timing.device_ms(call, BACKWARD_REPS)
    # the reverse-sweep kernel alone, on buffers made once (the wrapper
    # adds their fills and the static reads' segment sum)
    f32 = torch.float32
    bufs = (g_v.clone(),
            torch.zeros((4 * 4, m), dtype=f32, device=dev),
            torch.zeros((solver_kernel.ROWS, m), dtype=f32, device=dev),
            torch.zeros((2 * solver_kernel.VEL_ROW, m), dtype=f32, device=dev),
            torch.empty((4 * solver_kernel.VEL_ROW, m), dtype=f32, device=dev))
    optrs = solver_kernel._order_args("solve_bwd", packed, cfg)
    statics = (solver_kernel.static_entries(packed.rows, order.offsets, n,
                                            cfg) if mass else None)

    def kernel():
        return solver_kernel._solve_bwd_launch(packed.rows, tape, optrs, cfg,
                                               *bufs, statics)

    one_kernel("solve_bwd", timing.device_ops(kernel))
    kernel_ms = timing.device_ms(kernel, BACKWARD_REPS)
    n_live = int(man.valid.sum())
    corners = ""
    if spill:
        corners = (f"; {diff['corners']} corners (the kernel within "
                   f"{SOLVE64_RTOL:g} of the float32 twin, max err "
                   f"{diff.get('corner_err', 0.0):.3g} from the float64 twin)")
    log(card, f"solve_bwd ({label}) by field, the largest distance to the "
        f"float64 twin over the field's largest element, the kernel's"
        + ("/the float32 twin's" if spill else "") + ": "
        + ", ".join(diff["fields"]))
    log(card, f"solve_bwd ({label}): {cfg.solver_iters} sweeps x "
        f"{int(col[1])} colors ({int(col[3])} spilled) in reverse in one "
        f"launch of a {solver_kernel.solve_bwd_cluster_size()}-CTA cluster; "
        f"against the float64 twin max abs err {diff['err']:.3g} (max |g| "
        f"{float(qv.abs().max()):.4g}), off the corners "
        f"{100 * diff['share']:.1f}% of {rtol:g} x each field's largest "
        f"element at most, at {diff['worst']}{corners}; two runs bitwise; a "
        f"call enqueues {fmt_ops(ops)}; wrapper {ms:.3f} ms (device "
        f"{dev_ms:.4f} ms; the kernel alone {kernel_ms:.4f} ms, one kernel), "
        f"float64 twin autograd {plain_ms:.1f} ms")
    # per live manifold and sweep its tape row (160 B) in; per live
    # manifold the rows (556 B) and the accumulators' adjoint (64 B) in,
    # the rows' and accumulators' adjoints (556 + 64 B) out; per body
    # velw's adjoint in and out; BWD_OPS_FACTOR times the forward's ~750
    # operations a visit
    rec = backward_record(
        ms, plain_ms, dev_ms, diff,
        n_live * (cfg.solver_iters * 160 + 2 * (556 + 64)) + n * 2 * 48,
        n_live * cfg.solver_iters * BWD_OPS_FACTOR * SOLVE_OPS_PER_MANIFOLD)
    rec["kernel_device_ms"] = kernel_ms
    return rec


def solve_plain64(velw, con, acc, cfg):
    """solve_plain run in float64 on float32 inputs, its outputs rounded
    back to float32 (autograd passes through both casts)."""
    from nudge_tpu_torch.ops import solver_kernel

    c = con.replace(**{f: getattr(con, f).double()
                       for f, _ in solver_kernel.ROW_FIELDS
                       if getattr(con, f).is_floating_point()})
    v, a, p = solver_kernel.solve_plain(velw.double(), c,
                                        tuple(x.double() for x in acc), cfg)
    return v.float(), tuple(x.float() for x in a), p.float()


class TwinsOnly:
    """While active, every kernel wrapper's CUDA branch runs its plain twin
    (tests/test_torch_kernels.py `_through_twins`), the solve's in float64
    with `solve64`, and the narrowphase is the joined twins in place of
    NarrowphaseFn: a differentiable step on the card is autograd through
    the twins."""

    def __init__(self, solve64=False):
        self.solve64 = solve64

    def __enter__(self):
        from nudge_tpu_torch.ops import coloring_kernel as ck
        from nudge_tpu_torch.ops import contacts, setup_kernel, solver_kernel
        from nudge_tpu_torch.ops import narrowphase_kernel as npk

        self.saved = []
        for mod, name, fn in (
                (npk, "box_box_slots_cuda", npk.box_box_slots_plain),
                (contacts, "narrowphase_cuda",
                 contacts.narrowphase_joined_plain),
                (ck, "color_rounds_cuda", ck.color_rounds_plain),
                (solver_kernel, "solve_cuda", solve_plain64 if self.solve64
                 else solver_kernel.solve_plain),
                (setup_kernel, "setup_cuda",
                 lambda *a: setup_kernel.setup_plain(*a[:6]))):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def rollout_grad(st0, cfg, steps, loss_fn, repeat=True):
    """(loss, d loss / d initial vel, d loss / d initial pos, final state,
    seconds forward, seconds backward) of `steps` engine steps from `st0`;
    with `repeat` the backward runs twice from the one graph and must give
    the same bits."""
    import torch

    from nudge_tpu_torch import engine

    vel = st0.bodies.vel.detach().clone().requires_grad_()
    pos = st0.bodies.pos.detach().clone().requires_grad_()
    st = st0.replace(bodies=st0.bodies.replace(vel=vel, pos=pos))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st, _ = engine.step(st, cfg)
    loss = loss_fn(st)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gv, gp = torch.autograd.grad(loss, [vel, pos], retain_graph=repeat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if repeat:
        again = torch.autograd.grad(loss, [vel, pos])
        bitwise_again("a rollout's backward", (gv, gp), again)
    return loss.detach(), gv, gp, st, t1 - t0, t2 - t1


def dynamic_height(st):
    import torch

    b = st.bodies
    return torch.sum(torch.where(b.inv_mass > 0.0, b.pos[:, 1], 0.0))


def phase_grad_pile(card, pile_state):
    """Phase 18 at full width: DIFF_STEPS differentiable steps of the
    20,480 pile from phase 3's state through the kernels (the twins
    raising), loss the summed height of the dynamic bodies, backward to
    the initial velocities and positions through the backward kernels,
    twice bitwise; the state bitwise equal to DIFF_STEPS steps of the
    normal mode; one step's gradient against the twins' on the card.
    Returns the launches."""
    import torch

    from nudge_tpu_torch import engine, scenes
    from nudge_tpu_torch.ops import contacts, solver_kernel

    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    dcfg = cfg.replace(differentiable=True)
    plain, _ = engine.simulate(clone_state(pile_state), cfg, DIFF_STEPS)
    st0 = clone_state(pile_state)
    man0, _ = contacts.collide(st0, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with KernelsOnly(backward=True) as run:
        loss, gv, gp, st, t_fwd, t_bwd = rollout_grad(st0, dcfg, DIFF_STEPS,
                                                      dynamic_height)
    peak = torch.cuda.max_memory_allocated()
    need_launches("pile gradient", run.launches,
                  ("box_box", "setup", "solve", "box_box_bwd", "setup_bwd",
                   "solve_bwd"))
    if not same_state(plain, st):
        raise AssertionError("the differentiable mode's forward differs from "
                             "the normal mode's")
    if not (bool(torch.isfinite(gv).all()) and bool(torch.isfinite(gp).all())):
        raise AssertionError("pile gradient: not finite")
    dyn = pile_state.bodies.inv_mass > 0.0
    touched = torch.zeros_like(dyn)
    for side in (man0.body_a, man0.body_b):
        touched[side[man0.valid].long()] = True
    touched &= dyn
    zero = touched & (gv.abs().sum(1) == 0.0)
    if int(touched.sum()) == 0 or bool(zero.any()):
        raise AssertionError(f"pile gradient: {int(zero.sum())} of "
                             f"{int(touched.sum())} bodies in contact have a "
                             "zero velocity gradient")
    tape_mb = (DIFF_STEPS * cfg.solver_iters * solver_kernel.TAPE_ROWS
               * cfg.max_manifolds * 4 / 1e6)
    log(card, f"pile gradient: {DIFF_STEPS} differentiable steps of the "
        f"{N_PILE}-box pile from step {COMPARE_AFTER}, loss (summed height) "
        f"{float(loss):.6g}; forward {1e3 * t_fwd / DIFF_STEPS:.2f} ms a "
        f"step, backward {1e3 * t_bwd / DIFF_STEPS:.2f} ms a step; tapes "
        f"{tape_mb:.1f} MB; peak memory {peak / 1e9:.3f} GB "
        f"({(peak - base) / 1e9:.3f} GB above the state); gradient finite, "
        f"nonzero on all {int(touched.sum())} dynamic bodies in contact, "
        f"max |d/dv| {float(gv.abs().max()):.4g}, max |d/dx| "
        f"{float(gp.abs().max()):.4g}; two backward runs bitwise; the state "
        f"bitwise equal to {DIFF_STEPS} steps of the normal mode; launches "
        f"{run.launches}")
    launches = {f"pile gradient ({DIFF_STEPS} steps)": run.launches}

    # one step through the kernels against one through the twins
    with KernelsOnly(backward=True):
        _, kv, kp, _, _, _ = rollout_grad(clone_state(pile_state), dcfg, 1,
                                          dynamic_height)
    # the twins sweep the colors the step uses (the normal mode's count):
    # the same values and gradient as the static max_colors sweep
    # (tests/test_torch_autodiff.py), a quarter of the passes
    t0 = time.perf_counter()
    with TwinsOnly(solve64=True):
        _, qv, qp, _, _, _ = rollout_grad(clone_state(pile_state), cfg, 1,
                                          dynamic_height, repeat=False)
    t_twin = time.perf_counter() - t0
    errs = []
    for name, x, y in (("d/dv", kv, qv), ("d/dx", kp, qp)):
        r = float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
        errs.append(f"{name}: {r:.3g} relative L2 (max abs "
                    f"{float((x - y).abs().max()):.3g} of "
                    f"{float(y.abs().max()):.4g})")
        if not r <= W1_RTOL:
            raise AssertionError(f"pile gradient, one step: {name} relative "
                                 f"L2 {r:.3g} from the twins' (tolerance "
                                 f"{W1_RTOL:g})")
    log(card, f"pile gradient, one step, against the twins on the card with "
        f"the solve in float64 ({t_twin:.1f} s): " + "; ".join(errs))
    return launches


def phase_grad_mixed(card, mixed_state):
    """Config 3 differentiates on the card: 3 steps from phase 3's state
    (box-box and the one-point kernels and their backward), the twins
    raising. Returns the launches."""
    import torch

    b, cfg = mixed_scene()
    with KernelsOnly(backward=True) as run:
        loss, gv, gp, _, t_fwd, t_bwd = rollout_grad(
            clone_state(mixed_state), cfg.replace(differentiable=True), 3,
            dynamic_height)
    need_launches("config 3 gradient", run.launches,
                  ("box_box", "pairs_1pt", "setup", "solve", "box_box_bwd",
                   "pairs_1pt_bwd", "setup_bwd", "solve_bwd"))
    if not (bool(torch.isfinite(gv).all()) and bool(torch.isfinite(gp).all())):
        raise AssertionError("config 3 gradient: not finite")
    log(card, f"config 3 gradient: 3 steps from step {MIXED_COMPARE_AFTER}, "
        f"forward {1e3 * t_fwd / 3:.2f} ms a step, backward "
        f"{1e3 * t_bwd / 3:.2f} ms a step, finite; launches {run.launches}")
    return {"config 3 gradient (3 steps)": run.launches}


def phase_grad_small(card, dev):
    """tests/test_autodiff.py on the card, through the kernels (the twins
    raising): the 4-body gradient finite and nonzero on body 1, central
    differences, gradient descent; then the same gradient from the CPU
    port. Returns the launches."""
    import numpy as np
    import torch

    from nudge_tpu_torch import engine, scenes

    b = scenes.scene_pile(4, seed=0)
    cfg = b.auto_config(differentiable=True, max_colors=8, solver_iters=12)

    def value_and_grad(st0, vel0, cfg=cfg):
        v = vel0.detach().clone().requires_grad_()
        st = st0.replace(bodies=st0.bodies.replace(vel=v))
        for _ in range(AUTODIFF_STEPS):
            st, _ = engine.step(st, cfg)
        target = torch.tensor(AUTODIFF_TARGET, device=v.device)
        loss = torch.sum((st.bodies.pos[1] - target) ** 2)
        (g,) = torch.autograd.grad(loss, v)
        return float(loss.detach()), g

    st0 = b.finalize(cfg, device=dev)
    t0 = time.perf_counter()
    with KernelsOnly(backward=True) as run:
        l0, g = value_and_grad(st0, st0.bodies.vel)
        if not (np.isfinite(l0) and bool(torch.isfinite(g).all())
                and float(torch.linalg.norm(g[1])) > 1e-4):
            raise AssertionError(f"4-body gradient: loss {l0}, |g[1]| "
                                 f"{float(torch.linalg.norm(g[1]))}")
        v0 = st0.bodies.vel.double().cpu().numpy()
        gd = g.double().cpu().numpy()
        rng = np.random.RandomState(1)
        fds = []
        for _ in range(2):
            d = rng.randn(*v0.shape)
            d /= np.linalg.norm(d)
            lp, _ = value_and_grad(st0, torch.tensor(v0 + FD_EPS * d,
                                                     dtype=torch.float32,
                                                     device=dev))
            lm, _ = value_and_grad(st0, torch.tensor(v0 - FD_EPS * d,
                                                     dtype=torch.float32,
                                                     device=dev))
            fd = (lp - lm) / (2 * FD_EPS)
            an = float(np.sum(gd * d))
            fds.append((fd, an))
            if abs(fd - an) > FD_RTOL * max(abs(fd), abs(an), 1e-6):
                raise AssertionError(f"4-body gradient: central difference "
                                     f"{fd} against {an}")
        v = st0.bodies.vel
        best = l0
        for _ in range(GD_ITERS):
            lv, gv = value_and_grad(st0, v)
            best = min(best, lv)
            v = v - GD_LR * gv
        best = min(best, value_and_grad(st0, v)[0])
    t_card = time.perf_counter() - t0
    if not best < GD_SHARE * l0:
        raise AssertionError(f"4-body gradient descent: best loss {best} from "
                             f"{l0}")
    # the CPU port sweeps the colors the scene uses: the static sweep's
    # value and gradient bit for bit (tests/test_torch_autodiff.py), faster
    t0 = time.perf_counter()
    cpu0 = b.finalize(cfg, device="cpu")
    lc, gc = value_and_grad(cpu0, cpu0.bodies.vel,
                            cfg.replace(differentiable=False))
    t_cpu = time.perf_counter() - t0
    err = float((g.cpu() - gc).abs().max())
    big = float(gc.abs().max())
    if not err <= CPU_GRAD_RTOL * big:
        raise AssertionError(f"4-body gradient: card against the CPU port "
                             f"{err:.3g} of {big:.3g}")
    # the bodies' inverse masses (the static ground's too) and the boxes'
    # frictions, through the mass and shape instances
    def param_grads(st0, cfg=cfg):
        im = st0.bodies.inv_mass.detach().clone().requires_grad_()
        fr = st0.boxes.friction.detach().clone().requires_grad_()
        st = st0.replace(bodies=st0.bodies.replace(inv_mass=im),
                         boxes=st0.boxes.replace(friction=fr))
        for _ in range(AUTODIFF_STEPS):
            st, _ = engine.step(st, cfg)
        target = torch.tensor(AUTODIFF_TARGET, device=im.device)
        loss = torch.sum((st.bodies.pos[1] - target) ** 2)
        return torch.autograd.grad(loss, [im, fr])

    with KernelsOnly(backward=True) as prun:
        pk = param_grads(st0)
    need_launches("4-body mass gradient", prun.launches,
                  ("box_box", "setup", "solve", "box_box_bwd", "setup_bwd",
                   "solve_bwd"))
    pc = param_grads(cpu0, cfg.replace(differentiable=False))
    # the same gate on the same loss: CPU_GRAD_RTOL of the rollout's
    # largest gradient element (d/dv's). Of the inverse masses' own largest
    # element (0.07) it would be below their float32 rounding: the CPU port
    # and jax.grad part by 1.5e-8 there too
    perrs = []
    for name, x, y in zip(("inv_mass", "friction"), pk, pc):
        e = float((x.cpu() - y).abs().max())
        b_ = float(y.abs().max())
        perrs.append(f"d/d{name} within {e:.3g} of the CPU port's (max |g| "
                     f"{b_:.4g})")
        if not (bool(torch.isfinite(x).all()) and e <= CPU_GRAD_RTOL * big):
            raise AssertionError(f"4-body gradient d/d{name}: card against "
                                 f"the CPU port {e:.3g}, gate "
                                 f"{CPU_GRAD_RTOL:g} x {big:.3g}")
    if not abs(float(pk[0][0])) > 0.0:
        raise AssertionError("4-body gradient: the static ground's inverse "
                             "mass takes none")
    log(card, "4-body gradient with respect to the inverse masses and the "
        "boxes' frictions: " + "; ".join(perrs) + f" (gate {CPU_GRAD_RTOL:g} "
        f"x the largest d/dv, {big:.4g}); the ground's "
        f"d/dinv_mass {float(pk[0][0]):.6g}; launches {prun.launches}")
    log(card, f"4-body gradient (tests/test_autodiff.py): loss {l0:.7g} "
        f"(CPU port {lc:.7g}), |g[1]| {float(torch.linalg.norm(g[1])):.4g}; "
        f"central differences " + ", ".join(
            f"{fd:.5g} vs {an:.5g}" for fd, an in fds)
        + f" (within {FD_RTOL:g}); gradient descent best {best:.4g} from "
        f"{l0:.4g}; the card's gradient within {err:.3g} of the CPU port's "
        f"(max |g| {big:.4g}); {t_card:.1f} s on the card "
        f"({2 + 4 + GD_ITERS + 1} gradients), {t_cpu:.1f} s for one on the "
        f"CPU; launches {run.launches}")
    return {"4-body gradient (test_autodiff)": run.launches,
            "4-body gradient, inverse masses and frictions": prun.launches}


def phase_grad_examples(card):
    """The ported examples on the card, the twins raising: diff_throw's
    loss below THROW_LOSS, policy_grad's final mean return POLICY_GAIN
    above its first update's and the untrained policy's. Returns the
    launches."""
    import numpy as np

    from nudge_tpu_torch.examples import diff_throw, policy_grad

    import torch

    from nudge_tpu_torch import engine

    launches = {}
    with KernelsOnly(backward=True) as run:
        throw = diff_throw.main(["--device", "cuda"])
    launches["diff_throw"] = run.launches
    if not throw["final_loss"] < THROW_LOSS:
        raise AssertionError(f"diff_throw: final loss {throw['final_loss']}")
    # one iteration as the eager loop, for its time
    st0, cfg = diff_throw.build("cuda")
    v = torch.tensor(throw["v"], device=st0.device, requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = st0.replace(bodies=st0.bodies.replace(vel=torch.cat(
        [st0.bodies.vel[:1], v[None], st0.bodies.vel[2:]])))
    for _ in range(diff_throw.STEPS):
        st, _ = engine.step(st, cfg)
    torch.autograd.grad(st.bodies.pos[1].sum(), v)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    log(card, f"diff_throw: {len(throw['loss'])} iterations of "
        f"{diff_throw.STEPS} steps, loss " + " ".join(
            f"{x:.4g}" for x in throw["loss"])
        + f", final {throw['final_loss']:.3g}; "
        f"{np.mean(throw['seconds']):.3f} s an iteration (compiled "
        f"gradient; the first {throw['seconds'][0]:.3f} s with the "
        f"captures), the eager loop {t_eager:.3f} s for one; launches "
        f"{run.launches}")
    with KernelsOnly(backward=True) as run:
        pg = policy_grad.main(["--device", "cuda"])
    launches["policy_grad"] = run.launches
    gain = pg["return"][-1] - pg["return"][0]
    untrained = -policy_grad.HORIZON * 4.0
    if not (gain > POLICY_GAIN
            and pg["return"][-1] > untrained + POLICY_GAIN):
        raise AssertionError(f"policy_grad: mean return "
                             f"{pg['return'][0]} -> {pg['return'][-1]}")
    log(card, f"policy_grad: {len(pg['return'])} updates of "
        f"{policy_grad.BATCH} rollouts, mean return " + " ".join(
            f"{x:.3f}" for x in pg["return"])
        + f" (gain {gain:.3f}); {np.mean(pg['seconds']):.3f} s an update "
        f"(compiled gradient; the first {pg['seconds'][0]:.3f} s); "
        f"launches {run.launches}")
    return launches


def phase_grad(card, dev, pile_state, mixed_state):
    """Phase 18, the differentiable mode. Returns (backward kernel records,
    launches by path)."""
    from nudge_tpu_torch import scenes

    t0 = time.perf_counter()
    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE)
    records = {"box_box_bwd": compare_np_backward(
        card, f"awake pile, step {COMPARE_AFTER}", pile_state, cfg,
        "box_box")}
    _, mcfg = mixed_scene()
    records["pairs_1pt_bwd"] = compare_np_backward(
        card, f"config 3, step {MIXED_COMPARE_AFTER}", mixed_state, mcfg,
        "pairs_1pt")
    inputs = step_inputs(pile_state, cfg)
    label = f"awake pile, step {COMPARE_AFTER}"
    records["setup_bwd"] = compare_setup_backward(card, label, inputs, cfg)
    ref = {}
    records["solve_bwd"] = compare_solve_backward(card, label, inputs, cfg,
                                                  ref=ref)
    # the spill color's adjoint at full size
    from nudge_tpu_torch.ops import solver, solver_kernel

    bodies, man, warm, pwarm, _, _ = inputs
    scfg = cfg.replace(max_colors=SPILL_COLORS)
    scol = solver.color_manifolds(man, bodies, scfg)
    sorder = solver_kernel.color_order(man, bodies, scol, scfg)
    spill = compare_solve_backward(
        card, f"{label}, {SPILL_COLORS} colors",
        (bodies, man, warm, pwarm, scol, sorder), scfg, spill=True)
    records["solve_bwd"]["max_abs_err"] = max(
        records["solve_bwd"]["max_abs_err"], spill["max_abs_err"])
    # the mass instance: the im rows' and a static side's j rows' adjoints
    mass = compare_solve_backward(card, f"{label}, mass instance", inputs,
                                  cfg, mass=True, ref=ref)
    records["solve_bwd"].update(
        mass_max_abs_err=mass["max_abs_err"], mass_ms=mass["ms"],
        mass_device_ms=mass["device_ms"],
        mass_kernel_device_ms=mass["kernel_device_ms"])
    records["solve_bwd"]["max_abs_err"] = max(
        records["solve_bwd"]["max_abs_err"], mass["max_abs_err"])
    launches = phase_grad_pile(card, pile_state)
    launches.update(phase_grad_mixed(card, mixed_state))
    launches.update(phase_grad_small(card, dev))
    t1 = time.perf_counter()
    launches.update(phase_grad_examples(card))
    t2 = time.perf_counter()
    log(card, f"phase 18: {t2 - t0:.1f} s, of which the two examples at "
        f"their originals' iteration counts {t2 - t1:.1f} s")
    return records, launches


# phase 19: the mesh. One rank (NCCL) at config 5's 16 x 256 layout, and
# two ranks (gloo: NCCL refuses two ranks on one card) on the one card at
# the 128 x 32 layout's chunk size over MESH2_CHUNKS chunks.
MESH_SPC, MESH_STEPS = 256, 30
MESH2_SPC, MESH2_CHUNKS, MESH2_STEPS = 32, 4, 10
MESH_TIMEOUT_S = 300
DEMO_STEPS = 300   # the demo's first 300 of its 600 steps: the drop


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_stack(spc, n_chunks, dev):
    """Config 5's megachunk stack at `spc` scenes a chunk (phase 16's
    capacities and seed), `n_chunks` chunks."""
    from nudge_tpu_torch import scenes

    proto = scenes.scene_pile_batch(spc, C5_BODIES, seed=C5_SEED)
    cfg = scenes.cover_footprint(proto, pile_config(proto, proto.num_bodies))
    batch, _ = scenes.scene_pile_megachunks(n_chunks, spc, C5_BODIES, cfg=cfg,
                                            seed=C5_SEED, device=dev)
    return batch, cfg


def sharded_on(tree, mesh):
    """Whether every leaf is a DTensor placed Shard(0) on `mesh`."""
    from torch.distributed.tensor import DTensor, Shard

    return all(isinstance(x, DTensor) and x.device_mesh == mesh
               and tuple(x.placements) == (Shard(0),) for x in leaves(tree))


def mesh_rank(rank, port, out_path):
    """One rank of the two-rank gloo group on the one card: its two chunks
    of the stack through megabatch_simulate(mesh=), the kernels only,
    against the same chunks stepped alone by the eager engine.step in this
    process, bitwise.
    Writes what it found to out_path.format(rank)."""
    sys.path.insert(0, REPO)
    import datetime

    import torch
    import torch.distributed as dist

    from nudge_tpu_torch.parallel import mesh
    from nudge_tpu_torch.state import tree_map

    m = mesh.scene_mesh("cuda", backend="gloo",
                        init_method=f"tcp://localhost:{port}", world_size=2,
                        rank=rank,
                        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    dev = torch.device("cuda", torch.cuda.current_device())
    batch, cfg = mesh_stack(MESH2_SPC, MESH2_CHUNKS, dev)
    k = MESH2_CHUNKS // 2
    with KernelsOnly() as run:
        out, mt = mesh.megabatch_simulate(cfg, MESH2_STEPS, mesh=m)(batch)
    local, local_m = mesh.local_batch(out), mesh.local_batch(mt)
    equal = True
    for j in range(k):
        alone, ma = eager_simulate(clone_state(mesh.take(batch, rank * k + j)),
                                   cfg, MESH2_STEPS)
        equal = (equal and bitwise(mesh.take(local, j), alone)
                 and bitwise(tree_map(lambda x: x[j], local_m),
                             tree_map(lambda x: x[-1], ma)))
    res = dict(rank=rank, launches=run.launches,
               sharded=sharded_on(out, m) and sharded_on(mt, m),
               equal=equal,
               contacts=int(mesh.local_batch(mt).contact_count.sum()))
    with open(out_path.format(rank), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh(card, dev, kept):
    """Phase 19: megabatch_simulate(mesh=) on a one-rank NCCL mesh at
    config 5's 16 x 256 layout from phase 16's stack (`kept`: its start,
    end and config), MESH_STEPS steps, the kernels only, the stack placed
    Shard(0) and bitwise phase 16's unsharded end state; then two gloo
    ranks on the one card (MESH2_CHUNKS chunks of MESH2_SPC scenes, each
    rank its two chunks against the same chunks stepped alone in its own
    process). Returns the launches by path."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from nudge_tpu_torch.parallel import mesh

    n_chunks = C5_SCENES // MESH_SPC
    label = f"mesh, 1 rank (NCCL), {n_chunks} x {MESH_SPC} x {C5_BODIES}"
    batch, cfg, ref = kept["start"], kept["cfg"], kept["end"]
    m1 = mesh.scene_mesh("cuda", init_method=f"tcp://localhost:{free_port()}",
                         world_size=1, rank=0)
    try:
        with KernelsOnly() as run:
            t0 = time.perf_counter()
            out, mt = mesh.megabatch_simulate(cfg, MESH_STEPS, mesh=m1)(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if not (sharded_on(out, m1) and sharded_on(mt, m1)):
            raise AssertionError(f"{label}: a leaf not placed Shard(0) on "
                                 "the mesh")
        if not (same_state(mesh.local_batch(out), ref)
                and same_state(mesh.local_batch(mt), kept["end_metrics"])):
            raise AssertionError(f"{label}: differs from phase 16's "
                                 "unsharded run")
        want = n_chunks * MESH_STEPS
        if any(run.launches[k] != want for k in ("box_box", "setup", "solve")):
            raise AssertionError(f"{label}: launches {run.launches}")
    finally:
        dist.destroy_process_group()
    log(card, f"{label}: {MESH_STEPS} steps in {dt:.2f} s "
        f"({MESH_STEPS / dt:.4f} steps/s, "
        f"{MESH_STEPS * C5_SCENES * C5_BODIES / dt:.1f} body-steps/s, one "
        f"call); stack and metrics Shard(0) on the 'scenes' mesh and bitwise "
        f"phase 16's unsharded end state and last metrics; launches "
        f"{run.launches}")
    by_path = {label: run.launches}
    kept.clear()
    del batch, out, ref
    torch.cuda.empty_cache()

    out_path = os.path.join(OUT_DIR, "chip_smoke_mesh_rank{}.json")
    label2 = (f"mesh, 2 ranks (gloo) on one card, {MESH2_CHUNKS} x "
              f"{MESH2_SPC} x {C5_BODIES}")
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(free_port(), out_path), nprocs=2,
                       start_method="spawn")
    dt = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(out_path.format(r)) as f:
            ranks.append(json.load(f))
    for res in ranks:
        if not (res["sharded"] and res["equal"]):
            raise AssertionError(f"{label2}: rank {res['rank']}: sharded "
                                 f"{res['sharded']}, equal to its chunks "
                                 f"alone {res['equal']}")
    launches = {k: sum(res["launches"][k] for res in ranks)
                for k in ranks[0]["launches"]}
    log(card, f"{label2}: {MESH2_STEPS} steps; each rank's chunks Shard(0) "
        f"and bitwise equal to the same chunks stepped alone in its "
        f"process; contacts by rank {[res['contacts'] for res in ranks]}; "
        f"{dt:.1f} s with the two processes' start; launches {launches}")
    by_path[label2] = launches
    return by_path


def phase_demo(card):
    """Phase 20: the ported demo (nudge_tpu_torch.examples.demo) without
    rendering, the kernels only: its steps/s beside the card. Returns the
    launches by path."""
    from nudge_tpu_torch.examples import demo

    with KernelsOnly() as run:
        out = demo.main(["--device", "cuda", "--no-render", "--steps",
                         str(DEMO_STEPS)])
    f = out["final"]
    if f["overflow"] or not f["contacts"] > 0:
        raise AssertionError(f"demo: final metrics {f}")
    log(card, f"demo (256-box pile, {out['steps']} steps in windows of 10, "
        f"the frames read back): {out['steps_per_s']:.1f} steps/s on "
        f"{card}; final {f}; launches {run.launches}")
    return {"demo (256 boxes)": run.launches}


def host_reads_free(graph, st, steps):
    """`steps` replays of a compiled step from `st` under
    torch.cuda.set_sync_debug_mode("error"): any operation that waits on
    the device between the rollout's start and its end raises."""
    import torch

    graph.start()
    graph.load(st)
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay(steps)
    finally:
        torch.cuda.set_sync_debug_mode(old)
    return graph.finish()


def rates(times):
    """(impact steps/s over the first IMPACT_STEPS, settled steps/s over the
    last SETTLED_TAIL) from run_reference's cumulative times."""
    return (IMPACT_STEPS / times[IMPACT_STEPS // REF_HALF],
            SETTLED_TAIL / (times[-1] - times[-1 - SETTLED_TAIL // REF_HALF]))


def phase_compiled(card, dev, eager):
    """Phase 21, the compiled rollout: phase 11's fidelity scene from spawn
    for REF_STEPS steps through engine.simulate (the step captured once as
    a CUDA graph, the park, the rebuild and sleeping's skips conditional
    nodes, the claim rounds one kernel launch), in phase 11's windows with its gates and
    end gates, the kernels only; every REF_HALF steps' metrics and the end
    state bitwise phase 11's eager run (`eager`), the same parks and
    rebuilds in every window, box-box, setup and the solve once per active
    step and nothing on a parked step; its impact and settled steps/s
    beside phase 11's; at step SETTLED_AT PROFILE_STEPS compiled steps
    under the profiler as phase 14 profiles the eager ones (device busy
    share, device events a step, host launch calls a step: one graph
    launch), the device operations a replay runs (utils/timing.graph_ops),
    and as many replays under the sync debug mode "error" (no host read);
    the warm-up's and the capture's seconds. Returns the launches."""
    import torch

    from nudge_tpu_torch import control, engine, scenes
    from nudge_tpu_torch.utils import timing

    control.clear()
    torch.cuda.empty_cache()
    b = scenes.scene_pile(N_PILE, seed=FIDELITY_SEED)
    cfg = reference_config(b, N_PILE)
    st0 = b.finalize(cfg, device=dev)
    with KernelsOnly():
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = control.compiled(engine.step, cfg, st0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pool_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    del st0
    nodes = timing._node_kinds(graph.graph.raw_cuda_graph())
    for body in graph.bodies:
        for k, n in timing._node_kinds(body.graph).items():
            nodes[k] = nodes.get(k, 0) + n
    label = "compiled reference pile"
    launches, st, _, tr = reference_pile(card, label, dev, FIDELITY_SEED,
                                         fidelity=True, keep_at=SETTLED_AT,
                                         sim=engine.simulate)
    if not bitwise(st, eager["state"]):
        raise AssertionError(f"{label}: the end state differs from phase 11's "
                             "eager run")
    for k, (a, e) in enumerate(zip(tr["metrics"], eager["metrics"])):
        if not bitwise(a, e):
            w0, w1 = k * REF_HALF, (k + 1) * REF_HALF
            raise AssertionError(f"{label}: steps {w0}..{w1}: metrics differ "
                                 "from phase 11's eager run")
    if (tr["parks"], tr["rebuilds"]) != (eager["parks"], eager["rebuilds"]):
        raise AssertionError(f"{label}: parks {tr['parks']} and rebuilds "
                             f"{tr['rebuilds']} by window, not phase 11's "
                             f"{eager['parks']} and {eager['rebuilds']}")
    impact, settled = rates(tr["times"])
    e_impact, e_settled = rates(eager["times"])
    log(card, f"{label}: {REF_STEPS} steps bitwise phase 11's eager run (end "
        f"state, every step's metrics, parks and rebuilds by window); "
        f"{REF_STEPS} steps in {tr['times'][-1]:.2f} s against "
        f"{eager['times'][-1]:.2f} s eager; impact steps 0-{IMPACT_STEPS} "
        f"{impact:.3f} steps/s (eager {e_impact:.3f}); last {SETTLED_TAIL} "
        f"steps {settled:.3f} steps/s (eager {e_settled:.3f}); warm-up and "
        f"capture {build_s:.2f} s, of it the capture {graph.capture_s:.2f} "
        f"s, memory it reserved {pool_gb:.3f} GB; {len(graph.bodies)} "
        f"conditional bodies; nodes captured (top graph and bodies) "
        f"{nodes}; launches {launches}")
    def one_launch(prof):
        if prof["graph_launches"] != 1.0:
            raise AssertionError(f"{label}: {prof['graph_launches']} graph "
                                 "launches a step under the profiler, not 1")

    profile_steps(card, f"compiled reference pile (step {SETTLED_AT})",
                  tr["kept"], cfg, sim=engine.simulate, check=one_launch)
    ran = host_reads_free(graph, clone_state(tr["kept"]), PROFILE_STEPS)
    ops = timing.graph_ops(graph)
    taken = {k: v for k, v in sorted(ran.items()) if v}
    log(card, f"{label} at step {SETTLED_AT}: {PROFILE_STEPS} replays under "
        f"the sync debug mode 'error': 0 host reads a step; device "
        f"operations a replay "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(ops.items()))
        + f"; conditional bodies run {taken}")
    return launches


# --- phase 22: the compiled gradient -------------------------------------
# engine.simulate with a state leaf that requires grad: one _RolloutFn
# node, its forward the captured step's replays (each step's input state
# kept as a checkpoint), its backward a captured backward step
# (control.GradStep: the step recomputed from its checkpoint with grad
# enabled, then autograd.grad into the adjoints) replayed once a step in
# reverse. Each check is against the eager loop (engine.step in a Python
# loop, autograd over it). The leaves every step rewrites (vel, pos) must
# agree bit for bit. A leaf the step passes on unchanged (the inverse
# masses, the frictions) collects one term a step, which the loop may add
# in another order: within CARRIED_RTOL of the loop's largest element.
CARRIED_RTOL = 1e-6
GRAD_LONG_STEPS = 60       # the pile's long gradient: time and memory only
KE_WEIGHT = 1e-3           # the pile's loss adds the summed kinetic energy
SLEEP_GRAD_STEPS = 8       # the resting box, asleep after 3 steps
REBUILD_GRAD_STEPS = 6     # the 512-box reference-mode pile, from spawn


def grad_rollout(st0, cfg, steps, loss_fn, keys, compiled, audit=False):
    """`steps` steps from `st0` with its (part, field) leaves `keys`
    requiring grad, then d loss_fn(state, metrics) / d those leaves:
    through engine.simulate (`compiled`: the compiled gradient) or the
    eager loop. With `audit` the backward runs under the sync debug mode
    "error" (the backward's one host read, the body counters at its end,
    deferred until after it). Returns {loss, grads, state, fwd, bwd (s),
    peak (GB allocated above the start), reserved (GB the allocator
    reserved anew)}."""
    import torch

    from nudge_tpu_torch import control, engine

    leaves = {k: getattr(getattr(st0, k[0]), k[1]).detach().clone()
              .requires_grad_() for k in keys}
    parts = {}
    for (part, field), x in leaves.items():
        parts.setdefault(part, {})[field] = x
    st = st0.replace(**{p: getattr(st0, p).replace(**kw)
                        for p, kw in parts.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    if compiled:
        st, m = engine.simulate(st, cfg, steps)
    else:
        ms = []
        for _ in range(steps):
            st, mm = engine.step(st, cfg)
            ms.append(mm)
        m = engine.StepMetrics(**{k: torch.stack([getattr(x, k) for x in ms])
                                  for k in vars(ms[0])})
    loss = loss_fn(st, m)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    deferred = []
    if audit:
        finish = control.GradStep.finish
        control.GradStep.finish = lambda step: deferred.append(step)
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        g = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        if audit:
            torch.cuda.set_sync_debug_mode(old)
            control.GradStep.finish = finish
            for step in deferred:
                finish(step)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(loss=loss.detach(), grads=dict(zip(keys, g)),
                state=st, fwd=t1 - t0, bwd=t2 - t1,
                peak=(torch.cuda.max_memory_allocated() - base) / 1e9,
                reserved=(torch.cuda.memory_reserved() - reserved) / 1e9)


def same_grads(label, want, got, keys, carried=()):
    """Raise unless `got`'s loss and gradients are `want`'s bit for bit
    (those in `carried`: within CARRIED_RTOL of the largest element).
    Returns {key: max abs difference}."""
    import torch

    if not bitwise(want["loss"], got["loss"]):
        raise AssertionError(f"{label}: the loss differs from the eager "
                             "loop's")
    diffs = {}
    for k in keys:
        a, b = want["grads"][k], got["grads"][k]
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"{label}: d/d{k[1]} not finite")
        d = diffs[k[1]] = float((a - b).abs().max())
        if k in carried:
            if not d <= CARRIED_RTOL * float(a.abs().max()):
                raise AssertionError(f"{label}: d/d{k[1]} {d:.3g} from the "
                                     f"loop's (max {float(a.abs().max()):.4g})")
        elif not bitwise(a, b):
            raise AssertionError(f"{label}: d/d{k[1]} differs from the eager "
                                 f"loop's by up to {d:.3g}")
    return diffs


def grad_case(label, st0, cfg, steps, loss_fn, keys, carried=(),
              kernels=()):
    """The eager loop, then the compiled gradient twice (the first call
    captures), the kernels only: the same loss and gradients, the same
    launches of every kernel. Returns (eager, first, second runs, the
    launches)."""
    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import persistent_bp

    runs, launches, events = [], [], []
    for compiled in (False, True, True):
        p0 = engine.step.parked
        r0 = persistent_bp.persistent_broadphase.rebuilds
        with KernelsOnly(backward=True) as run:
            runs.append(grad_rollout(clone_state(st0), cfg, steps, loss_fn,
                                     keys, compiled, audit=compiled))
        launches.append(run.launches)
        events.append((engine.step.parked - p0,
                       persistent_bp.persistent_broadphase.rebuilds - r0))
    need_launches(label, launches[0], kernels)
    for k, (run, n, ev) in enumerate(zip(runs[1:], launches[1:], events[1:])):
        same_grads(f"{label} (compiled run {k + 1})", runs[0], run, keys,
                   carried)
        if n != launches[0] or ev != events[0]:
            raise AssertionError(f"{label}: compiled run {k + 1} launched "
                                 f"{n}, parks and rebuilds {ev}; the eager "
                                 f"loop {launches[0]}, {events[0]}")
    if not bitwise(runs[0]["state"], runs[1]["state"]):
        raise AssertionError(f"{label}: the compiled forward's state differs "
                             "from the eager loop's")
    return runs, launches[0], events[0]


def phase_compiled_grad(card, dev, pile_state, mixed_state):
    """Phase 22, the compiled gradient: engine.simulate with a leaf that
    requires grad, against the eager loop (see grad_case): the 20,480
    pile for DIFF_STEPS steps from step COMPARE_AFTER (phase 18's cell,
    loss the summed height plus KE_WEIGHT x the summed kinetic energy,
    d/d vel and pos bitwise, two compiled runs bitwise, every backward
    replay under the sync debug mode "error", one graph launch a backward
    step, the backward graph's device operations, capture seconds, times
    and memory); config 3 for 3 steps from step MIXED_COMPARE_AFTER; the
    4-body pile w.r.t. the inverse masses and the boxes' frictions; a
    resting box that falls asleep and parks in the window; the 512-box
    reference-mode pile with a rebuild in the window; then GRAD_LONG_STEPS
    steps of the pile's gradient (time and memory; it must finish
    finite). Returns the launches by path."""
    import torch

    from nudge_tpu_torch import control, engine, scenes
    from nudge_tpu_torch.state import flatten
    from nudge_tpu_torch.utils import timing

    t_phase = time.perf_counter()
    vp = (("bodies", "vel"), ("bodies", "pos"))
    b = scenes.scene_pile(N_PILE)
    cfg = pile_config(b, N_PILE).replace(differentiable=True)

    def pile_loss(st, m):
        return dynamic_height(st) + KE_WEIGHT * m.kinetic_energy.sum()

    runs, launches, _ = grad_case(
        "compiled pile gradient", pile_state, cfg, DIFF_STEPS, pile_loss, vp,
        kernels=("box_box", "setup", "solve", "box_box_bwd", "setup_bwd",
                 "solve_bwd"))
    need = [t is pile_state.bodies.vel or t is pile_state.bodies.pos
            for t in flatten(pile_state)[0]]
    graph = control.compiled_grad(engine.step, cfg, pile_state, need)
    if graph.replays != DIFF_STEPS:
        raise AssertionError(f"compiled pile gradient: {graph.replays} "
                             f"backward graph launches for {DIFF_STEPS} "
                             "steps")
    ops = timing.graph_ops(graph)
    fwd_graph = control.compiled(engine.step, cfg, pile_state)
    e, c1, c2 = runs
    log(card, f"compiled pile gradient: {DIFF_STEPS} steps of the {N_PILE} "
        f"pile from step {COMPARE_AFTER}, d/dv and d/dx bitwise the eager "
        f"loop's in both compiled runs (max |d/dv| "
        f"{float(e['grads'][vp[0]].abs().max()):.4g}, max |d/dx| "
        f"{float(e['grads'][vp[1]].abs().max()):.4g}), the forward's state "
        f"bitwise; 0 host reads over the backward replays (sync debug mode "
        f"'error'); {graph.replays} launches of one backward graph for "
        f"{DIFF_STEPS} steps; forward / backward ms a step: eager "
        f"{1e3 * e['fwd'] / DIFF_STEPS:.2f} / {1e3 * e['bwd'] / DIFF_STEPS:.2f}"
        f", compiled first call (captures) {1e3 * c1['fwd'] / DIFF_STEPS:.2f}"
        f" / {1e3 * c1['bwd'] / DIFF_STEPS:.2f}, second "
        f"{1e3 * c2['fwd'] / DIFF_STEPS:.2f} / "
        f"{1e3 * c2['bwd'] / DIFF_STEPS:.2f}; peak GB allocated above the "
        f"state: eager {e['peak']:.3f}, compiled first {c1['peak']:.3f} "
        f"(reserved anew {c1['reserved']:.3f}), second {c2['peak']:.3f} "
        f"(reserved anew {c2['reserved']:.3f}); capture s: forward graph "
        f"{fwd_graph.capture_s:.2f}, backward graph {graph.capture_s:.2f} "
        f"({len(graph.bodies)} conditional bodies); device "
        f"operations a backward replay "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(ops.items()))
        + f"; launches {launches}")
    by_path = {f"compiled pile gradient ({DIFF_STEPS} steps)": launches}

    _, mcfg = mixed_scene()
    _, launches, _ = grad_case(
        "compiled config 3 gradient", mixed_state,
        mcfg.replace(differentiable=True), 3, lambda st, m: dynamic_height(st),
        vp, kernels=("box_box", "pairs_1pt", "setup", "solve", "box_box_bwd",
                     "pairs_1pt_bwd", "setup_bwd", "solve_bwd"))
    log(card, f"compiled config 3 gradient: 3 steps from step "
        f"{MIXED_COMPARE_AFTER}, d/dv and d/dx bitwise the eager loop's, "
        f"launches {launches}")
    by_path["compiled config 3 gradient (3 steps)"] = launches

    b = scenes.scene_pile(4, seed=0)
    scfg = b.auto_config(differentiable=True, max_colors=8, solver_iters=12)
    target = torch.tensor(AUTODIFF_TARGET, device=dev)
    params = (("bodies", "inv_mass"), ("boxes", "friction"))
    runs, launches, _ = grad_case(
        "compiled 4-body gradient", b.finalize(scfg, device=dev), scfg,
        AUTODIFF_STEPS,
        lambda st, m: torch.sum((st.bodies.pos[1] - target) ** 2), params,
        carried=params, kernels=("setup_bwd", "solve_bwd"))
    d = same_grads("compiled 4-body gradient", runs[0], runs[1], params,
                   params)
    log(card, "compiled 4-body gradient with respect to the inverse masses "
        "and the boxes' frictions: " + ", ".join(
            f"d/d{k} within {v:.3g} of the loop's (max "
            f"{float(runs[0]['grads'][key].abs().max()):.4g}; bitwise "
            f"{bitwise(runs[0]['grads'][key], runs[1]['grads'][key])})"
            for (k, v), key in zip(d.items(), params))
        + f"; launches {launches}")

    b = scenes.scene_single_box(0.5)
    scfg = b.auto_config(differentiable=True, sleeping=True, sleep_frames=2,
                         max_colors=4, solver_iters=4)
    _, launches, (parks, _) = grad_case(
        "compiled gradient, resting box", b.finalize(scfg, device=dev), scfg,
        SLEEP_GRAD_STEPS,
        lambda st, m: torch.sum(st.bodies.pos ** 2) + m.kinetic_energy.sum(),
        vp)
    if parks < 1:
        raise AssertionError("compiled gradient, resting box: no park")
    log(card, f"compiled gradient, a resting box asleep ({SLEEP_GRAD_STEPS} "
        f"steps, {parks} parked): d/dv and d/dx bitwise the eager loop's; "
        f"launches {launches}")

    b = scenes.scene_pile(512, seed=1)
    scfg = b.auto_config(differentiable=True, sleeping=True,
                         persistent_broadphase=True, sleep_frames=4)
    _, launches, (_, rebuilds) = grad_case(
        "compiled gradient, reference-mode pile", b.finalize(scfg, device=dev),
        scfg, REBUILD_GRAD_STEPS,
        lambda st, m: dynamic_height(st) + m.max_depth.sum(), vp)
    if rebuilds < 1:
        raise AssertionError("compiled gradient, reference-mode pile: no "
                             "rebuild")
    log(card, f"compiled gradient, the 512-box pile in the reference mode "
        f"({REBUILD_GRAD_STEPS} steps from spawn, {rebuilds} rebuilds): "
        f"d/dv and d/dx bitwise the eager loop's; launches {launches}")

    with KernelsOnly(backward=True) as run:
        long = grad_rollout(clone_state(pile_state), cfg, GRAD_LONG_STEPS,
                            pile_loss, vp, compiled=True)
    if not all(bool(torch.isfinite(g).all()) for g in long["grads"].values()):
        raise AssertionError(f"compiled pile gradient, {GRAD_LONG_STEPS} "
                             "steps: not finite")
    log(card, f"compiled pile gradient, {GRAD_LONG_STEPS} steps: forward "
        f"{1e3 * long['fwd'] / GRAD_LONG_STEPS:.2f} ms a step, backward "
        f"{1e3 * long['bwd'] / GRAD_LONG_STEPS:.2f} ms a step, "
        f"{long['fwd'] + long['bwd']:.2f} s in all; peak {long['peak']:.3f} "
        f"GB allocated above the state (reserved anew "
        f"{long['reserved']:.3f}); launches {run.launches}")
    log(card, f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main():
    sys.path.insert(0, REPO)
    import torch

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build(card)
    records, pile_state = phase_compare(card, dev)
    records["pairs_1pt"], mixed_state = phase_compare_1pt(card, dev)
    phase_config1(card, dev)
    phase_slice(card, dev)
    phase_mixed(card, dev)
    coloring = phase_fresh(card, pile_state)["coloring"]
    phase_repeat(card, dev)
    phase_config1_parked(card, dev)
    phase_wake(card, dev)
    # the slice's main path
    launches, settled, ref_cfg, eager = phase_reference_pile(card, dev)
    # box-box where few slots are live: the fidelity scene settling
    low = compare_box_box(card, f"reference pile, step {SETTLED_AT}",
                          *box_box_inputs(settled, ref_cfg))
    records["box_box"]["max_abs_err"] = max(records["box_box"]["max_abs_err"],
                                            low["max_abs_err"])
    phase_bench_pile(card, dev)
    launches["pairs_1pt"] = phase_reference_mixed(card, dev)["pairs_1pt"]
    launches["coloring"] = coloring
    phase_profile(card, pile_state, settled, ref_cfg)
    phase_config2(card, dev)
    # this slice's paths: config 5, then the stacked batch, the API and the
    # environments
    kept = {}
    by_path, compared = phase_config5(card, dev, kept)
    got, more = phase_batch_api_envs(card, dev)
    by_path.update(got)
    compared.update(more)
    # this slice's paths: the differentiable mode
    grads, got = phase_grad(card, dev, pile_state, mixed_state)
    records.update(grads)
    by_path.update(got)
    launches.update({k: got[f"pile gradient ({DIFF_STEPS} steps)"][k]
                     for k in grads})
    launches["pairs_1pt_bwd"] = got["config 3 gradient (3 steps)"][
        "pairs_1pt_bwd"]
    # this slice's paths: the mesh, then the demo
    by_path.update(phase_mesh(card, dev, kept))
    by_path.update(phase_demo(card))
    # this slice's path: the compiled rollout
    by_path[f"compiled reference pile ({REF_STEPS} steps)"] = phase_compiled(
        card, dev, eager)
    # this slice's path: the compiled gradient
    by_path.update(phase_compiled_grad(card, dev, pile_state, mixed_state))
    # the profiler windows of phases 14-16 and 21, after every timed phase
    run_profiles()
    kernels = []
    for k in TPU_KERNEL_OF:
        rec = dict(name=k, route="cuda", source=SOURCE_OF[k],
                   replaces=TPU_KERNEL_OF[k], launches=launches[k],
                   **records[k])
        rec["launches_by_path"] = {p: n.get(k, 0) for p, n in by_path.items()}
        at = {p: r[k] for p, r in compared.items() if k in r}
        if at:
            rec["compare_by_path"] = at
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     *(r["max_abs_err"] for r in at.values()))
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
