"""The comparison that decides a run's `correct`.

The program's steps are held to the plain reference (`reference.step`),
one step at a time from the program's own state: rollouts of a pile
diverge chaotically, so the reference follows the program step by step
and is compared with each step it is given. Every number is the worst
over the comparisons of a run; each has a limit of its own
(`limits/<cell>.json`).

    int_mismatch      integer outputs that differ: the contact cache's
                      keys (collider ids, feature ids, valid rows), the
                      cached coloring (ids, colors, valid rows, dynamic
                      sides), the step counter, and the step's integer
                      metrics (contacts, spilled manifolds, overflow and
                      its bits, awake bodies, manifold and pair demand);
                      with sleeping on, also the sleep state (idle
                      counters, awake flags, parked pairs), and with the
                      persistent broadphase the cache's integer and bool
                      leaves (fat pairs, their valid rows, its overflow,
                      flags and staleness);
    pos_gap_m         the widest gap of a body's position, in m (with the
                      persistent broadphase also of its anchors);
    quat_gap          the widest gap of a quaternion component (with the
                      persistent broadphase also of its anchors);
    vel_gap           the widest gap of a linear (m/s) or angular (rad/s)
                      velocity component;
    impulse_gap_rel   the widest gap of the cache's accumulated impulses
                      (world impulse and pseudo impulse), over the
                      reference's largest;
    ke_gap_rel        the gap of the step's kinetic energy, relative;
    depth_gap_m       the gap of the step's deepest penetration, in m;
    spawn_mismatch    elements of the spawn state that differ from the
                      reference's build of the scene from the seed;
    repeat_mismatch   fingerprints of a call's output that differ between
                      the window's first and last episode (every episode
                      starts from the same spawn and does the same work);
    replay_mismatch   metrics of the check's re-run of a call's leading
                      steps that differ from the window's (the re-run is
                      the window's computation, bit for bit), and in a
                      gradient cell the loss and gradient elements of the
                      re-run that differ from the window's;
    grad_gap_rel      in a gradient cell, the widest gap of an adjoint
                      element after one step backward, over the larger of
                      its leaf's largest reference element and the median
                      leaf's.

A cell's limits file names the numbers it is judged on. The sleep and
broadphase leaves are compared only where the configuration runs them:
elsewhere the step carries them through unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from reference import tree

INT_LEAVES = ("cache.ga", "cache.gb", "cache.feat", "cache.valid",
              "colors.ga", "colors.gb", "colors.color", "colors.valid",
              "colors.dynbits", "step_count")
SLEEP_LEAVES = ("sleep.idle", "sleep.awake", "sleep.pairs")
BP_LEAVES = ("bp.bb_a", "bp.bb_b", "bp.bb_valid", "bp.bs_a", "bp.bs_b",
             "bp.bs_valid", "bp.ss_a", "bp.ss_b", "bp.ss_valid",
             "bp.overflow", "bp.flags", "bp.stale")
INT_METRICS = ("contact_count", "spill_count", "overflow", "awake_count",
               "overflow_bits", "manifold_demand", "pair_demand")
NAMES = ("int_mismatch", "pos_gap_m", "quat_gap", "vel_gap",
         "impulse_gap_rel", "ke_gap_rel", "depth_gap_m", "spawn_mismatch",
         "repeat_mismatch", "replay_mismatch", "grad_gap_rel")


def load_limits(bench_dir: Path, cell: str) -> dict:
    return json.loads((bench_dir / "limits" / f"{cell}.json").read_text())


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _differ(a, b) -> int:
    return int((a != b).sum())


class Comparison:
    """The worst of each number over the comparisons of a run, for the
    configuration `cfg` (its flags choose the state's leaves compared)."""

    def __init__(self, cfg=None):
        self.numbers = {n: 0 for n in NAMES}
        self.count = 0
        self.notes = []
        self.sleeping = bool(cfg is not None and cfg.sleeping)
        self.persistent_bp = bool(cfg is not None
                                  and cfg.persistent_broadphase)

    def worst(self, name: str, value):
        self.numbers[name] = max(self.numbers[name], value)

    def metrics(self, prog: dict, ref):
        """The program's metrics of one step ({name: 0-d tensor}) against
        the reference's (a Rec)."""
        self.worst("int_mismatch", sum(
            _differ(prog[k].to(torch.int64).cpu(),
                    getattr(ref, k).to(torch.int64).cpu())
            for k in INT_METRICS))
        ke = float(ref.kinetic_energy)
        self.worst("ke_gap_rel", abs(float(prog["kinetic_energy"]) - ke)
                   / max(abs(ke), 1e-30))
        self.worst("depth_gap_m", abs(float(prog["max_depth"])
                                      - float(ref.max_depth)))

    def state(self, prog_state, ref_state):
        """The program's state after one step against the reference's."""
        p = dict(tree.leaves(tree.from_fields(prog_state)))
        r = dict(tree.leaves(ref_state))
        ints = INT_LEAVES
        pos, quat = ["bodies.pos"], ["bodies.quat"]
        if self.sleeping:
            ints = ints + SLEEP_LEAVES
        if self.persistent_bp:
            ints = ints + BP_LEAVES
            pos.append("bp.anchor_pos")
            quat.append("bp.anchor_quat")
        self.worst("int_mismatch", sum(_differ(p[k], r[k]) for k in ints))
        self.worst("pos_gap_m", max(_gap(p[k], r[k]) for k in pos))
        self.worst("quat_gap", max(_gap(p[k], r[k]) for k in quat))
        self.worst("vel_gap", max(_gap(p["bodies.vel"], r["bodies.vel"]),
                                  _gap(p["bodies.angvel"],
                                       r["bodies.angvel"])))
        scale = max(float(r["cache.impulse"].abs().max()),
                    float(r["cache.pseudo"].abs().max()), 1e-30)
        self.worst("impulse_gap_rel",
                   max(_gap(p["cache.impulse"], r["cache.impulse"]),
                       _gap(p["cache.pseudo"], r["cache.pseudo"])) / scale)
        self.count += 1

    def adjoint(self, prog: dict, ref: dict):
        """The program's adjoints after one step backward ({name: tensor})
        against the reference's."""
        tops = {n: float(r.abs().max()) for n, r in ref.items()}
        floor = sorted(tops.values())[len(tops) // 2]
        gaps = {n: _gap(prog[n], ref[n]) / max(tops[n], floor, 1e-30)
                for n in ref}
        self.notes.append("adjoint gaps " + ", ".join(
            f"{n} {g:.3g} (largest {tops[n]:.3g})" for n, g in gaps.items()))
        self.worst("grad_gap_rel", max(gaps.values()))

    def spawn(self, prog_state, ref_leaves: dict):
        p = dict(tree.leaves(tree.from_fields(prog_state)))
        self.worst("spawn_mismatch", sum(
            _differ(p[k], v) if p[k].shape == v.shape else v.numel()
            for k, v in ref_leaves.items()))

    def judge(self, limits: dict):
        """(correct, [(name, number, limit)]) over the numbers `limits`
        names."""
        unknown = set(limits) - set(NAMES)
        if unknown:
            raise KeyError(f"limits for unknown numbers {sorted(unknown)}")
        rows = [(n, self.numbers[n], limits[n]) for n in NAMES if n in limits]
        return all(v <= lim for _, v, lim in rows), rows


def fingerprint_of(parts) -> torch.Tensor:
    """An int64 digest a float32 tensor: the sum of its bit patterns
    (computed on the device, read after the window)."""
    return torch.stack([t.detach().contiguous().view(torch.int32)
                        .to(torch.int64).sum() for t in parts])


def fingerprint(state) -> torch.Tensor:
    """`fingerprint_of` the bodies' motion and the cache's impulses."""
    return fingerprint_of([state.bodies.pos, state.bodies.quat,
                           state.bodies.vel, state.bodies.angvel,
                           state.cache.impulse])


def reference_step(state, cfg, low=None, adjoint=None):
    """The reference's step from the program's state `state`: (state,
    metrics, adjoints). With `adjoint` = (the adjoints of the next state's
    leaves {name: tensor}, the weight of the step's kinetic energy, the
    adjoints wanted {name: ...}) it also takes the vector-Jacobian product
    into those leaves ({name: tensor}), with the reference's solve in
    float64 (`reference.step`); else the adjoints are None."""
    from reference import step as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, cfg = tree.from_fields(state), tree.config(cfg)
    if adjoint is None:
        with torch.no_grad():
            return (*ref.step(rec, cfg, low=low), None)
    nxt, weight, wanted = adjoint
    rec, xs = tree.with_grad(tree.detached(rec), set(wanted))
    with torch.enable_grad():
        out, m = ref.step(rec, cfg, low=low, solve64=True)
        leaves = dict(tree.leaves(out))
        obj = weight * m.kinetic_energy
        for name, a in nxt.items():
            obj = obj + (leaves[name] * a).sum()
        got = torch.autograd.grad(obj, [xs[n] for n in wanted],
                                  allow_unused=True)
    adj = {n: torch.zeros_like(xs[n]) if g is None else g
           for n, g in zip(wanted, got)}
    return tree.detached(out), tree.detached(m), adj


def judge_with(cmp: Comparison, cfg, control=None):
    """The judge every entry's check calls: `judge(s_in, out_state, out_row,
    adjoint=None)` compares into `cmp` the reference's step from the
    program's state `s_in` with the program's output state (None: its
    metrics only) and metrics row; with `adjoint` (the next state's
    adjoints, the kinetic energy's weight, this state's adjoints) also the
    step's vector-Jacobian product. With `control` (a dtype) the reference
    computed in that precision is judged in the program's place."""

    def judge(s_in, out_state, out_row, adjoint=None):
        ref_state, ref_m, ref_adj = reference_step(s_in, cfg,
                                                   adjoint=adjoint)
        if control is not None:    # the control in the program's place
            out_state, low_m, low_adj = reference_step(
                s_in, cfg, control, adjoint=adjoint)
            out_row = dict(vars(low_m))
            if adjoint is not None:
                adjoint = (None, None, low_adj)
        if out_state is not None:
            cmp.state(out_state, ref_state)
        cmp.metrics(out_row, ref_m)
        if adjoint is not None:
            cmp.adjoint(adjoint[2], ref_adj)

    return judge


def metrics_row(metrics, k: int) -> dict:
    """Step `k` of a [steps] StepMetrics as {name: 0-d tensor}."""
    return {name: t[k] for name, t in vars(metrics).items()}
