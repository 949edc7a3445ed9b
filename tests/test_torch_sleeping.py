"""The port's sleeping against the JAX package: `update_sleep` fed the same
bodies, manifolds, sleep state and wake mask in both packages (falling
asleep, waking through parked pairs, the kill plane, a quiet step, the
steps where the reference's skips are taken), the three skips shown to be
identities, and port mirrors of tests/test_sleeping.py at CPU sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu import state as jstate
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu.ops import sleeping as jsleeping
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch.ops import sleeping as psleeping
from nudge_tpu_torch.scenes import SceneBuilder
from nudge_tpu_torch.state import SleepState

from _torch_bridge import (
    assert_equal, jax_cfg, np_, port_manifolds, pressed_mixed_pile,
)

torch.set_num_threads(2)

SLEEP_FRAMES = 5


def _sleep_inputs(case):
    """(port cfg, JAX cfg, bodies as numpy dict, JAX manifolds, sleep state
    as numpy dict, fast mask or None) for one update_sleep case on a
    pressed 48-body mixed pile."""
    over = dict(sleeping=True, sleep_frames=SLEEP_FRAMES)
    if case == "kill_plane":
        over["kill_plane_y"] = 0.6          # the bottom layer is below it
    pcfg, jcfg, jst, _ = pressed_mixed_pile(48, **over)
    jman, _ = jax.jit(lambda s: jcontacts.collide(s, jcfg))(jst)
    rng = np.random.default_rng({"fall_asleep": 1, "wake": 2,
                                 "kill_plane": 3, "quiet": 4,
                                 "no_candidate": 5, "no_wake_seed": 6}[case])
    n = pcfg.max_bodies
    pos = np.asarray(jst.bodies.pos)
    dyn = np.asarray(jst.bodies.inv_mass) > 0
    fast_body = rng.uniform(size=n) < 0.2
    vel = rng.normal(0.0, 0.01, (n, 3)).astype(np.float32)
    angvel = rng.normal(0.0, 0.02, (n, 3)).astype(np.float32)
    vel[fast_body] *= 30.0
    idle = rng.integers(SLEEP_FRAMES - 2, SLEEP_FRAMES + 1, n).astype(np.int32)
    awake = np.ones(n, bool)
    pairs = np.full((pcfg.max_manifolds, 2), -1, np.int32)
    valid = np.asarray(jman.valid).copy()
    ba, bb = np.asarray(jman.body_a), np.asarray(jman.body_b)
    fast = None
    if case in ("wake", "kill_plane", "quiet", "no_wake_seed"):
        # the wake case: the two bottom layers sleep under an awake top
        # layer; the others: one half of the pile's columns sleeps
        asleep = dyn & ((pos[:, 1] < 2.0) if case == "wake"
                        else (pos[:, 0] < 0.0))
        awake = ~asleep
        both = valid & asleep[ba] & asleep[bb]
        pairs[:both.sum()] = np.stack([ba[both], bb[both]], -1)
        valid &= ~both                       # filtered before narrowphase
        vel[asleep] = 0.0
        angvel[asleep] = 0.0
        fast = awake & (rng.uniform(size=n) < 0.5)
    if case in ("wake", "quiet", "no_candidate"):     # no candidate
        idle[:] = 0
    if case in ("quiet", "no_wake_seed"):             # no wake seed
        fast = np.zeros(n, bool)
    bodies = dict(pos=pos, quat=np.asarray(jst.bodies.quat), vel=vel,
                  angvel=angvel, inv_mass=np.asarray(jst.bodies.inv_mass),
                  inv_inertia=np.asarray(jst.bodies.inv_inertia))
    jman = jman.replace(valid=jnp.asarray(valid))
    sleep = dict(idle=idle, awake=awake, pairs=pairs)
    return pcfg, jcfg, bodies, jman, sleep, fast


def _run_both(case):
    pcfg, jcfg, bodies, jman, sleep, fast = _sleep_inputs(case)
    jb = jstate.Bodies(**{k: jnp.asarray(v) for k, v in bodies.items()})
    js = jstate.SleepState(**{k: jnp.asarray(v) for k, v in sleep.items()})
    jfast = None if fast is None else jnp.asarray(fast)
    jsl, jbo = jax.jit(lambda b, m, s, f: jsleeping.update_sleep(
        b, m, s, jcfg, fast=f))(jb, jman, js, jfast)
    from nudge_tpu_torch.state import Bodies

    pb = Bodies(**{k: torch.from_numpy(np.array(v)) for k, v in bodies.items()})
    ps = SleepState(**{k: torch.from_numpy(np.array(v))
                       for k, v in sleep.items()})
    pfast = None if fast is None else torch.from_numpy(fast)
    psl, pbo = psleeping.update_sleep(pb, port_manifolds(jman), ps, pcfg,
                                      fast=pfast)
    return (pcfg, bodies, sleep, jman, fast), (jsl, jbo), (psl, pbo)


@pytest.mark.parametrize("case", ["fall_asleep", "wake", "kill_plane",
                                  "quiet"])
def test_update_sleep_matches_reference(case):
    (pcfg, bodies, sleep, _, _), (jsl, jbo), (psl, pbo) = _run_both(case)
    for f in ("idle", "awake", "pairs"):
        assert_equal(getattr(psl, f), getattr(jsl, f), f)
    assert_equal(pbo.vel, jbo.vel, "vel")
    assert_equal(pbo.angvel, jbo.angvel, "angvel")
    dyn = bodies["inv_mass"] > 0
    was, now = sleep["awake"] & dyn, np_(psl.awake) & dyn
    fell = was & ~now
    np.testing.assert_array_equal(np_(pbo.vel)[fell], 0.0)
    np.testing.assert_array_equal(np_(pbo.angvel)[fell], 0.0)
    woke = ~sleep["awake"] & dyn & now
    parked = int((np_(psl.pairs)[:, 0] >= 0).sum())
    if case == "fall_asleep":
        assert fell.sum() > 3 and now.sum() > 3 and parked > 0
    elif case == "wake":
        assert woke.sum() > 3 and (~now & dyn).sum() > 0
    elif case == "kill_plane":
        below = dyn & (bodies["pos"][:, 1] < pcfg.kill_plane_y)
        assert below.sum() > 3 and not (now & below).any()
    else:
        assert not fell.any() and not woke.any()
        assert_equal(psl.pairs, sleep["pairs"], "pairs kept")


# which of update_sleep's three skips each case takes: (asleep flood,
# wake flood, parked-pair rebuild) run
_SKIPS = {"no_candidate": (False, False, False),
          "no_wake_seed": (True, False, True)}


@pytest.mark.parametrize("case", sorted(_SKIPS))
def test_update_sleep_skips_match_reference(case, monkeypatch):
    """A step with no candidate (nothing can fall asleep, nobody sleeps)
    and one with no wake seed (sleepers, candidates, no fast body): the
    port skips the floods there as the reference's lax.conds do, and gives
    the reference's result, integers exactly, floats to assert_equal's
    tolerance."""
    ran = {}
    for name in ("asleep_flood", "wake_flood", "rebuild_pairs"):
        fn = getattr(psleeping, name)

        def record(*a, _fn=fn, _name=name, **k):
            ran[_name] = True
            return _fn(*a, **k)

        monkeypatch.setattr(psleeping, name, record)
    (_, bodies, sleep, _, _), (jsl, jbo), (psl, pbo) = _run_both(case)
    for f in ("idle", "awake", "pairs"):
        assert_equal(getattr(psl, f), getattr(jsl, f), f)
    assert_equal(pbo.vel, jbo.vel, "vel")
    assert_equal(pbo.angvel, jbo.angvel, "angvel")
    assert tuple(ran.get(n, False) for n in (
        "asleep_flood", "wake_flood", "rebuild_pairs")) == _SKIPS[case]
    dyn = bodies["inv_mass"] > 0
    fell = sleep["awake"] & dyn & ~np_(psl.awake)
    if case == "no_wake_seed":
        assert fell.sum() > 0 and (~sleep["awake"] & dyn).sum() > 3
    else:
        assert not fell.any() and np_(psl.awake)[dyn].all()


def test_asleep_flood_skip_is_identity():
    """With no candidate the reference skips the flood; the port floods and
    nothing can fall asleep either way."""
    pcfg, _, bodies, jman, sleep, _ = _sleep_inputs("wake")
    man = port_manifolds(jman)
    dyn = torch.from_numpy(bodies["inv_mass"] > 0)
    awake = torch.from_numpy(sleep["awake"])
    candidate = torch.zeros_like(dyn)
    lbl = torch.where(dyn & awake & ~candidate, -1, 0).to(torch.int32)
    lbl = torch.where(dyn, lbl, psleeping._BIG)
    ba, bb = man.body_a.long(), man.body_b.long()
    edge = man.valid & dyn[ba] & dyn[bb]
    flooded = psleeping.asleep_flood(lbl, ba, bb, edge, pcfg.island_sweeps)
    assert int(edge.sum()) > 0 and not torch.equal(flooded, lbl)
    assert torch.equal(candidate & ~(flooded < 0), candidate & ~(lbl < 0))


def test_wake_flood_skip_is_identity():
    """With no wake seed the reference skips the flood; the port's flood of
    all-zero flags is all-zero, bit for bit."""
    pcfg, _, _, _, sleep, _ = _sleep_inputs("wake")
    pairs = torch.from_numpy(sleep["pairs"])
    pa, pb = pairs[:, 0], pairs[:, 1]
    assert int((pa >= 0).sum()) > 3
    w0 = torch.zeros(pcfg.max_bodies, dtype=torch.int32)
    w = psleeping.wake_flood(w0, pa.clamp_min(0).long(), pb.clamp_min(0).long(),
                             pa >= 0, pcfg.island_sweeps)
    assert torch.equal(w, w0)


def test_parked_pair_rebuild_skip_is_identity():
    """On a step where nobody fell asleep or woke the reference keeps the
    parked list; rebuilding it gives the same list, bit for bit."""
    pcfg, _, bodies, jman, sleep, _ = _sleep_inputs("quiet")
    man = port_manifolds(jman)
    dyn = torch.from_numpy(bodies["inv_mass"] > 0)
    asleep = dyn & ~torch.from_numpy(sleep["awake"])
    pairs = torch.from_numpy(sleep["pairs"])
    assert int((pairs[:, 0] >= 0).sum()) > 3
    out = psleeping.rebuild_pairs(pairs, asleep, man.body_a.long(),
                                  man.body_b.long(), man.valid)
    assert torch.equal(out, pairs)


# --- port mirrors of tests/test_sleeping.py ---------------------------------

def _run(builder, steps, **over):
    cfg = builder.auto_config(sleeping=True, sleep_frames=30, **over)
    st, m = pengine.simulate(builder.finalize(cfg, device="cpu"), cfg,
                             steps)
    return cfg, st, m


def _ground():
    b = SceneBuilder()
    b.add_static_box((50, 0.5, 50), (0, -0.5, 0))
    return b


def test_single_box_falls_asleep():
    b = _ground()
    b.add_box((0.5, 0.5, 0.5), (0, 0.6, 0))
    parked0 = pengine.step.parked
    cfg, st, m = _run(b, 300)
    assert not bool(st.sleep.awake[1])
    assert int(m.awake_count[-1]) == 0 and int(m.awake_count[0]) == 1
    assert_equal(st.bodies.vel[1], np.zeros(3, np.float32), "vel")
    assert abs(float(st.bodies.pos[1, 1]) - 0.5) < 0.02
    assert pengine.step.parked > parked0      # the all-asleep park ran


def _stack_with_impactor(x=-6.0):
    b = _ground()
    for i in range(3):
        b.add_box((0.5, 0.5, 0.5), (0, 0.5 + i * 1.001, 0))
    b.add_box((0.5, 0.5, 0.5), (x, 0.5, 0), mass=4.0)
    return b


def fire_impactor(st, body=4, speed=8.0):
    """State surgery: give `body` a velocity along +x and wake it."""
    vel = st.bodies.vel.clone()
    vel[body] = torch.tensor([speed, 0.0, 0.0])
    awake = st.sleep.awake.clone()
    awake[body] = True
    return st.replace(bodies=st.bodies.replace(vel=vel),
                      sleep=st.sleep.replace(awake=awake))


@pytest.mark.parametrize("persistent", [False, True])
def test_sleeping_stack_wakes_on_impact(persistent):
    """tests/test_sleeping.py's impact test (persistent=False) and
    tests/test_persistent_bp.py's wake-pairs test (persistent=True), with
    the impactor 3 m from the stack instead of 6 and 80 + 50 steps instead
    of 250 + 200 (the stack sleeps by step ~40, the impact comes ~20 steps
    after the surgery)."""
    cfg, st, _ = _run(_stack_with_impactor(-3.0), 80,
                      persistent_broadphase=persistent)
    assert not bool(st.sleep.awake[1:4].any()), "asleep before the impact"
    assert int((st.sleep.pairs[:, 0] >= 0).sum()) >= 2
    st, m = pengine.simulate(fire_impactor(st), cfg, 50)
    assert int(m.awake_count.max()) >= 4, "the impact wakes the stack"
    assert bool(torch.isfinite(st.bodies.pos).all())


def test_sleeping_bodies_dont_consume_contacts():
    b = _ground()
    for i in range(4):
        b.add_box((0.5, 0.5, 0.5), (i * 1.2, 0.6, 0))
    _, _, m = _run(b, 300)
    assert int(m.awake_count[-1]) == 0
    assert int(m.contact_count[-1]) == 0


def test_half_settled_pile_partial_sleep():
    b = SceneBuilder()
    b.add_static_box((80, 0.5, 80), (0, -0.5, 0))
    b.add_box((0.5, 0.5, 0.5), (0, 0.55, 0))
    b.add_box((0.5, 0.5, 0.5), (1.01, 0.55, 0))
    b.add_box((0.5, 0.5, 0.5), (40.0, 12.0, 0))
    _, st, _ = _run(b, 80)
    assert not bool(st.sleep.awake[1]) and not bool(st.sleep.awake[2])


def test_sleeper_is_static_for_the_solver():
    """A sleeper under an awake load keeps exactly zero velocity: the
    solver never writes into it (40 + 40 steps instead of 120 + 100)."""
    b = _ground()
    b.add_box((0.5, 0.5, 0.5), (0, 0.6, 0))
    b.add_box((0.5, 0.5, 0.5), (0, 1.7, 0))
    cfg = b.auto_config(sleeping=True, sleep_frames=10_000)
    st, _ = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 40)
    vel, angvel = st.bodies.vel.clone(), st.bodies.angvel.clone()
    vel[1] = 0.0
    angvel[1] = 0.0
    awake = st.sleep.awake.clone()
    awake[1] = False
    st = st.replace(bodies=st.bodies.replace(vel=vel, angvel=angvel),
                    sleep=st.sleep.replace(awake=awake))
    st, m = pengine.simulate(st, cfg, 40)
    assert_equal(st.bodies.vel[1], np.zeros(3, np.float32), "vel")
    assert_equal(st.bodies.angvel[1], np.zeros(3, np.float32), "angvel")
    assert not bool(st.sleep.awake[1])
    assert float(m.kinetic_energy[-1]) < 1.0


def _total_energy(st, cfg):
    """KE + m g y over the dynamic bodies, in float64."""
    m_inv = st.bodies.inv_mass.double()
    mass = torch.where(m_inv > 0, 1.0 / m_inv.clamp_min(1e-12), 0.0)
    v = st.bodies.vel.double()
    return float(0.5 * torch.sum(mass * (v * v).sum(-1))
                 - torch.sum(mass * cfg.gravity[1]
                             * st.bodies.pos[:, 1].double()))


def test_mixed_stack_sleeps_with_energy_never_rising():
    """Boxes and a sphere in the reference mode: a sphere dropped on a box
    beside a second box. Both settle, fall asleep and park, and the total
    energy never rises once settled (relative tolerance 1e-5: float32
    positions of a few units carry ~1e-7 relative rounding per step)."""
    b = _ground()
    b.add_box((0.5, 0.5, 0.5), (0, 0.5, 0))
    b.add_box((0.5, 0.5, 0.5), (1.2, 0.5, 0))
    b.add_sphere(0.3, (0, 1.6, 0))
    cfg = b.auto_config(sleeping=True, sleep_frames=30,
                        persistent_broadphase=True)
    st = b.finalize(cfg, device="cpu")
    parked0 = pengine.step.parked
    energies = []
    for _ in range(12):
        st, m = pengine.simulate(st, cfg, 10)
        assert not bool(m.overflow.any())
        energies.append(_total_energy(st, cfg))
    assert int(m.awake_count[-1]) == 0 and pengine.step.parked > parked0
    assert abs(float(st.bodies.pos[3, 1]) - 1.3) < 0.02
    e = np.array(energies[4:])                  # from step 50 on
    assert (np.diff(e) <= 1e-5 * np.abs(e[:-1])).all(), energies
