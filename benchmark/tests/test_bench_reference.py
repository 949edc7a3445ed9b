"""The plain reference is the port's plain step, bit for bit, on the CPU,
also in the reference mode (sleeping and the persistent broadphase), and
rebuilds the port's spawn scenes from the seed."""

import pytest
import torch
import tiny_bench  # noqa: F401

from reference import spawn, tree
from reference import step as ref_step


def _pile(n, seed, **mode):
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(n, seed=seed)
    cfg = b.auto_config(max_box_box_pairs=8 * n, max_manifolds=3 * n,
                        grid_density=16, fat_pair_factor=2, broadphase="grid",
                        **mode)
    return b, cfg


def _same(r, rm, nxt, m, where):
    """The reference's state and metrics `r`, `rm` equal the port's."""
    port = dict(tree.leaves(tree.from_fields(nxt)))
    for name, v in tree.leaves(r):
        assert torch.equal(v, port[name]), (where, name)
    for name, v in vars(rm).items():
        assert v.dtype == getattr(m, name).dtype, (where, name)
        assert torch.equal(v, getattr(m, name)), (where, name)


def test_reference_step_is_the_ports_cpu_step():
    from nudge_tpu_torch import engine

    b, cfg = _pile(200, 7)
    st = b.finalize(cfg, device="cpu")
    rc = tree.config(cfg)
    checked = 0
    for k in range(30):
        nxt, m = engine.step(st, cfg)
        if k in (0, 17, 29):
            r, rm = ref_step.step(tree.from_fields(st), rc)
            _same(r, rm, nxt, m, k)
            checked += int(m.contact_count)
        st = nxt
    assert checked > 100          # the pile is in contact by then


# The reference mode at test-only sleep settings (4 slow frames below 0.3
# m/s and 0.6 rad/s), so that the 200-box pile sleeps island by island
# within 40 steps and parks.
SLEEP = dict(sleeping=True, persistent_broadphase=True, sleep_frames=4,
             sleep_lin_vel=0.3, sleep_ang_vel=0.6)


def test_reference_mode_step_is_the_ports_cpu_step():
    """Every step, every leaf and metric bitwise, through each kind of
    step: the fat rebuild, the refilter, islands asleep beside awake
    bodies, a parked step, and (once the pile has parked, body 1 pushed
    at 3 m/s and woken, as a user pokes a scene) sleepers woken by a
    fast body, until the pile parks again."""
    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import persistent_bp

    b, cfg = _pile(200, 7, **SLEEP)
    st = b.finalize(cfg, device="cpu")
    rc = tree.config(cfg)
    seen = dict(rebuild=0, refilter=0, mixed=0, parked=0, woken=0)
    poked = False
    for k in range(60):
        parked0 = engine.step.parked
        rebuilds0 = persistent_bp.persistent_broadphase.rebuilds
        awake0 = st.sleep.awake & st.bodies.dynamic
        nxt, m = engine.step(st, cfg)
        r, rm = ref_step.step(tree.from_fields(st), rc)
        _same(r, rm, nxt, m, k)
        parked = engine.step.parked - parked0
        rebuilt = persistent_bp.persistent_broadphase.rebuilds - rebuilds0
        seen["parked"] += parked
        seen["rebuild"] += rebuilt
        seen["refilter"] += 1 - parked - rebuilt
        asleep0 = st.bodies.dynamic & ~st.sleep.awake
        seen["mixed"] += int(bool(awake0.any() and asleep0.any()))
        seen["woken"] += int(bool((asleep0 & nxt.sleep.awake).any()))
        st = nxt
        if parked and not poked:
            vel, awake = st.bodies.vel.clone(), st.sleep.awake.clone()
            vel[1, 0], awake[1] = 3.0, True
            st = st.replace(bodies=st.bodies.replace(vel=vel),
                            sleep=st.sleep.replace(awake=awake))
            poked = True
        elif parked and poked and seen["woken"]:
            break
    assert all(v >= 1 for v in seen.values()), seen


@pytest.mark.parametrize("change", (dict(max_spheres=8),
                                    dict(persistent_coloring=False),
                                    dict(split_impulse=False)),
                         ids=("spheres", "fresh_coloring", "no_split"))
def test_reference_refuses_what_it_does_not_step(change):
    b, cfg = _pile(8, 7, **SLEEP)
    st = tree.from_fields(b.finalize(cfg, device="cpu"))
    rc = tree.config(cfg).replace(**change)
    with pytest.raises(NotImplementedError):
        ref_step.step(st, rc)


def test_control_step_is_far_from_the_reference():
    from nudge_tpu_torch import engine

    b, cfg = _pile(200, 7)
    st = b.finalize(cfg, device="cpu")
    for _ in range(20):
        st, _ = engine.step(st, cfg)
    rc = tree.config(cfg)
    r, _ = ref_step.step(tree.from_fields(st), rc)
    low, _ = ref_step.step(tree.from_fields(st), rc, low=torch.bfloat16)
    assert float((low.bodies.pos - r.bodies.pos).abs().max()) > 1e-3


def test_spawn_is_the_ports_scene():
    from nudge_tpu_torch import scenes

    for n, seed in ((200, 7), (4096, 2 ** 31 + 5)):
        b, cfg = _pile(n, seed)
        port = dict(tree.leaves(tree.from_fields(b.finalize(cfg, "cpu"))))
        ref = spawn.pile(n, seed, cfg, "cpu")
        assert not [k for k in ref if k.startswith(("sleep.", "bp."))]
        for name, v in ref.items():
            assert torch.equal(v, port[name]), (n, name)
    b, cfg = _pile(200, 7, **SLEEP)
    port = dict(tree.leaves(tree.from_fields(b.finalize(cfg, "cpu"))))
    ref = spawn.pile(200, 7, cfg, "cpu")
    assert {n for n in port if n.startswith(("sleep.", "bp."))} == \
        {n for n in ref if n.startswith(("sleep.", "bp."))}
    for name, v in ref.items():
        assert torch.equal(v, port[name]), ("reference mode", name)
    stack, cfg = scenes.scene_pile_megachunks(2, 4, 8, seed=11, device="cpu")
    port = dict(tree.leaves(tree.from_fields(stack)))
    for name, v in spawn.pile_chunks(2, 4, 8, 11, cfg, "cpu").items():
        assert torch.equal(v, port[name]), name
