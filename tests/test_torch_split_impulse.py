"""tests/test_split_impulse.py on the port, on the CPU: split-impulse
position correction recovers penetration without momentum, Baumgarte pops,
the deep-bias gate stays shut at rest and opens on approach, the pseudo
warm start goes through the cache, and a short stack settles. The
one-box scenes are also held to the JAX package's trajectory. The tall
towers are in test_torch_tower.py."""

import numpy as np
import torch

from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import cache as pcache
from nudge_tpu_torch.ops import contacts as pcontacts

from _torch_bridge import assert_same_trajectory, np_, rollout_both

torch.set_num_threads(2)


def drop_overlapping(split, overlap=0.12, vel=(0, 0, 0)):
    """A box spawned `overlap` deep in a slab, 120 steps: (its final
    position, KE by step, max depth by step), after holding the rollout to
    the JAX package's."""
    def scene(S):
        b = S.SceneBuilder()
        b.add_static_box((10, 0.5, 10), (0, -0.5, 0))
        b.add_box((0.5, 0.5, 0.5), (0, 0.5 - overlap, 0), vel=vel)
        return b

    _, st, m, jst, jm = rollout_both(scene, 120, split_impulse=split)
    assert_same_trajectory(st, m, jst, jm)
    return np_(st.bodies.pos)[1], m["kinetic_energy"], m["max_depth"]


def test_depenetration_without_momentum():
    pos, ke, depth = drop_overlapping(split=True)
    assert abs(pos[1] - 0.495) < 0.01
    assert depth[-1] < 0.01
    assert ke.max() < 0.05


def test_baumgarte_pops_for_contrast():
    pos, ke, depth = drop_overlapping(split=False)
    assert ke.max() > 0.2
    assert abs(pos[1] - 0.495) < 0.05


def test_deep_overlap_at_rest_stays_gated():
    pos, ke, depth = drop_overlapping(split=True, overlap=0.2)
    assert ke.max() < 0.05
    assert abs(pos[1] - 0.495) < 0.02
    assert depth[-1] < 0.01


def test_ungated_anti_creep_push_is_gentle():
    pos, ke, depth = drop_overlapping(split=True, overlap=0.35)
    assert ke.max() < 0.2
    assert ke[-1] < 1e-3
    assert abs(pos[1] - 0.495) < 0.02
    assert depth[-1] < 0.01


def test_deep_bias_gate_opens_on_approach():
    pos, ke, depth = drop_overlapping(split=True, overlap=0.25,
                                      vel=(0, -4.0, 0))
    assert ke[1:10].max() > 0.05
    assert abs(pos[1] - 0.495) < 0.02
    assert depth[-1] < 0.01


def _tower(n, gap):
    b = pscenes.SceneBuilder()
    b.add_static_box((10, 0.5, 10), (0, -0.5, 0))
    for k in range(n):
        b.add_box((0.5, 0.5, 0.5), (0, 0.5 + (1.0 + gap) * k, 0))
    return b


def test_pseudo_warm_start_carries_through_cache():
    """A settled 6-box tower carries pseudo impulses in its cache, and the
    next step reads them back (100 steps; 200 in the reference test, at
    rest by step ~60)."""
    b = _tower(6, 0.001)
    cfg = b.auto_config(split_impulse=True)
    st, _ = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 100)
    assert float(st.cache.pseudo.max()) > 0.0
    man, _ = pcontacts.collide(st, cfg)
    _, pwarm = pcache.read_cached_impulses(st.cache, man, cfg)
    assert float(pwarm.max()) > 0.0


def test_stack_settles_with_split_impulse():
    """A 4-box stack settles at its heights with KE ~0 (150 steps; 400 in
    the reference test, whose own run is at 1.1e-7 J by step 150)."""
    b = _tower(4, 0.002)
    cfg = b.auto_config(split_impulse=True)
    st, m = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, 150)
    pos = np_(st.bodies.pos)[1:5]
    np.testing.assert_allclose(pos[:, 1], [0.5, 1.5, 2.5, 3.5], atol=0.05)
    assert float(m.kinetic_energy[-1]) < 1e-4
