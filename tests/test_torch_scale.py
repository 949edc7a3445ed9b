"""tests/test_scale_robustness.py on the port, on the CPU: the knobs that
auto_config derives from the scene's collider size L and dt give the same
qualitative physics at half extents {0.1, 0.5, 2.0} x dt {1/60, 1/120}
(a 5-box tower settles with penetration ~slop and KE ~0, no overflow), and
reproduce SimConfig's defaults at L = 0.5. Every derived field equals the
JAX package's auto_config on the same tower, at every scale and with
overrides.

The reference runs each tower for 5 simulated seconds with solver="xla";
the port runs on the CPU (device="cpu") for 1 second, as its plain solve
costs ~0.1 s a step there. The JAX package's own runs of these towers meet
every gate from step 15 on (step 28 at half 2.0, dt 1/120; 0.25 s at
most)."""

import dataclasses

import numpy as np
import pytest
import torch

from nudge_tpu import scenes as jscenes
from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.config import SimConfig

from _torch_bridge import DROPPED, np_

torch.set_num_threads(2)

SECONDS = 1.0


def tower(half: float, n: int = 5, scenes=pscenes):
    """The reference test's tower, built by `scenes` (the port's or the
    JAX package's)."""
    b = scenes.SceneBuilder()
    b.add_static_box((20 * half, half, 20 * half), (0.0, -half, 0.0))
    for i in range(n):
        # tiny lateral offsets so the stack is not axis-perfect
        b.add_box((half, half, half),
                  ((0.02 * half) * ((-1) ** i), (2 * i + 1.1) * half,
                   (0.013 * half) * ((-1) ** (i + 1))))
    return b


@pytest.mark.parametrize("half", [0.1, 0.5, 2.0])
@pytest.mark.parametrize("dt", [1.0 / 60.0, 1.0 / 120.0])
def test_tower_settles_at_scale(half, dt):
    b = tower(half)
    cfg = b.auto_config(dt=dt)
    st = b.finalize(cfg, device="cpu")
    st, m = pengine.simulate(st, cfg, int(round(SECONDS / dt)))
    depth = float(m.max_depth[-1])
    assert not bool(m.overflow.any())
    # rest penetration ~slop at every scale
    assert depth <= 2.5 * cfg.slop + 1e-6, (depth, cfg.slop)
    # KE per body against the scale's energy unit m*g*L: jitter, not motion
    ke = float(m.kinetic_energy[-1])
    g = float(np.linalg.norm(np.asarray(cfg.gravity)))
    assert ke / (5 * g * half) < 2e-3, ke
    # the tower stands: every box within half a size of its column
    pos = np_(st.bodies.pos)
    dyn = np_(st.bodies.inv_mass) > 0
    assert np.all(np.abs(pos[dyn][:, [0, 2]]) < 1.5 * half)
    assert np.all(pos[dyn][:, 1] > 0.0)


def _assert_config_like_reference(half, **kw):
    pcfg = tower(half).auto_config(**kw)
    jcfg = tower(half, scenes=jscenes).auto_config(**kw)
    for f in dataclasses.fields(jcfg):
        if f.name not in DROPPED:
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    return pcfg


@pytest.mark.parametrize("half", [0.1, 0.5, 2.0])
@pytest.mark.parametrize("dt", [1.0 / 60.0, 1.0 / 120.0])
def test_auto_config_matches_reference(half, dt):
    """Every field of the port's auto_config equals the JAX package's on
    the same tower, exactly."""
    _assert_config_like_reference(half, dt=dt)


def test_derived_knobs_match_tuned_defaults_at_reference_scale():
    """At L = 0.5, dt = 1/60, g = 9.81 the derivation gives SimConfig's
    defaults bit for bit."""
    cfg = tower(0.5).auto_config()
    d = SimConfig()
    for k in ("slop", "aabb_margin", "rebuild_margin", "deep_bias_depth",
              "deep_bias_ungated_depth", "deep_bias_gate",
              "deep_bias_ungated_vel", "max_bias_vel", "max_pseudo_vel",
              "sleep_lin_vel", "sleep_ang_vel"):
        assert getattr(cfg, k) == getattr(d, k), k


def test_explicit_override_beats_derivation():
    cfg = _assert_config_like_reference(2.0, slop=0.123, max_pseudo_vel=7.0)
    assert cfg.slop == 0.123
    assert cfg.max_pseudo_vel == 7.0
    # the members not overridden still derive from L = 2.0
    assert cfg.deep_bias_depth == pytest.approx(0.15 * 4.0)
