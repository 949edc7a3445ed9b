"""tests/test_split_impulse.py's 12-box towers on the port, on the CPU: at
10 solver iterations the warm-started split pseudo solve leaves much less
jitter than Baumgarte, and at the default 20 the tower stands quiet.

The reference tests run 600 steps and average the last 200; here 300
steps and the last 100 (the port's plain solve costs ~0.1 s a step on the
CPU). The JAX package's own run of this shortening: split 0.086 J against
Baumgarte 0.643 J at 10 iterations (ratio 0.13, the gate 0.6), 0.0107 J
at 20, top box at 11.465 and 11.449."""

import numpy as np
import torch

from nudge_tpu_torch import engine as pengine
from nudge_tpu_torch import scenes as pscenes

from _torch_bridge import np_

torch.set_num_threads(2)

STEPS, TAIL = 300, 100


def _tower_run(split, iters):
    b = pscenes.SceneBuilder()
    b.add_static_box((10, 0.5, 10), (0, -0.5, 0))
    for k in range(12):
        b.add_box((0.5, 0.5, 0.5), (0.01 * (k % 2), 0.5 + 1.0 * k, 0))
    cfg = b.auto_config(split_impulse=split, solver_iters=iters)
    st, m = pengine.simulate(b.finalize(cfg, device="cpu"), cfg, STEPS)
    assert not bool(m.overflow.any())
    return np_(m.kinetic_energy), float(st.bodies.pos[12, 1])


def test_tall_stack_low_iters_quieter_than_baumgarte():
    ke_s, top_s = _tower_run(split=True, iters=10)
    ke_b, _ = _tower_run(split=False, iters=10)
    assert ke_s[-TAIL:].mean() < 0.6 * ke_b[-TAIL:].mean()
    assert abs(top_s - 11.45) < 0.25


def test_tall_stack_default_iters_stands_quiet():
    ke, top = _tower_run(split=True, iters=20)
    assert ke[-TAIL:].mean() < 0.15
    assert abs(top - 11.45) < 0.1
    assert np.isfinite(ke).all()
