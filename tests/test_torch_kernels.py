"""The CUDA kernels of nudge_tpu_torch against their plain PyTorch twins, on
the same CUDA tensors. These need an NVIDIA GPU and skip without one.

This file imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from nudge_tpu_torch import engine, scenes
from nudge_tpu_torch.ops import broadphase, cache, contacts, grid, integrate
from nudge_tpu_torch.ops import narrowphase_kernel as npk
from nudge_tpu_torch.ops import setup_kernel, solver, solver_kernel

pytestmark = pytest.mark.gpu

# Kernels and twins run the same float32 operations in the same order (the
# kernels are built without FMA contraction); the twins' scatter-adds use
# atomics on the card and sum in another order, hence a tolerance at all.
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _close(a, b, name):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)


def _pressed_pile(n, dev, **over):
    """A pile with its layers pressed together: contacts from step 0."""
    b = scenes.scene_pile(n, seed=4, walls=True)
    cfg = b.auto_config(**over)
    st = b.finalize(cfg, device=dev)
    pos = st.bodies.pos.clone()
    dyn = st.bodies.inv_mass > 0
    pos[dyn, 1] = 0.5 + (pos[dyn, 1] - 0.75) * (0.995 / 1.15)
    return cfg, st.replace(bodies=st.bodies.replace(pos=pos))


def _stage_inputs(cfg, st):
    bodies = integrate.apply_gravity(st.bodies, st.sleep, cfg)
    man = contacts.collide(st, cfg)
    warm, pwarm = cache.read_cached_impulses(st.cache, man, cfg)
    col, _ = solver.color_manifolds_cached(man, bodies, cfg, st.colors)
    return bodies, man, warm, pwarm, col


def test_box_box_kernel_matches_twin(dev):
    cfg, st = _pressed_pile(300, dev, broadphase="grid")
    st, _ = engine.simulate(st, cfg, 3)
    wc = broadphase.world_colliders(st)
    bb, _, _ = grid.grid_broadphase(st, wc, cfg)
    k = npk.box_box_slots_cuda(st.boxes, wc, bb)
    p = npk.box_box_slots_plain(st.boxes, wc, bb)
    torch.cuda.synchronize()
    for key in ("point_valid", "feat", "body_a", "body_b"):
        assert torch.equal(k[key], p[key]), key
    pv = p["point_valid"]
    assert int(pv.sum()) > 100
    _close(k["pos"][pv], p["pos"][pv], "pos")
    _close(k["depth"][pv], p["depth"][pv], "depth")
    _close(k["normal"][pv.any(1)], p["normal"][pv.any(1)], "normal")
    _close(k["friction"], p["friction"], "friction")


@pytest.mark.parametrize("max_colors", [24, 2])
def test_setup_and_solve_kernels_match_twins(dev, max_colors):
    cfg, st = _pressed_pile(300, dev, broadphase="grid",
                            max_colors=max_colors)
    st, _ = engine.simulate(st, cfg, 3)        # warm caches
    bodies, man, warm, pwarm, col = _stage_inputs(cfg, st)
    kcon, kvelw, kacc = setup_kernel.setup_cuda(bodies, man, warm, cfg, col,
                                                pwarm)
    tcon, tvelw, tacc = setup_kernel.setup_plain(bodies, man, warm, cfg, col,
                                                 pwarm)
    torch.cuda.synchronize()
    for f in dataclasses.fields(solver.ContactConstraints):
        _close(getattr(kcon, f.name), getattr(tcon, f.name), f.name)
    _close(kvelw, tvelw, "velw")
    for a, b in zip(kacc, tacc):
        _close(a, b, "acc")
    kv, ka, kp = solver_kernel.solve_cuda(kvelw, kcon, kacc, cfg)
    tv, ta, tp = solver_kernel.solve_plain(kvelw, kcon, kacc, cfg)
    torch.cuda.synchronize()
    _close(kv, tv, "solved velw")
    for a, b in zip(ka + (kp,), ta + (tp,)):
        _close(a, b, "solved acc")
    if max_colors == 2:
        assert int(col[3]) > 0


def test_engine_on_cuda_launches_every_kernel_and_repeats(dev):
    cfg, st0 = _pressed_pile(200, dev, broadphase="grid")
    counters = (npk.box_box_slots, setup_kernel.setup, solver_kernel.solve)
    before = [c.launches for c in counters]
    a, ma = engine.simulate(st0, cfg, 5)
    b, mb = engine.simulate(st0, cfg, 5)
    torch.cuda.synchronize()
    assert all(c.launches >= n + 10 for c, n in zip(counters, before))
    for f in ("pos", "quat", "vel", "angvel"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f
    assert not bool(ma.overflow.any())
    # and the CPU twins agree with the card over the same steps
    c, _ = engine.simulate(
        dataclasses.replace(st0, **{
            g: dataclasses.replace(getattr(st0, g), **{
                f.name: getattr(getattr(st0, g), f.name).cpu()
                for f in dataclasses.fields(getattr(st0, g))})
            for g in ("bodies", "boxes", "spheres", "cache", "sleep",
                      "colors")},
            connections=st0.connections.cpu(),
            step_count=st0.step_count.cpu()), cfg, 5)
    np.testing.assert_allclose(a.bodies.pos.cpu().numpy(),
                               c.bodies.pos.numpy(), rtol=0, atol=1e-4)
