"""The plain reference is the port's plain step, bit for bit, on the CPU,
and rebuilds the port's spawn scenes from the seed."""

import torch
import tiny_bench  # noqa: F401

from reference import spawn, tree
from reference import step as ref_step


def _pile(n, seed):
    from nudge_tpu_torch import scenes

    b = scenes.scene_pile(n, seed=seed)
    cfg = b.auto_config(max_box_box_pairs=8 * n, max_manifolds=3 * n,
                        grid_density=16, fat_pair_factor=2, broadphase="grid")
    return b, cfg


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
            port = dict(tree.leaves(tree.from_fields(nxt)))
            for name, v in tree.leaves(r):
                assert torch.equal(v, port[name]), (k, name)
            for name, v in vars(rm).items():
                assert torch.equal(v, getattr(m, name)), (k, name)
            checked += int(m.contact_count)
        st = nxt
    assert checked > 100          # the pile is in contact by then


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
        for name, v in spawn.pile(n, seed, cfg, "cpu").items():
            assert torch.equal(v, port[name]), (n, name)
    stack, cfg = scenes.scene_pile_megachunks(2, 4, 8, seed=11, device="cpu")
    port = dict(tree.leaves(tree.from_fields(stack)))
    for name, v in spawn.pile_chunks(2, 4, 8, 11, cfg, "cpu").items():
        assert torch.equal(v, port[name]), name
