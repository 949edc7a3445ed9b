"""A run whose timed path is broken underneath comes out not correct: a
step that returns its state unchanged, an answer altered where the step
produces it, half of a batch left unstepped. Each drives the whole run
(set-up, window, check) on the CPU at a tiny size, past the look for a
card; in the gradient cell also an adjoint altered where the backward
step produces it. A four-chip exchange has no fault to plant: no cell
runs on more than one card."""

import pytest
import tiny_bench

CELLS = ("tiny.rollout", "tiny.frames", "tinyb.rollout", "tiny.grad")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench.make(tmp_path_factory.mktemp("bench"))


def _patch_step(monkeypatch, fn):
    from nudge_tpu_torch import engine
    from nudge_tpu_torch.parallel import mesh

    real = engine.step

    def broken(state, cfg):
        return fn(real, state, cfg)

    monkeypatch.setattr(engine, "step", broken)
    monkeypatch.setattr(mesh, "step", broken)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench, name):
    result = tiny_bench.run(*bench, name)
    assert result["correct"], result["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_state_returned_unchanged(bench, name, monkeypatch):
    _patch_step(monkeypatch, lambda real, s, cfg: (s, real(s, cfg)[1]))
    result = tiny_bench.run(*bench, name)
    assert not result["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced(bench, name, monkeypatch):
    def altered(real, s, cfg):
        out, m = real(s, cfg)
        pos = out.bodies.pos.clone()
        pos[..., 5, 1] += 0.1        # above every cell's position limit
        return out.replace(bodies=out.bodies.replace(pos=pos)), m

    _patch_step(monkeypatch, altered)
    result = tiny_bench.run(*bench, name)
    assert not result["correct"]


def test_half_the_batch_left_out(bench, monkeypatch):
    from nudge_tpu_torch.parallel import mesh
    from nudge_tpu_torch.state import tree_map

    real = mesh.megabatch_simulate

    def half(cfg, steps, **kw):
        run = real(cfg, steps, **kw)

        def call(stack):
            out, m = run(stack)
            k = stack.bodies.pos.shape[0] // 2
            return tree_map(lambda o, i: torch_cat(o[:k], i[k:]), out,
                            stack), m

        return call

    def torch_cat(a, b):
        import torch

        return torch.cat([a, b])

    monkeypatch.setattr(mesh, "megabatch_simulate", half)
    result = tiny_bench.run(*bench, "tinyb.rollout")
    assert not result["correct"]


def test_gradient_altered_where_produced(bench, monkeypatch):
    from nudge_tpu_torch import control

    real = control.GradStep._body

    def altered(self):
        real(self)
        for a in self.adj:
            if a is not None and a.dtype.is_floating_point:
                a.add_(1e-2 * a.abs().max())

    monkeypatch.setattr(control.GradStep, "_body", altered)
    result = tiny_bench.run(*bench, "tiny.grad")
    assert not result["correct"]
    assert result["limits"]["grad_gap_rel"][0] > \
        result["limits"]["grad_gap_rel"][1]
