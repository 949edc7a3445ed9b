"""A run whose timed path is broken underneath comes out not correct: a
step that returns its state unchanged, an answer altered where the step
produces it, half of a batch left unstepped. Each drives the whole run
(set-up, window, check) on the CPU at a tiny size, past the look for a
card; in the gradient cell also an adjoint altered where the backward
step produces it; in the reference mode also a body woken or put to
sleep against the reference, a sleeper given a velocity, and a parked
step that moves a body. A four-chip exchange has no fault to plant: no
cell runs on more than one card."""

import pytest
import tiny_bench

CELLS = ("tiny.rollout", "tiny.frames", "tinyb.rollout", "tiny.grad",
         "tinyr.rollout")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench.make(tmp_path_factory.mktemp("bench"))


def _patch_step(monkeypatch, fn):
    from nudge_tpu_torch import engine
    from nudge_tpu_torch.parallel import mesh

    real = engine.step

    def broken(state, cfg):
        return fn(real, state, cfg)

    vars(broken).update(vars(real))    # the step's counter of parked steps
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


def test_reference_mode_runs_every_kind_of_step(bench, monkeypatch):
    """The tiny reference-mode cell's sound run holds a fat rebuild, a
    refilter and a parked step, and comes out correct."""
    from nudge_tpu_torch import engine
    from nudge_tpu_torch.ops import persistent_bp

    steps = []
    _patch_step(monkeypatch, lambda real, s, cfg: (steps.append(1),
                                                   real(s, cfg))[1])
    parked0 = engine.step.parked
    rebuilds0 = persistent_bp.persistent_broadphase.rebuilds
    result = tiny_bench.run(*bench, "tinyr.rollout")
    parked = engine.step.parked - parked0
    rebuilds = persistent_bp.persistent_broadphase.rebuilds - rebuilds0
    assert result["correct"], result["limits"]
    assert parked >= 1 and rebuilds >= 1
    assert len(steps) - parked - rebuilds >= 1      # refilter steps


def _first(mask):
    return int(mask.nonzero()[0, 0])


def _woken(real, s, cfg):
    """Body 1's sleep flag flipped against the step's own."""
    out, m = real(s, cfg)
    awake = out.sleep.awake.clone()
    awake[1] = ~awake[1]
    return out.replace(sleep=out.sleep.replace(awake=awake)), m


def _sleeper_moving(real, s, cfg):
    """A sleeper's velocity raised by 0.1 m/s."""
    out, m = real(s, cfg)
    asleep = out.bodies.dynamic & ~out.sleep.awake
    if not bool(asleep.any()):
        return out, m
    vel = out.bodies.vel.clone()
    vel[_first(asleep), 0] += 0.1
    return out.replace(bodies=out.bodies.replace(vel=vel)), m


def _parked_moves(real, s, cfg):
    """A parked step that lifts body 1 by 0.1 m."""
    out, m = real(s, cfg)
    if bool((s.bodies.dynamic & s.sleep.awake).any()):
        return out, m
    pos = out.bodies.pos.clone()
    pos[1, 1] += 0.1
    return out.replace(bodies=out.bodies.replace(pos=pos)), m


@pytest.mark.parametrize("fault", (_woken, _sleeper_moving, _parked_moves),
                         ids=("woken", "sleeper_moving", "parked_moves"))
def test_reference_mode_fault(bench, monkeypatch, fault):
    _patch_step(monkeypatch, fault)
    result = tiny_bench.run(*bench, "tinyr.rollout")
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
