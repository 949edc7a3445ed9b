"""Scene batching (PyTorch port of `nudge_tpu.parallel.mesh`).

A batch is a SimState (or any tree of `state.tree_map`) with a leading
scene or chunk axis on every leaf: `make_scene_batch` stacks states,
`scenes.scene_pile_stacked` and `scenes.scene_pile_megachunks` build one on
the device. BASELINE config 5 runs 4,096 scenes of 512 bodies as 128 chunks
(flattened mega-scenes) of 32 scenes (`megabatch_simulate`).

`torch.vmap` cannot trace the hand-written kernels, so every function here
runs the unbatched `engine.step` on one scene or chunk at a time, on views
of the batch's leaves, and writes the result back into the batch it
returns: what the reference's `lax.map` body does for megachunks. A
scene's step reads and writes nothing of another scene's arrays, so each
scene's trajectory is the one it has alone, bit for bit, and a chunked
variant equals the unchunked one bit for bit. Each scene runs all of a
call's steps before the next starts (the reference maps scenes inside its
scan over steps; the results are the same).

The kernels read the views in place: a view starts at a multiple of its
leaf's per-scene size, 4-byte aligned, and every kernel reads body and
collider arrays one element at a time; what a kernel reads or writes as
16-byte words it allocates itself (setup's velw and rows, the narrowphase
slots), and its wrapper checks that alignment.

`donate` is kept for the reference's signatures and has no effect: each
function returns a new batch and leaves its input as it was.
Multi-device sharding (`shard_scene_batch`, `megabatch_simulate(mesh=)`)
is not ported yet (ROADMAP Queue 1): it needs a second device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from ..engine import StepMetrics, step
from ..state import tree_map

SCENE_AXIS = "scenes"
_SHARDING = ("multi-device sharding is not ported yet (ROADMAP Queue 1: it "
             "needs a second device)")


def make_scene_batch(states):
    """Stack a list of same-config states into one batch (leading scene
    axis on every leaf)."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *states)


def shard_scene_batch(state_b, mesh):
    """Place a batch on a device mesh: not ported yet."""
    raise NotImplementedError(f"shard_scene_batch: {_SHARDING}")


def _batch_size(state_b) -> int:
    return state_b.bodies.pos.shape[0]


def take(state_b, i: int):
    """Scene (or chunk) i of a batch, as views of the batch's leaves."""
    return tree_map(lambda x: x[i], state_b)


def _put(state_b, i: int, state):
    """Write `state` into scene i of `state_b`, in place. A leaf the step
    left as it was is the batch's own view and is not copied."""
    def copy(dst, src):
        d = dst[i]
        if not (d.data_ptr() == src.data_ptr() and d.stride() == src.stride()):
            d.copy_(src)
        return dst

    tree_map(copy, state_b, state)


def _stack_metrics(ms, dim=0):
    return StepMetrics(**{f.name: torch.stack([getattr(m, f.name) for m in ms],
                                              dim)
                          for f in dataclasses.fields(StepMetrics)})


def _rollout(cfg: SimConfig, state_b, steps: int, every_step: bool):
    """Each scene of a copy of `state_b` stepped `steps` times, written
    back. Returns (batch, metrics): [steps, scenes] fields with
    `every_step`, else the last step's [scenes]."""
    out = tree_map(torch.clone, state_b)
    per_scene = []
    for i in range(_batch_size(out)):
        st = take(out, i)
        ms = []
        for _ in range(steps):
            st, m = step(st, cfg)
            ms.append(m)
        _put(out, i, st)
        per_scene.append(_stack_metrics(ms) if every_step else ms[-1])
    return out, _stack_metrics(per_scene, 1 if every_step else 0)


def _check_chunks(state_b, n_chunks: int):
    n = _batch_size(state_b)
    if n % n_chunks:
        raise ValueError(f"{n} scenes do not split into {n_chunks} chunks")


def batched_step(cfg: SimConfig, donate: bool = True):
    """One step of every scene of a batch: fn(batch) -> (batch,
    StepMetrics with [scenes] fields)."""
    return lambda state_b: _rollout(cfg, state_b, 1, False)


def batched_step_chunked(cfg: SimConfig, n_chunks: int, donate: bool = True):
    """`batched_step` over `n_chunks` sequential chunks of the scene axis
    (the scene count must divide). The reference chunks to bound the
    transient memory of vmap(step); here every scene steps alone anyway, so
    the result is `batched_step`'s, bit for bit."""
    def run(state_b):
        _check_chunks(state_b, n_chunks)
        return _rollout(cfg, state_b, 1, False)

    return run


def batched_simulate(cfg: SimConfig, steps: int, donate: bool = True):
    """Multi-step rollout of a batch: fn(batch) -> (batch, StepMetrics with
    [steps, scenes] fields)."""
    return lambda state_b: _rollout(cfg, state_b, steps, True)


def megabatch_simulate(cfg: SimConfig, steps: int, donate: bool = True,
                       mesh=None):
    """Multi-step rollout of a stack of flattened mega-scenes
    (`scenes.scene_pile_megachunks`): the unbatched step, and so the
    kernels, on one chunk at a time. fn(stack) -> (stack, final-step
    StepMetrics with [chunks] fields). `mesh` (the chunk axis split over
    devices) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(f"megabatch_simulate(mesh=...): {_SHARDING}")
    return lambda state_b: _rollout(cfg, state_b, steps, False)


def batched_simulate_chunked(cfg: SimConfig, steps: int, n_chunks: int,
                             donate: bool = True):
    """Multi-step rollout over `n_chunks` sequential chunks of the scene
    axis (see batched_step_chunked): fn(batch) -> (batch, final-step
    StepMetrics with [scenes] fields)."""
    def run(state_b):
        _check_chunks(state_b, n_chunks)
        return _rollout(cfg, state_b, steps, False)

    return run
