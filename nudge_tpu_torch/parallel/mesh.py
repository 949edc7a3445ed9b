"""Scene batching and multi-device sharding (PyTorch port of
`nudge_tpu.parallel.mesh`).

A batch is a SimState (or any tree of `state.tree_map`) with a leading
scene or chunk axis on every leaf: `make_scene_batch` stacks states,
`scenes.scene_pile_stacked` and `scenes.scene_pile_megachunks` build one on
the device. BASELINE config 5 runs 4,096 scenes of 512 bodies as 128 chunks
(flattened mega-scenes) of 32 scenes (`megabatch_simulate`).

`torch.vmap` cannot trace the hand-written kernels, so every function here
runs the unbatched step on one scene or chunk at a time and writes the
result into the batch it returns: what the reference's `lax.map` body does
for megachunks. On the card that is the step captured once as a CUDA graph
(`control.compiled`): every scene or chunk of a batch has the same shapes,
so one graph serves them all; it copies the scene in, replays, and copies
it out. On the CPU it is the eager `engine.step` on views of the batch's
leaves. A batch that carries a gradient goes a scene at a time through
`engine.simulate` (in the differentiable mode one `_RolloutFn` node a
scene, compiled in both directions on the card). A
scene's step reads and writes nothing of another scene's arrays, so each
scene's trajectory is the one it has alone, bit for bit, and a chunked
variant equals the unchunked one bit for bit. Each scene runs all of a
call's steps before the next starts (the reference maps scenes inside its
scan over steps; the results are the same).

The step takes a scene's views (`take`) as they are: a view starts at a
multiple of its leaf's per-scene size, 4-byte aligned, and every kernel reads body and
collider arrays one element at a time; what a kernel reads or writes as
16-byte words it allocates itself (setup's velw and rows, the narrowphase
slots), and its wrapper checks that alignment.

`donate` is kept for the reference's signatures and has no effect: each
function returns a new batch and leaves its input as it was. When a leaf
of the batch requires grad (the differentiable mode), the scenes' results
are stacked into a new batch instead of written into a copy, so autograd
sees no saved tensor change; the values are the same, bit for bit.

Sharding, as the reference's `NamedSharding` over a `Mesh`: one process a
rank over `torch.distributed` (NCCL with a card a rank, gloo on the CPU),
and a 1-D `DeviceMesh` named SCENE_AXIS (`scene_mesh`).
`shard_scene_batch` turns every leaf into a `DTensor` placed `Shard(0)`
on the mesh (a 0-d leaf `Replicate()`, as the reference's `P()`), each
rank holding its contiguous range of scenes or chunks; the mesh size must
divide the batch. Every batched function takes such a batch and returns
one with the same placement: it takes each leaf's local part, steps the
rank's scenes or chunks as above, and wraps the results (state and
metrics) as `Shard` on the scene axis again. Scenes are independent, so
nothing is exchanged while stepping, as the reference's shard_map
generates no collectives. No DTensor reaches `engine.step` or a kernel:
the kernels read raw pointers, and a DTensor's indexing would dispatch
collectives, so `_rollout` and `take` refuse one.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .. import control, trace
from ..config import SimConfig
from ..engine import StepMetrics, simulate, step
from ..state import flatten, tree_map

SCENE_AXIS = "scenes"


def scene_mesh(device: str = "cuda", backend: str = None,
               init_method: str = None, world_size: int = None,
               rank: int = None, timeout=None):
    """The 1-D device mesh over every rank of the default process group,
    its one dimension named SCENE_AXIS, creating the group if there is
    none (from `init_method`, `world_size` and `rank`, or from the
    environment `torchrun` sets). On the card each rank takes cuda:{local
    rank} (LOCAL_RANK, else the rank, modulo the cards present) and the
    group is NCCL; with device="cpu" it is gloo. `backend` overrides the
    choice (gloo over CUDA tensors lets several ranks share one card, which
    NCCL refuses)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(
            backend or ("nccl" if device == "cuda" else "gloo"),
            init_method=init_method, world_size=-1 if world_size is None
            else world_size, rank=-1 if rank is None else rank, **kw)
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device, (dist.get_world_size(),),
                            mesh_dim_names=(SCENE_AXIS,))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _leaves(tree):
    found = []
    tree_map(lambda x: found.append(x), tree)
    return found


def _mesh_of(state_b):
    """The mesh of a sharded batch (every leaf a DTensor on one mesh), or
    None for a batch of plain tensors."""
    leaves = _leaves(state_b)
    sharded = [x for x in leaves if _is_dtensor(x)]
    if not sharded:
        return None
    mesh = sharded[0].device_mesh
    if len(sharded) != len(leaves) or any(x.device_mesh != mesh
                                          for x in sharded):
        raise ValueError("a batch is sharded on one mesh leaf by leaf, or "
                         "not at all")
    return mesh
def make_scene_batch(states):
    """Stack a list of same-config states into one batch (leading scene
    axis on every leaf)."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *states)


def shard_scene_batch(state_b, mesh):
    """Place a batch on `mesh`, scene axis split over SCENE_AXIS: every
    leaf a DTensor, `Shard(0)` (a 0-d leaf `Replicate()`), this rank's part
    its contiguous range of scenes, on the mesh's device. Every rank passes
    the same batch; nothing is exchanged. A batch already sharded on
    `mesh` is returned as it is."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"shard_scene_batch: a DeviceMesh ({SCENE_AXIS!r}: "
                        f"scene_mesh), not {type(mesh).__name__}")
    on = _mesh_of(state_b)
    if on is not None:
        if on != mesh:
            raise ValueError("the batch is sharded on another mesh")
        return state_b
    if mesh.mesh_dim_names != (SCENE_AXIS,):
        raise ValueError(f"the mesh must be 1-D, named ({SCENE_AXIS!r},)")
    n, size = _batch_size(state_b), mesh.size()
    if n % size:
        raise ValueError(f"{n} scenes do not split over a mesh of {size}")
    lo = mesh.get_local_rank(SCENE_AXIS) * (n // size)
    dev = mesh.device_type

    def put(x):
        if x.ndim == 0:
            return DTensor.from_local(x.to(dev), mesh, [Replicate()],
                                      run_check=False)
        return DTensor.from_local(x[lo:lo + n // size].to(dev).contiguous(),
                                  mesh, [Shard(0)], run_check=False)

    return tree_map(put, state_b)


def local_batch(state_b):
    """This rank's part of a sharded batch, as plain tensors (a batch of
    plain tensors is returned as it is)."""
    return tree_map(lambda x: x.to_local() if _is_dtensor(x) else x, state_b)


def _batch_size(state_b) -> int:
    return state_b.bodies.pos.shape[0]


def _refuse_dtensors(state_b, where: str):
    if any(_is_dtensor(x) for x in _leaves(state_b)):
        raise TypeError(f"{where}: a sharded batch (DTensor leaves) never "
                        "reaches the step or the kernels; take its "
                        "local_batch first")


def take(state_b, i: int):
    """Scene (or chunk) i of a batch of plain tensors, as views of the
    batch's leaves."""
    _refuse_dtensors(state_b, "take")
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


def _requires_grad(state_b) -> bool:
    found = []
    tree_map(lambda x: found.append(x.requires_grad), state_b)
    return torch.is_grad_enabled() and any(found)


def _rollout(cfg: SimConfig, state_b, steps: int, every_step: bool):
    """Each scene of `state_b` stepped `steps` times, into a new batch.
    Returns (batch, metrics): [steps, scenes] fields with `every_step`,
    else the last step's [scenes]. On the card every scene goes through
    one captured step (`control.compiled`: the scenes share its shapes):
    the scene is copied into the graph's inputs, replayed `steps` times and
    copied out into the new batch. When the batch carries a gradient each
    scene is one `engine.simulate` (in the differentiable mode one
    `_RolloutFn` node, compiled in both directions on the card) and the
    results are stacked anew. On the CPU without one the eager step runs
    on views of a copy. Traced (trace.py), the card's loop is a span
    with one a scene for its load, its replays and its store."""
    _refuse_dtensors(state_b, "_rollout")
    dim = 1 if every_step else 0

    def kept(m):
        return m if every_step else tree_map(lambda x: x[-1], m)

    if _requires_grad(state_b):
        stepped, per_scene = [], []
        for i in range(_batch_size(state_b)):
            st, m = simulate(take(state_b, i), cfg, steps)
            stepped.append(st)
            per_scene.append(kept(m))
        return make_scene_batch(stepped), _stack_metrics(per_scene, dim)

    out = tree_map(torch.empty_like if state_b.bodies.pos.is_cuda
                   else torch.clone, state_b)
    per_scene = []
    if state_b.bodies.pos.is_cuda:
        with trace.span("mesh_rollout"):
            graph = control.compiled(step, cfg, take(state_b, 0))
            graph.start()
            for i in range(_batch_size(out)):
                with trace.span("load"):
                    graph.load(take(state_b, i))
                with trace.span("replay"):
                    per_scene.append(kept(graph.replay(steps)))
                with trace.span("store"):
                    graph.store(flatten(take(out, i))[0])
            with trace.span("finish"):
                graph.finish()
            return out, _stack_metrics(per_scene, dim)

    for i in range(_batch_size(out)):
        st = take(out, i)
        ms = []
        for _ in range(steps):
            st, m = step(st, cfg)
            ms.append(m)
        _put(out, i, st)
        per_scene.append(kept(_stack_metrics(ms)))
    return out, _stack_metrics(per_scene, dim)


def _sharded(run, scene_dim: int):
    """`run` (batch -> (batch, metrics)) on a batch of plain tensors, or on
    this rank's part of a sharded one, whose results it wraps as `Shard`
    on the same mesh: the state on dim 0, the metrics on `scene_dim` (their
    scene axis)."""
    def call(state_b):
        mesh = _mesh_of(state_b)
        if mesh is None:
            return run(state_b)
        from torch.distributed.tensor import DTensor, Shard

        out, metrics = run(local_batch(state_b))

        def wrap(dim):
            return lambda x: DTensor.from_local(
                x, mesh, [Shard(dim)], run_check=False)

        return (tree_map(wrap(0), out),
                tree_map(wrap(scene_dim), metrics))

    return call


def _check_chunks(state_b, n_chunks: int):
    n = _batch_size(state_b)
    if n % n_chunks:
        raise ValueError(f"{n} scenes do not split into {n_chunks} chunks")


def batched_step(cfg: SimConfig, donate: bool = True):
    """One step of every scene of a batch (sharded or not): fn(batch) ->
    (batch, StepMetrics with [scenes] fields)."""
    return _sharded(lambda state_b: _rollout(cfg, state_b, 1, False), 0)


def batched_step_chunked(cfg: SimConfig, n_chunks: int, donate: bool = True):
    """`batched_step` over `n_chunks` sequential chunks of the scene axis
    (the scene count must divide). The reference chunks to bound the
    transient memory of vmap(step); here every scene steps alone anyway, so
    the result is `batched_step`'s, bit for bit."""
    step_all = _sharded(lambda state_b: _rollout(cfg, state_b, 1, False), 0)

    def run(state_b):
        _check_chunks(state_b, n_chunks)
        return step_all(state_b)

    return run


def batched_simulate(cfg: SimConfig, steps: int, donate: bool = True):
    """Multi-step rollout of a batch (sharded or not): fn(batch) -> (batch,
    StepMetrics with [steps, scenes] fields)."""
    return _sharded(lambda state_b: _rollout(cfg, state_b, steps, True), 1)


def megabatch_simulate(cfg: SimConfig, steps: int, donate: bool = True,
                       mesh=None):
    """Multi-step rollout of a stack of flattened mega-scenes
    (`scenes.scene_pile_megachunks`): the unbatched step, and so the
    kernels, on one chunk at a time. fn(stack) -> (stack, final-step
    StepMetrics with [chunks] fields). With `mesh` the chunk axis is split
    over SCENE_AXIS (`shard_scene_batch`: a stack of plain tensors is
    sharded first, and the mesh size must divide the chunk count) and each
    rank loops over its local chunks, as the reference's shard_map does;
    the stack and the metrics come back sharded."""
    run = _sharded(lambda state_b: _rollout(cfg, state_b, steps, False), 0)
    if mesh is None:
        return run
    return lambda state_b: run(shard_scene_batch(state_b, mesh))


def batched_simulate_chunked(cfg: SimConfig, steps: int, n_chunks: int,
                             donate: bool = True):
    """Multi-step rollout over `n_chunks` sequential chunks of the scene
    axis (see batched_step_chunked): fn(batch) -> (batch, final-step
    StepMetrics with [scenes] fields)."""
    run_all = _sharded(lambda state_b: _rollout(cfg, state_b, steps, False),
                       0)

    def run(state_b):
        _check_chunks(state_b, n_chunks)
        return run_all(state_b)

    return run
