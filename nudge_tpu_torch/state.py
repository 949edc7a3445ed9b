"""Simulation state containers (PyTorch port of `nudge_tpu.state`).

The JAX package keeps all state in `flax.struct` pytrees of fixed-capacity
padded arrays. Here the same fields live in plain dataclasses of tensors
with a `.replace`, and every tensor of a state sits on one device: the one
of `state.bodies.pos`. Padding conventions are the reference's:

  - padded bodies have inv_mass == 0 and no colliders referencing them;
  - padded colliders have body == -1;
  - padded cache rows / connections have valid == False / body == -1.

A batch of states (`parallel.mesh`, `scenes.scene_pile_stacked`) is the
same dataclass with a leading scene or chunk axis on every leaf;
`tree_map` maps over the leaves of one or more such trees.

`state_from_numpy` / `state_to_numpy` carry a state across as a nested dict
of numpy arrays, so the JAX package and this one can step the same state,
one state or a batch. The persistent-broadphase cache (`bp`) is carried
without the reference's tight-list memo fields, which the port does not
model (ops/persistent_bp).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig
from .mathx import quat_identity


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Bodies(_Replace):
    pos: torch.Tensor          # f32[N,3] world position
    quat: torch.Tensor         # f32[N,4] world orientation (x,y,z,w)
    vel: torch.Tensor          # f32[N,3]
    angvel: torch.Tensor       # f32[N,3] world frame
    inv_mass: torch.Tensor     # f32[N]   0 => static
    inv_inertia: torch.Tensor  # f32[N,3] diagonal, body frame

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    @property
    def dynamic(self) -> torch.Tensor:
        return self.inv_mass > 0.0


@dataclasses.dataclass
class Boxes(_Replace):
    body: torch.Tensor       # i32[B]; -1 => unused slot
    half: torch.Tensor       # f32[B,3]
    lpos: torch.Tensor       # f32[B,3]
    lquat: torch.Tensor      # f32[B,4]
    friction: torch.Tensor   # f32[B]
    tag: torch.Tensor        # i32[B]

    @property
    def valid(self) -> torch.Tensor:
        return self.body >= 0


@dataclasses.dataclass
class Spheres(_Replace):
    """Sphere colliders. A config without spheres keeps the reference's
    single padding slot (body -1)."""

    body: torch.Tensor       # i32[S]
    radius: torch.Tensor     # f32[S]
    lpos: torch.Tensor       # f32[S,3]
    friction: torch.Tensor   # f32[S]
    tag: torch.Tensor        # i32[S]

    @property
    def valid(self) -> torch.Tensor:
        return self.body >= 0


@dataclasses.dataclass
class ContactCache(_Replace):
    """Warm-start impulses keyed by (gid_a, gid_b, feature)."""

    ga: torch.Tensor        # i32[C]
    gb: torch.Tensor        # i32[C]
    feat: torch.Tensor      # i32[C]
    impulse: torch.Tensor   # f32[C,3] accumulated world-space impulse
    pseudo: torch.Tensor    # f32[C] accumulated pseudo normal impulse
    valid: torch.Tensor     # bool[C]


@dataclasses.dataclass
class SleepState(_Replace):
    idle: torch.Tensor    # i32[N]
    awake: torch.Tensor   # bool[N]
    pairs: torch.Tensor   # i32[K,2] parked sleeping pairs (-1 pad)


@dataclasses.dataclass
class ColorCache(_Replace):
    """Last frame's manifold coloring keyed by (gid_a, gid_b)."""

    ga: torch.Tensor        # i32[M]
    gb: torch.Tensor        # i32[M]
    color: torch.Tensor     # i32[M]
    valid: torch.Tensor     # bool[M]
    dynbits: torch.Tensor   # i32[M] bit0 side a dynamic, bit1 side b


@dataclasses.dataclass
class SimState(_Replace):
    bodies: Bodies
    boxes: Boxes
    spheres: Spheres
    cache: ContactCache
    sleep: SleepState
    bp: "BPCache"              # persistent broadphase cache (ops/persistent_bp)
    colors: ColorCache
    connections: torch.Tensor  # i32[K,2] suppressed body pairs; -1 pad
    step_count: torch.Tensor   # i32 scalar

    @property
    def device(self) -> torch.device:
        return self.bodies.pos.device


_F32, _I32 = torch.float32, torch.int32


def tree_map(fn, *trees):
    """`fn` applied leaf by leaf over trees of one structure (nested
    dataclasses of tensors; None leaves stay None), in the first tree's
    structure."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if t0 is None:
        return None
    return fn(*trees)


def flatten(tree):
    """(the tensor leaves of `tree`, in order; a function that rebuilds the
    tree from such a list). `tree` nests dataclasses, named tuples, tuples
    and lists; other leaves are kept as they are. An autograd Function
    saves a tree's tensors with `ctx.save_for_backward(*leaves)`, so that
    an in-place write to one before the backward raises."""
    leaves = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return lambda it: next(it)
        if dataclasses.is_dataclass(t):
            parts = [(f.name, walk(getattr(t, f.name)))
                     for f in dataclasses.fields(t)]
            return lambda it: dataclasses.replace(
                t, **{name: part(it) for name, part in parts})
        if isinstance(t, (tuple, list)):
            parts = [walk(x) for x in t]
            if hasattr(t, "_fields"):
                return lambda it: type(t)(*[part(it) for part in parts])
            return lambda it: type(t)(part(it) for part in parts)
        return lambda it: t

    build = walk(tree)
    return leaves, lambda tensors: build(iter(tensors))


def empty_color_cache(cfg: SimConfig, device="cuda") -> ColorCache:
    m = cfg.max_manifolds
    z = torch.zeros((m,), dtype=_I32, device=device)
    return ColorCache(ga=z, gb=z.clone(), color=z.clone(),
                      valid=torch.zeros((m,), dtype=torch.bool, device=device),
                      dynbits=z.clone())


def empty_cache(cfg: SimConfig, device="cuda") -> ContactCache:
    c = cfg.cache_capacity
    return ContactCache(
        ga=torch.zeros((c,), dtype=_I32, device=device),
        gb=torch.zeros((c,), dtype=_I32, device=device),
        feat=torch.zeros((c,), dtype=_I32, device=device),
        impulse=torch.zeros((c, 3), dtype=_F32, device=device),
        pseudo=torch.zeros((c,), dtype=_F32, device=device),
        valid=torch.zeros((c,), dtype=torch.bool, device=device),
    )


def empty_state(cfg: SimConfig, device="cuda") -> SimState:
    """All-padding state at capacity; fill via scenes.SceneBuilder."""
    from .ops.persistent_bp import empty_bp_cache

    n, b, s = cfg.max_bodies, cfg.max_boxes, max(cfg.max_spheres, 1)
    k = cfg.max_connections

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return SimState(
        bodies=Bodies(
            pos=full((n, 3), 0.0, _F32), quat=quat_identity((n,), device),
            vel=full((n, 3), 0.0, _F32), angvel=full((n, 3), 0.0, _F32),
            inv_mass=full((n,), 0.0, _F32),
            inv_inertia=full((n, 3), 0.0, _F32),
        ),
        boxes=Boxes(
            body=full((b,), -1, _I32), half=full((b, 3), 1.0, _F32),
            lpos=full((b, 3), 0.0, _F32), lquat=quat_identity((b,), device),
            friction=full((b,), cfg.friction, _F32), tag=full((b,), 0, _I32),
        ),
        spheres=Spheres(
            body=full((s,), -1, _I32), radius=full((s,), 1.0, _F32),
            lpos=full((s, 3), 0.0, _F32),
            friction=full((s,), cfg.friction, _F32), tag=full((s,), 0, _I32),
        ),
        cache=empty_cache(cfg, device),
        sleep=SleepState(
            idle=full((n,), 0, _I32),
            awake=full((n,), True, torch.bool),
            pairs=full((cfg.max_manifolds, 2), -1, _I32),
        ),
        bp=empty_bp_cache(cfg, n, device),
        colors=empty_color_cache(cfg, device),
        connections=full((k, 2), -1, _I32),
        step_count=full((), 0, _I32),
    )


# ---------------------------------------------------------------------------
# numpy bridge
# ---------------------------------------------------------------------------

def _groups():
    from .ops.persistent_bp import BPCache

    return {"bodies": Bodies, "boxes": Boxes, "spheres": Spheres,
            "cache": ContactCache, "sleep": SleepState, "bp": BPCache,
            "colors": ColorCache}


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def state_from_numpy(tree: dict, device) -> SimState:
    """SimState from a nested dict of numpy arrays laid out like the JAX
    package's SimState (`{"bodies": {"pos": ...}, ..., "step_count": ...}`),
    with or without a leading batch axis on every array. Keys the port does
    not model (the tight-list memo of the JAX `bp`) are ignored."""
    kw = {}
    for name, cls in _groups().items():
        sub = tree[name]
        kw[name] = cls(**{f.name: _to_tensor(sub[f.name], device)
                          for f in dataclasses.fields(cls)})
    kw["connections"] = _to_tensor(tree["connections"], device)
    kw["step_count"] = _to_tensor(tree["step_count"], device)
    return SimState(**kw)


def state_to_numpy(state: SimState) -> dict:
    """Nested dict of numpy arrays, the inverse of `state_from_numpy`."""
    out = {}
    for name in _groups():
        sub = getattr(state, name)
        out[name] = {f.name: getattr(sub, f.name).detach().cpu().numpy()
                     for f in dataclasses.fields(sub)}
    out["connections"] = state.connections.cpu().numpy()
    out["step_count"] = state.step_count.cpu().numpy()
    return out
