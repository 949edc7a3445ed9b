"""nudge_tpu_torch — the PyTorch/CUDA port of the nudge_tpu rigid-body engine.

The JAX package `nudge_tpu` is the reference. This package runs its box
and sphere piles, awake or in the reference mode (sleeping + persistent
broadphase), in PyTorch: plain tensor code everywhere, and hand-written
CUDA kernels (csrc/) for both narrowphases, the claim rounds of the fresh
and the cached coloring, the constraint setup and the iterated solve
whenever the state lives on a CUDA device. On CPU tensors each kernel's
plain PyTorch twin runs instead. `parallel.mesh` steps batches of scenes
(BASELINE config 5), `api` is the nudge-parity function set and `envs`
the RL environments.
"""

from .config import SimConfig
from .scenes import SceneBuilder
from .state import (
    Bodies, Boxes, ContactCache, SimState, SleepState, Spheres, empty_state,
    state_from_numpy, state_to_numpy,
)

__all__ = [
    "SimConfig", "SimState", "Bodies", "Boxes", "Spheres", "ContactCache",
    "SleepState", "empty_state", "SceneBuilder", "state_from_numpy",
    "state_to_numpy",
]
