"""nudge_tpu_torch — the PyTorch/CUDA port of the nudge_tpu rigid-body engine.

The JAX package `nudge_tpu` is the reference. This package runs its default
box-pile path in PyTorch: plain tensor code everywhere, and hand-written
CUDA kernels (csrc/) for the box-box narrowphase, the constraint setup and
the iterated solve whenever the state lives on a CUDA device. On CPU tensors
each kernel's plain PyTorch twin runs instead.
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
