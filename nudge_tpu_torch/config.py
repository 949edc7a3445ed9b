"""Static simulation configuration (PyTorch port of `nudge_tpu.config`).

Same field names and defaults as the JAX package, minus the two TPU-only
knobs: `xla_solver_max_bodies` (a guard against the TPU worker's execution
deadline) and `aligned_fast_path` (lax.cond shortcuts in the cache and
coloring joins). `solver` stays for parity but only "auto" is accepted: the
port picks the hand-written CUDA kernels or their plain PyTorch twins by the
device of the tensors it is given, never by a flag.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Contact points per manifold (box-box clip output is reduced to this many).
CONTACT_POINTS = 4


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All static knobs; see nudge_tpu.config.SimConfig for each one's story."""

    # --- capacities ---
    max_bodies: int = 64
    max_boxes: int = 64
    max_spheres: int = 0
    max_box_box_pairs: int = 256
    max_box_sphere_pairs: int = 0
    max_sphere_sphere_pairs: int = 0
    max_manifolds: int = 256
    max_connections: int = 0

    # --- time stepping ---
    dt: float = 1.0 / 60.0
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)

    # --- solver ---
    solver_iters: int = 20
    solver: str = "auto"
    max_colors: int = 24
    persistent_coloring: bool = True
    differentiable: bool = False
    baumgarte: float = 0.2
    slop: float = 0.005
    max_bias_vel: float = 2.0
    max_pseudo_vel: float = 10.0
    split_impulse: bool = True
    deep_bias_depth: float = 0.15
    deep_bias_gate: float = 0.3
    deep_bias_ungated_depth: float = 0.25
    deep_bias_ungated_vel: float = 0.5
    pseudo_friction: bool = True
    max_lin_vel: float = 0.0
    friction: float = 0.5
    restitution: float = 0.0
    warm_start: bool = True

    # --- broadphase ---
    aabb_margin: float = 0.02
    broadphase: str = "auto"
    grid_cell: float = 0.0
    grid_density: int = 24
    grid_table_dims: Tuple[int, int, int] = (128, 32, 128)
    max_big_colliders: int = 16
    grid_expand_cap: int = 0
    persistent_broadphase: bool = False
    rebuild_margin: float = 0.1
    fat_pair_factor: int = 3

    # --- sleeping ---
    sleeping: bool = False
    sleep_lin_vel: float = 0.05
    sleep_ang_vel: float = 0.10
    sleep_frames: int = 60
    island_sweeps: int = 8
    kill_plane_y: float = -1e9
    wake_factor: float = 4.0

    def __post_init__(self):
        if self.solver != "auto":
            raise ValueError(
                f"solver={self.solver!r}: the PyTorch port accepts only "
                "'auto' (kernels on CUDA tensors, plain twins on CPU tensors)")

    @property
    def num_colliders(self) -> int:
        return self.max_boxes + self.max_spheres

    @property
    def total_pairs(self) -> int:
        return (
            self.max_box_box_pairs
            + self.max_box_sphere_pairs
            + self.max_sphere_sphere_pairs
        )

    @property
    def cache_capacity(self) -> int:
        return self.max_manifolds * CONTACT_POINTS

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
