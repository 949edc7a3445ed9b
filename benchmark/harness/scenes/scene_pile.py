"""BASELINE config 4's scene: `scenes.scene_pile(n_bodies, seed)` with the
configuration's `sim` settings applied through `auto_config`.

    build(params, sim, seed, device) -> System
    spawn(params, seed, cfg, device) -> the reference's start, {name: tensor}
"""

from __future__ import annotations

from harness.system import System
from reference import spawn as ref_spawn


def build(params: dict, sim: dict, seed: int, device) -> System:
    from nudge_tpu_torch import scenes

    n = params["n_bodies"]
    b = scenes.scene_pile(n, seed=seed)
    cfg = b.auto_config(**sim)
    return System(b.finalize(cfg, device=device), cfg, n_dynamic=n)


def spawn(params: dict, seed: int, cfg, device) -> dict:
    return ref_spawn.pile(params["n_bodies"], seed, cfg, device)
