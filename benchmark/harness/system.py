"""The system under test as a configuration builds it: the spawn state on
the card, its `SimConfig`, and the counts a rate is taken over.

A configuration file (`configs/<name>.json`) names its scene builder
(`scene.builder`, a module in `harness/scenes/`) with the builder's
parameters, and the `SimConfig` settings it runs with (`sim`).
"""

from __future__ import annotations

from pathlib import Path

from harness import registry

SCENES = Path(__file__).resolve().parent / "scenes"


class System:
    """`state`: the spawn state (a stack of chunks when `chunks` is set);
    `cfg`: its SimConfig; `n_dynamic`: the dynamic bodies a step moves,
    over every chunk."""

    def __init__(self, state, cfg, n_dynamic: int, chunks: int = None):
        self.state, self.cfg = state, cfg
        self.n_dynamic, self.chunks = n_dynamic, chunks


def builder(config: dict):
    return registry.load_module(SCENES, config["scene"]["builder"])


def build(config: dict, seed: int, device) -> System:
    """The configuration's spawn state from `seed` on `device`."""
    scene = config["scene"]
    params = {k: v for k, v in scene.items() if k != "builder"}
    return builder(config).build(params, dict(config["sim"]), seed, device)


def reference_spawn(config: dict, seed: int, cfg, device) -> dict:
    """The reference's own build of the same spawn ({name: tensor})."""
    scene = config["scene"]
    params = {k: v for k, v in scene.items() if k != "builder"}
    return builder(config).spawn(params, seed, cfg, device)
