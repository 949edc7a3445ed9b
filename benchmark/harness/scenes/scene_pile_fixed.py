"""BASELINE config 4's scene at the scene seed the configuration names
(`scene_seed`), whatever the run's seed: `scene_pile.build` and
`scene_pile.spawn` of `scenes.scene_pile(n_bodies, scene_seed)`.

For a cell whose episodes start from a state the pile settles into: each
spawn settles differently (how much of it still moves, rebuilds and sleeps
at a given awake share), so every run steps one published scene and the
runs differ only in the program's own noise.

    build(params, sim, seed, device) -> System
    spawn(params, seed, cfg, device) -> the reference's start, {name: tensor}
"""

from __future__ import annotations

from harness import registry, system

scene_pile = registry.load_module(system.SCENES, "scene_pile")


def build(params: dict, sim: dict, seed: int, device):
    return scene_pile.build(_pile(params), sim, params["scene_seed"], device)


def spawn(params: dict, seed: int, cfg, device) -> dict:
    return scene_pile.spawn(_pile(params), params["scene_seed"], cfg, device)


def _pile(params: dict) -> dict:
    return {k: v for k, v in params.items() if k != "scene_seed"}
