"""BASELINE config 5's scene: `n_chunks` chunks of `scenes_per_chunk`
independent piles of `bodies_per_scene` boxes, each chunk one flattened
scene (`scenes.scene_pile_batch`) on a leading chunk axis, decorrelated
on the device (`scenes.stack_jitter`, `apply_stack_jitter`), as
`scenes.scene_pile_megachunks` builds it. The configuration's `sim`
settings go through `auto_config`, and its grid table is grown to the
chunk's footprint (`scenes.cover_footprint`).

    build(params, sim, seed, device) -> System
    spawn(params, seed, cfg, device) -> the reference's start, {name: tensor}
"""

from __future__ import annotations

from harness.system import System
from reference import spawn as ref_spawn


def build(params: dict, sim: dict, seed: int, device) -> System:
    from nudge_tpu_torch import scenes

    n_chunks = params["n_chunks"]
    proto = scenes.scene_pile_batch(params["scenes_per_chunk"],
                                    params["bodies_per_scene"], seed=seed)
    cfg = scenes.cover_footprint(proto, proto.auto_config(**sim))
    st0 = proto.finalize(cfg, device=device)
    n_dyn = proto.num_bodies - 1
    stack = scenes.apply_stack_jitter(
        st0, *scenes.stack_jitter(n_chunks, n_dyn, seed, device))
    return System(stack, cfg, n_dynamic=n_chunks * n_dyn, chunks=n_chunks)


def spawn(params: dict, seed: int, cfg, device) -> dict:
    return ref_spawn.pile_chunks(params["n_chunks"],
                                 params["scenes_per_chunk"],
                                 params["bodies_per_scene"], seed, cfg,
                                 device)
