from .mesh import batched_step, make_scene_batch, shard_scene_batch

__all__ = ["batched_step", "make_scene_batch", "shard_scene_batch"]
