"""The ranks of tests/test_torch_parallel.py: one process a rank of a gloo
group on the CPU, spawned by the test. Imports no JAX (the ranks need
none). Each rank builds the same batches from their seeds, runs
`nudge_tpu_torch.parallel.mesh` on them sharded and unsharded, and saves
what the tests check (placements, bitwise comparisons of its own scenes,
its local results) to `out_dir/rank{r}.pt`."""

from __future__ import annotations

import datetime
import os

import torch

from nudge_tpu_torch import config as pconfig
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.parallel import mesh as pmesh
from nudge_tpu_torch.state import tree_map


def small_cfg():
    """tests/test_parallel.py's small_cfg."""
    return pconfig.SimConfig(
        max_bodies=16, max_boxes=16, max_spheres=8,
        max_box_box_pairs=64, max_box_sphere_pairs=32,
        max_sphere_sphere_pairs=16, max_manifolds=112)


def pile_batch(cfg, n_scenes):
    """tests/test_parallel.py's make_batch: piles of 8 bodies, a quarter
    spheres, seed i for scene i."""
    return pmesh.make_scene_batch([
        pscenes.scene_pile(8, sphere_frac=0.25, seed=i).finalize(
            cfg, device="cpu") for i in range(n_scenes)])


def leaves(tree):
    found = []
    tree_map(lambda x: found.append(x), tree)
    return found


def placements(tree):
    """(placements, local shape, global shape, mesh dim names) of every
    leaf, as strings and tuples."""
    return [(str(x.placements), tuple(x.to_local().shape), tuple(x.shape),
             x.device_mesh.mesh_dim_names) for x in leaves(tree)]


def own_part_equal(sharded, full, lo, hi, dim=0):
    """Whether every leaf's local part is bitwise the same rows [lo, hi)
    (along `dim`) of the unsharded result."""
    return all(torch.equal(x.to_local(), y.narrow(dim, lo, hi - lo))
               for x, y in zip(leaves(sharded), leaves(full)))


def run(rank: int, world: int, store: str, out_dir: str, reference: str):
    torch.set_num_threads(1)
    mesh = pmesh.scene_mesh("cpu", init_method=store, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    res = {"rank": rank, "mesh_local_rank": mesh.get_local_rank(
        pmesh.SCENE_AXIS)}
    cfg = small_cfg()

    # placement (tests/test_parallel.py:46)
    batch = pile_batch(cfg, 8)
    sharded = pmesh.shard_scene_batch(batch, mesh)
    k = 8 // world
    lo, hi = rank * k, (rank + 1) * k
    res["placements"] = placements(sharded)
    res["own_range"] = own_part_equal(sharded, batch, lo, hi)

    # batched_step keeps the sharding (:58), and equals the unsharded
    # step bitwise (:70)
    big = pile_batch(cfg, 16)
    out, m = pmesh.batched_step(cfg, donate=False)(
        pmesh.shard_scene_batch(big, mesh))
    ref, mref = pmesh.batched_step(cfg, donate=False)(big)
    k16 = 16 // world
    res["step_placements"] = placements(out)
    res["step_metric_placements"] = placements(m)
    res["step_finite"] = bool(torch.isfinite(out.bodies.pos.to_local()).all())
    res["step_equal"] = (own_part_equal(out, ref, rank * k16, (rank + 1) * k16)
                         and own_part_equal(m, mref, rank * k16,
                                            (rank + 1) * k16))

    # scene independence (:89): scene `probe` of the sharded rollout
    # against its rollout alone, on the rank that holds it
    steps, probe = 5, 3
    rolled, rm = pmesh.batched_simulate(cfg, steps, donate=False)(sharded)
    res["simulate_metric_placements"] = placements(rm)
    if lo <= probe < hi:
        solo = pile_batch(cfg, probe + 1)
        solo = pmesh.make_scene_batch([pmesh.take(solo, probe)])
        solo_rolled, _ = pmesh.batched_simulate(cfg, steps, donate=False)(solo)
        mine = pmesh.take(pmesh.local_batch(rolled), probe - lo)
        res["probe_equal"] = all(
            torch.equal(x, y) for x, y in zip(
                leaves(mine), leaves(pmesh.take(solo_rolled, 0))))

    # megachunks over the mesh (:148): 8 chunks, unsharded alike
    stack, mcfg = pscenes.scene_pile_megachunks(8, 2, 8, seed=4,
                                                device="cpu")
    mref_st, mref_m = pmesh.megabatch_simulate(mcfg, 6, donate=False)(stack)
    mout, mm = pmesh.megabatch_simulate(mcfg, 6, donate=False,
                                        mesh=mesh)(stack)
    res["mega_placements"] = placements(mout)
    res["mega_equal"] = (own_part_equal(mout, mref_st, lo, hi)
                         and own_part_equal(mm, mref_m, lo, hi))

    # the mesh size must divide the chunk count; no DTensor reaches the
    # step
    odd, ocfg = pscenes.scene_pile_megachunks(world + 1, 2, 8, seed=1,
                                              device="cpu")
    try:
        pmesh.megabatch_simulate(ocfg, 1, mesh=mesh)(odd)
        res["indivisible_raises"] = False
    except ValueError:
        res["indivisible_raises"] = True
    try:
        pmesh.take(sharded, 0)
        res["take_refuses"] = False
    except TypeError:
        res["take_refuses"] = True

    # the JAX package's stack (saved by the test): this rank's chunks
    # after megabatch_simulate(mesh=)
    ref_stack, ref_cfg, ref_steps = torch.load(reference, weights_only=False)
    jout, jm = pmesh.megabatch_simulate(ref_cfg, ref_steps, donate=False,
                                        mesh=mesh)(ref_stack)
    res["reference_local"] = (pmesh.local_batch(jout),
                              pmesh.local_batch(jm))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
