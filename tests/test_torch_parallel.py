"""Multi-device sharding in the port (`nudge_tpu_torch.parallel.mesh` over
a `torch.distributed` device mesh), held to tests/test_parallel.py's mesh
cases and to the JAX package's `megabatch_simulate(mesh=)`.

The reference shards over 8 virtual CPU devices in one process; the port
runs one process a rank, so each world size here (2 and 4 ranks) is one
spawned gloo group on the CPU (`_torch_mesh_worker.run`, a `file://`
store under tmp_path, one thread a rank), which saves what these tests
check. Every rank builds the same batches from their seeds and compares
its own scenes with the unsharded call in its own process, bitwise."""

import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from nudge_tpu import scenes as jscenes
from nudge_tpu.parallel import mesh as jmesh
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.parallel import mesh as pmesh

import _torch_mesh_worker
from _torch_bridge import (
    assert_same_trajectory, jax_cfg, metrics_np, to_port_state,
)

WORLDS = (2, 4)
REF_STEPS = 6


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's megachunk stack (8 chunks of 2 piles of 8) through
    its megabatch_simulate over the 8-device mesh, and the same stack as a
    port state, saved for the ranks."""
    pcfg = pscenes.scene_pile_batch(2, 8, seed=4).auto_config()
    jcfg = jax_cfg(pcfg)
    jbatch, _ = jscenes.scene_pile_megachunks(8, 2, 8, cfg=jcfg, seed=4)
    mesh8 = Mesh(np.array(jax.devices()), (jmesh.SCENE_AXIS,))
    sharded = jmesh.shard_scene_batch(jbatch, mesh8)
    jst, jm = jmesh.megabatch_simulate(jcfg, REF_STEPS, donate=False,
                                       mesh=mesh8)(sharded)
    path = str(tmp_path_factory.mktemp("reference") / "stack.pt")
    torch.save((to_port_state(jbatch), pcfg, REF_STEPS), path)
    return dict(path=path, jst=jst, jm=metrics_np(jm))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, tmp_path_factory, reference):
    """Each rank's saved results of one gloo group of `world` ranks."""
    world = request.param
    out = tmp_path_factory.mktemp(f"mesh{world}")
    store = f"file://{out / 'store'}"
    mp.start_processes(_torch_mesh_worker.run,
                       args=(world, store, str(out), reference["path"]),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _all_sharded(placements, world, n):
    """Every leaf a DTensor placed Shard(0) on the 'scenes' mesh, its local
    part n / world of its n scenes."""
    for pl, local, glob, names in placements:
        assert names == (pmesh.SCENE_AXIS,)
        assert pl == "(Shard(dim=0),)", pl
        assert glob[0] == n and local == (n // world,) + glob[1:]


def test_shard_scene_batch_places_every_leaf(ranks):
    world = len(ranks)
    for r, res in enumerate(ranks):
        assert res["mesh_local_rank"] == r
        _all_sharded(res["placements"], world, 8)
        assert res["own_range"], f"rank {r} holds another range"


def test_batched_step_preserves_sharding(ranks):
    world = len(ranks)
    for res in ranks:
        _all_sharded(res["step_placements"], world, 16)
        _all_sharded(res["step_metric_placements"], world, 16)
        assert res["step_finite"]
    # batched_simulate's metrics [steps, scenes]: the scene axis is dim 1
    for pl, local, glob, _ in ranks[0]["simulate_metric_placements"]:
        assert pl == "(Shard(dim=1),)" and glob == (5, 8)
        assert local == (5, 8 // world)


def test_sharded_matches_unsharded(ranks):
    """Each rank's scenes after a sharded step are bitwise the same scenes
    of the unsharded step, state and metrics."""
    assert all(res["step_equal"] for res in ranks)


def test_scene_independence_under_sharding(ranks):
    """Scene 3's rollout inside the sharded batch is bitwise its rollout
    alone (on the rank that holds it)."""
    holders = [res for res in ranks if "probe_equal" in res]
    assert len(holders) == 1 and holders[0]["probe_equal"]


def test_megachunk_sharded_over_mesh(ranks):
    """megabatch_simulate(mesh=) shards a stack of plain tensors over the
    mesh, each rank loops its local chunks, and the result is the
    unsharded call's, bit for bit; the mesh size must divide the chunk
    count, and no DTensor reaches the step."""
    world = len(ranks)
    for res in ranks:
        _all_sharded(res["mega_placements"], world, 8)
        assert res["mega_equal"]
        assert res["indivisible_raises"]
        assert res["take_refuses"]


def test_megabatch_mesh_matches_reference(ranks, reference):
    """The ranks' chunks of the port's megabatch_simulate(mesh=), gathered
    from their saved local parts, against the JAX package's over its
    8-device mesh (test_torch_batch.py's test_megabatch_matches_reference
    tolerances)."""
    jst, jm = reference["jst"], reference["jm"]
    k = 8 // len(ranks)
    for r, res in enumerate(ranks):
        pst, pm = res["reference_local"]
        pm = metrics_np(pm)
        for c in range(k):
            g = r * k + c
            sl = {f: v[g:g + 1] for f, v in jm.items()}
            mine = {f: v[c:c + 1] for f, v in pm.items()}
            assert_same_trajectory(pmesh.take(pst, c), mine,
                                   jax.tree.map(lambda x: x[g], jst), sl)


def test_torchrun_entry_point():
    """`nudge_tpu_torch.parallel.run_mesh` under torchrun (two gloo ranks on
    the CPU, a free local port): each rank steps its half of the stack and
    reports its chunks."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "nudge_tpu_torch.parallel.run_mesh",
         "--device", "cpu", "--steps", "3"],
        cwd=repo, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    for r, chunks in ((0, "chunks 0-1 of 4"), (1, "chunks 2-3 of 4")):
        assert f"rank {r}/2 on cpu: {chunks}" in res.stdout, res.stdout
