"""A sharded config-5 rollout: each rank of a `torch.distributed` group
steps its chunks of a megachunk stack through
`megabatch_simulate(mesh=...)` and prints what it ran. Start one process a
rank with torchrun, which sets the group's environment:

    torchrun --standalone --nproc-per-node 2 -m nudge_tpu_torch.parallel.run_mesh --device cpu
    torchrun --standalone --nproc-per-node 4 -m nudge_tpu_torch.parallel.run_mesh   # a card a rank

On the CPU the group is gloo, on the cards NCCL. Every rank builds the
same stack from the seed and keeps its own contiguous range of chunks;
nothing is exchanged while stepping.
"""

from __future__ import annotations

import argparse
import time

import torch

from nudge_tpu_torch import scenes
from nudge_tpu_torch.parallel import mesh


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=4,
                    help="chunks in the stack; the ranks must divide it")
    ap.add_argument("--scenes-per-chunk", type=int, default=2)
    ap.add_argument("--bodies", type=int, default=8, help="boxes a scene")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    import torch.distributed as dist

    args = parse(argv)
    m = mesh.scene_mesh(args.device)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if args.device == "cuda" else torch.device(args.device))
        stack, cfg = scenes.scene_pile_megachunks(
            args.chunks, args.scenes_per_chunk, args.bodies, seed=args.seed,
            device=dev)
        t0 = time.perf_counter()
        out, last = mesh.megabatch_simulate(cfg, args.steps, mesh=m)(stack)
        local = mesh.local_batch(last)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rank, size = dist.get_rank(), dist.get_world_size()
        k = args.chunks // size
        print(f"rank {rank}/{size} on {dev}: chunks {rank * k}-"
              f"{(rank + 1) * k - 1} of {args.chunks}, {args.steps} steps in "
              f"{dt:.2f} s; contacts by chunk "
              f"{local.contact_count.tolist()}, overflow "
              f"{bool(local.overflow.any())}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
