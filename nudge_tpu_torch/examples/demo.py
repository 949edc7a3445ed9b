"""The demo (PyTorch port of examples/demo.py): drop a pile of boxes
(and spheres, if asked), simulate it on the card, and render frames to PNGs
and an animated GIF with matplotlib.

Rendering is host-side and optional: the simulation stays on the device
except for the frame readbacks, one every `--frame-every` steps. matplotlib
is imported only to render.

    python -m nudge_tpu_torch.examples.demo                 # 256 boxes, 600 steps, GIF
    python -m nudge_tpu_torch.examples.demo --bodies 64 --spheres 0.3 --steps 400
    python -m nudge_tpu_torch.examples.demo --no-render     # run and print the metrics
    python -m nudge_tpu_torch.examples.demo --device cpu    # the plain twins on the CPU
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from nudge_tpu_torch.engine import simulate
from nudge_tpu_torch.scenes import scene_pile


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bodies", type=int, default=256)
    ap.add_argument("--spheres", type=float, default=0.0,
                    help="fraction of bodies that are spheres")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--frame-every", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "nudge_demo"))
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sleeping", action="store_true")
    return ap.parse_args(argv)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the demo; returns its numbers (steps/s, the last step's
    metrics, the frames written)."""
    args = parse(argv)
    b = scene_pile(args.bodies, sphere_frac=args.spheres)
    cfg = b.auto_config(sleeping=args.sleeping)
    st = b.finalize(cfg, device=args.device)
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "cpu")
    print(f"{args.bodies} bodies on {where}; caps: pairs "
          f"{cfg.max_box_box_pairs}, manifolds {cfg.max_manifolds}")

    frames = []
    chunk = args.frame_every
    _sync(args.device)
    t0 = time.perf_counter()
    for _ in range(0, args.steps, chunk):
        st, m = simulate(st, cfg, chunk)
        frames.append((st.bodies.pos.cpu().numpy().copy(),
                       st.sleep.awake.cpu().numpy().copy()))
    _sync(args.device)
    wall = time.perf_counter() - t0
    steps = len(frames) * chunk
    last = dict(contacts=int(m.contact_count[-1]),
                ke=float(m.kinetic_energy[-1]),
                max_depth=float(m.max_depth[-1]),
                awake=int(m.awake_count[-1]), overflow=bool(m.overflow.any()))
    print(f"{steps} steps in {wall:.2f}s -> {steps / wall:.0f} steps/s "
          f"(incl. kernel build + frame readbacks)")
    print(f"final: contacts={last['contacts']} ke={last['ke']:.3f} "
          f"max_depth={last['max_depth']:.4f} awake={last['awake']} "
          f"overflow={last['overflow']}")
    out = dict(steps=steps, seconds=wall, steps_per_s=steps / wall,
               final=last, pos=frames[-1][0], written=[])
    if not args.no_render:
        out["written"] = render(frames, args)
    return out


def render(frames, args):
    """The frames as PNGs (and a GIF where PIL is installed) in args.out;
    returns the files written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out, exist_ok=True)
    lim = max(8.0, float(np.abs(frames[-1][0][1:, [0, 2]]).max()) + 2)
    images = []
    for i, (pos, awake) in enumerate(frames):
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        p = pos[1:args.bodies + 1]
        aw = awake[1:args.bodies + 1]
        ax.scatter(p[:, 0], p[:, 2], p[:, 1], s=12,
                   c=np.where(aw, "#1f77b4", "#999999"))
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_zlim(0, 2 * lim)
        ax.set_title(f"step {(i + 1) * args.frame_every}")
        fname = os.path.join(args.out, f"frame_{i:04d}.png")
        fig.savefig(fname, dpi=60)
        plt.close(fig)
        images.append(fname)
    try:
        from PIL import Image
    except ImportError:
        print(f"wrote {len(images)} PNG frames to {args.out}/")
        return images
    gif = os.path.join(args.out, "demo.gif")
    imgs = [Image.open(f) for f in images]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=60,
                 loop=0)
    print(f"wrote {gif} ({len(images)} frames)")
    return images + [gif]


if __name__ == "__main__":
    main()
