"""What a run refuses: a missing card, and a process that has loaded JAX
or the JAX package. And where the program's build caches go.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# top-level module names a run may not hold once its window has closed:
# the port must run without JAX and without the JAX package it was ported
# from (compared as whole names: `nudge_tpu_torch` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "nudge_tpu")


class Refused(RuntimeError):
    """A run that may print no result."""


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among `modules` (default:
    sys.modules), each the part of a module name before its first dot."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def refuse_forbidden(modules=None):
    found = forbidden_modules(modules)
    if found:
        raise Refused("the process has loaded " + ", ".join(found)
                      + ": the benchmark measures the port without JAX")


def require_cards(n: int):
    """Raise unless torch sees at least `n` CUDA devices: a measurement
    never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell needs {n} CUDA devices, torch sees "
                      f"{torch.cuda.device_count()}")


def cache_dirs(root: Path) -> dict:
    """Fixed directories inside the checkout for every compiler cache the
    run may fill (set before torch is imported). The port's own nvcc build
    lands in `build/nudge_tpu_torch/` beside them."""
    base = root / "build" / "bench_cache"
    dirs = {"TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "TRITON_CACHE_DIR": base / "triton",
            "CUDA_CACHE_PATH": base / "cuda"}
    for key, path in dirs.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    # keep libraries that can load JAX by themselves from doing so
    os.environ["USE_FLAX"] = "0"
    return dirs
