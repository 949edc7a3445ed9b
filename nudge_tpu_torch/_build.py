"""Build and load the port's CUDA kernels.

At the first kernel call, `nvcc` compiles every `.cu` file under `csrc/`
into one shared library with a plain C interface, which is loaded with
ctypes. The library lives in `build/nudge_tpu_torch/` at the repository
root, named by a hash of the sources and flags, so an edit to any kernel
rebuilds it and an unchanged tree reuses it. Nothing here runs at import.

Kernels are built without FMA contraction (`-fmad=false`): every float
operation rounds as the plain PyTorch twins' separate operations do, so
the on-card comparison with the twins is close to bitwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "nudge_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points and their argument types (pointers and the stream are
# c_void_p, counts c_int, physics constants c_float). Each returns the
# cudaError_t of its launches.
_SIGNATURES = {
    "nudge_box_box": [_P] * 8 + [_I] + [_P] * 8 + [_P],
    "nudge_setup": [_P] * 15 + [_I] + [_F] * 9 + [_I] * 3 + [_P] * 23 + [_P],
    "nudge_segment_apply": [_P] * 4 + [_I] * 3 + [_P],
    "nudge_solve": [_P] * 30 + [_I] * 5 + [_P] * 5 + [_I] + [_P],
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: Path, log: str):
        self.path = path
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args):
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


_LOADED: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(_SRC.glob("*.cu")), sorted(_SRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    cu, _ = _sources()
    _BUILD.mkdir(parents=True, exist_ok=True)
    out = _BUILD / f"libnudge_kernels_{source_hash()}.so"
    log = ""
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, out)
    _LOADED = KernelLibrary(out, log)
    return _LOADED


def ptr(t) -> int:
    return t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
