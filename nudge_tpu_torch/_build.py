"""Build and load the port's CUDA kernels.

At the first kernel call, `nvcc` compiles every `.cu` file under `csrc/`,
one process per file, all started together, and links the objects into
one shared library with a plain C interface, which is loaded with
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points and their argument types (pointers and the stream are
# c_void_p, counts c_int, physics constants c_float). Each returns the
# cudaError_t of its launches, except nudge_solve_cluster and
# nudge_solve_bwd_cluster, which return the cluster size of the solve and of
# its backward (0 on error).
_SIGNATURES = {
    "nudge_box_box": [_P] * 8 + [_I] + [_P] * 10 + [_P],
    "nudge_setup": [_P] * 23 + [_I] * 3 + [_F] * 9 + [_I] * 3 + [_P] * 4
                   + [_P],
    "nudge_solve": [_P] * 12 + [_I] * 5 + [_P] + [_P],
    "nudge_solve_bwd": [_P] * 18 + [_I] * 4 + [_P],
    "nudge_solve_bwd_cluster": [],
    "nudge_solve_cluster": [],
    "nudge_pairs_1pt": [_P] * 15 + [_I] * 3 + [_P] * 10 + [_P],
    "nudge_color_rounds": [_P] * 5 + [_I] * 3 + [_P] * 2 + [_P],
    "nudge_color_rounds_cached": [_P] * 5 + [_I] * 4 + [_P] * 4 + [_P],
    "nudge_box_box_bwd": [_P] * 7 + [_I] + [_P] * 6 + [_P],
    "nudge_pairs_1pt_bwd": [_P] * 13 + [_I] * 2 + [_P] * 6 + [_P],
    "nudge_segment_sum": [_P] * 3 + [_I] * 4 + [_P] + [_P],
    "nudge_setup_bwd": [_P] * 17 + [_I] * 2 + [_F] * 9 + [_I] * 3 + [_P] * 12
                       + [_P],
    "nudge_setup_body_sum": [_P] * 9 + [_I] * 2 + [_P] * 6 + [_P],
    "nudge_if_begin": [_P] * 4,
    "nudge_if_end": [_P],
    "nudge_stamp": [_P, _P] + [_I] * 4 + [_P],
    "nudge_join3": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 2 + [_P] + [_I] * 2
                   + [_P, _P, _I] * 2 + [_P] * 2 + [_P],
    "nudge_join1": [_P] * 2 + [_I] + [_P] * 2 + [_I] + [_P] + [_I] * 2
                   + [_P, _P, _I] * 2 + [_P] * 2 + [_P],
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
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(f"--- {src.name}\n{o}" for src, o in zip(cu, outs))
        failed = [src.name for src, p in zip(cu, procs) if p.returncode]
        if not failed:
            res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                  *map(str, objs)], capture_output=True,
                                 text=True)
            log += res.stdout + res.stderr
            if res.returncode:
                failed = ["link"]
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        # the log (ptxas's registers and stack frames) stays beside the
        # library for a later process that loads it without building
        log_path.write_text(log)
        os.replace(tmp, out)
    _LOADED = KernelLibrary(out, log)
    return _LOADED


def check_cuda(kernel: str, name: str, t, dtype, shape):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`:
    the kernels take nothing else."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous CUDA "
                         f"{dtype} tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def ptr(t) -> int:
    return t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
