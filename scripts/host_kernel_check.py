"""The narrowphase kernels' device code on the CPU: built with g++ and held
to the plain twins, no GPU needed.

    python3 scripts/host_kernel_check.py [--parent DIR]

Compiles csrc/narrowphase.cu and csrc/narrowphase_1pt.cu of this checkout
(and, with --parent, of DIR: an earlier commit unpacked with `git
archive`) as host code: a stand-in for cuda_runtime.h turns the kernels
into plain functions, each launcher is cut off, and a loop over the
threads of the grid takes the launch's place. `-ffp-contract=off` keeps
every float operation separate, as the card's `-fmad=false` build does.
The objects go to build/host_check/ (git-ignored). Then, on seeded
inputs (random box pairs tumbled or axis-aligned, a resting stack of
equal boxes, box-sphere and sphere-sphere rows with some centres inside
their box and some coincident):

  - the forward kernels' live slots against the twins
    (`box_box_slots_plain`, `pairs_1pt_slots_plain`): the integer fields
    equal, the float fields within 1e-6 of the largest element (g++ and
    PyTorch's CPU kernels part in the last bit on a few values; on the
    card kernels and twins agree bitwise), and bitwise against the
    parent's build;
  - the backward kernels' adjoint rows against autograd of the twin in
    float32 (box-box, row by row) or the per-collider sums against
    autograd of the float64 twin (one-point), and against the parent's
    rows; the largest difference over the largest element;
  - dead slots: the rows the kernel leaves unwritten (filled with NaN
    beforehand);
  - where the tree's backward kernels have a shape instance: its pose rows
    bitwise the pose-only instance's, and its shape rows (half extents,
    radii, frictions) against autograd of the float32 twin.

Needs g++. Prints one line per tree and case; exits non-zero when a check
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "host_check")
sys.path.insert(0, REPO)

from nudge_tpu_torch.mathx import quat_from_axis_angle  # noqa: E402
from nudge_tpu_torch.ops import narrowphase as nps  # noqa: E402
from nudge_tpu_torch.ops import narrowphase_kernel as npk  # noqa: E402

STUB = r"""#pragma once
#include <math.h>
#include <stddef.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct HostIdx { unsigned x, y, z; };
extern HostIdx blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; struct { struct { unsigned x, y, z; } clusterDim; } val; };
struct cudaLaunchConfig_t { dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs; };
enum cudaFuncAttribute { cudaFuncAttributeNonPortableClusterSizeAllowed, cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveClusters(int*, K, const cudaLaunchConfig_t*) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""

# Each backward kernel is run over `rows * 14` threads: the parent's
# launched one thread a (row, pose input), this tree's one a row (its
# threads past the rows return at once).
GRID_LOOP = r"""
HostIdx blockIdx, threadIdx, blockDim;
static void each_thread(long long n, void (*f)(void*), void* ctx) {
  blockDim.x = kThreads;
  for (long long t = 0; t < n; ++t) {
    blockIdx.x = (unsigned)(t / kThreads);
    threadIdx.x = (unsigned)(t % kThreads);
    f(ctx);
  }
}
"""
BOX_BOX = r"""
struct FwdArgs { const float *half, *quat, *wpos, *fric; const int *body, *pa, *pb; const bool* valid; int n; Outputs out; };
struct BwdArgs { const float *half, *quat, *wpos; const int *pa, *pb; const bool* valid; int n; const float *gp, *gd, *gn; float* adj; };
extern "C" void host_box_box(const float* half, const float* quat, const float* wpos, const float* fric,
                             const int* body, const int* pa, const int* pb, const bool* valid, int n,
                             float* normal, float* fr, int* ba, int* bb, float* pos, float* depth,
                             int* feat, bool* pv, int* ga, int* gb) {
  FwdArgs a{half, quat, wpos, fric, body, pa, pb, valid, n, Outputs{normal, fr, ba, bb, pos, depth, feat, pv, ga, gb}};
  each_thread(n, [](void* c) {
    auto& a = *(FwdArgs*)c;
    box_box_kernel(a.half, a.quat, a.wpos, a.fric, a.body, a.pa, a.pb, a.valid, a.n, a.out);
  }, &a);
}
extern "C" void host_box_box_bwd(const float* half, const float* quat, const float* wpos, const int* pa,
                                 const int* pb, const bool* valid, int n, const float* gp,
                                 const float* gd, const float* gn, float* adj) {
  BwdArgs a{half, quat, wpos, pa, pb, valid, n, gp, gd, gn, adj};
  each_thread(14LL * n, [](void* c) {
    auto& a = *(BwdArgs*)c;
    box_box_bwd_kernel(a.half, a.quat, a.wpos, a.pa, a.pb, a.valid, a.n, a.gp, a.gd, a.gn, a.adj);
  }, &a);
}
"""
# The same for trees whose backward kernels have a shape instance (a
# friction input, the friction's adjoint, the shape rows: null for the
# pose-only instance).
BOX_BOX_SHAPE = r"""
struct FwdArgs { const float *half, *quat, *wpos, *fric; const int *body, *pa, *pb; const bool* valid; int n; Outputs out; };
struct BwdArgs { const float *half, *quat, *wpos, *fric; const int *pa, *pb; const bool* valid; int n; const float *gp, *gd, *gn, *gf; float *adj, *shp; };
extern "C" void host_box_box(const float* half, const float* quat, const float* wpos, const float* fric,
                             const int* body, const int* pa, const int* pb, const bool* valid, int n,
                             float* normal, float* fr, int* ba, int* bb, float* pos, float* depth,
                             int* feat, bool* pv, int* ga, int* gb) {
  FwdArgs a{half, quat, wpos, fric, body, pa, pb, valid, n, Outputs{normal, fr, ba, bb, pos, depth, feat, pv, ga, gb}};
  each_thread(n, [](void* c) {
    auto& a = *(FwdArgs*)c;
    box_box_kernel(a.half, a.quat, a.wpos, a.fric, a.body, a.pa, a.pb, a.valid, a.n, a.out);
  }, &a);
}
extern "C" void host_box_box_bwd_shape(const float* half, const float* quat, const float* wpos,
                                       const float* fric, const int* pa, const int* pb,
                                       const bool* valid, int n, const float* gp, const float* gd,
                                       const float* gn, const float* gf, float* adj, float* shp) {
  BwdArgs a{half, quat, wpos, fric, pa, pb, valid, n, gp, gd, gn, gf, adj, shp};
  each_thread(n, [](void* c) {
    auto& a = *(BwdArgs*)c;
    if (a.shp)
      box_box_bwd_kernel<true>(a.half, a.quat, a.wpos, a.fric, a.pa, a.pb, a.valid, a.n, a.gp,
                               a.gd, a.gn, a.gf, a.adj, a.shp);
    else
      box_box_bwd_kernel<false>(a.half, a.quat, a.wpos, a.fric, a.pa, a.pb, a.valid, a.n, a.gp,
                                a.gd, a.gn, a.gf, a.adj, a.shp);
  }, &a);
}
extern "C" void host_box_box_bwd(const float* half, const float* quat, const float* wpos, const int* pa,
                                 const int* pb, const bool* valid, int n, const float* gp,
                                 const float* gd, const float* gn, float* adj) {
  host_box_box_bwd_shape(half, quat, wpos, nullptr, pa, pb, valid, n, gp, gd, gn, nullptr, adj,
                         nullptr);
}
"""
ONE_POINT_SHAPE = r"""
struct FwdArgs { Colliders c; Pairs in; int nb, n_bs, n_ss; Slots out; };
struct BwdArgs { Colliders c; Pairs in; int n_bs, n_ss; const float *gp, *gd, *gn, *gf; float *adj, *shp; };
extern "C" void host_pairs_1pt(const float* half, const float* box_quat, const float* box_pos,
                               const float* box_fric, const int* box_body, const float* radius,
                               const float* sph_pos, const float* sph_fric, const int* sph_body,
                               const int* bs_a, const int* bs_b, const bool* bs_valid, const int* ss_a,
                               const int* ss_b, const bool* ss_valid, int nb, int n_bs, int n_ss,
                               float* normal, float* fr, int* ba, int* bb, float* pos, float* depth,
                               int* feat, bool* pv, int* ga, int* gb) {
  FwdArgs a{Colliders{half, box_quat, box_pos, box_fric, box_body, radius, sph_pos, sph_fric, sph_body},
            Pairs{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid}, nb, n_bs, n_ss,
            Slots{normal, fr, ba, bb, pos, depth, feat, pv, ga, gb}};
  each_thread(n_bs + n_ss, [](void* c) {
    auto& a = *(FwdArgs*)c;
    pairs_1pt_kernel(a.c, a.in, a.nb, a.n_bs, a.n_ss, a.out);
  }, &a);
}
extern "C" void host_pairs_1pt_bwd_shape(const float* half, const float* box_quat,
                                         const float* box_pos, const float* box_fric,
                                         const float* radius, const float* sph_pos,
                                         const float* sph_fric, const int* bs_a, const int* bs_b,
                                         const bool* bs_valid, const int* ss_a, const int* ss_b,
                                         const bool* ss_valid, int n_bs, int n_ss, const float* gp,
                                         const float* gd, const float* gn, const float* gf,
                                         float* adj, float* shp) {
  BwdArgs a{Colliders{half, box_quat, box_pos, box_fric, nullptr, radius, sph_pos, sph_fric, nullptr},
            Pairs{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid}, n_bs, n_ss, gp, gd, gn, gf, adj, shp};
  each_thread(n_bs + n_ss, [](void* c) {
    auto& a = *(BwdArgs*)c;
    if (a.shp)
      pairs_1pt_bwd_kernel<true>(a.c, a.in, a.n_bs, a.n_ss, a.gp, a.gd, a.gn, a.gf, a.adj, a.shp);
    else
      pairs_1pt_bwd_kernel<false>(a.c, a.in, a.n_bs, a.n_ss, a.gp, a.gd, a.gn, a.gf, a.adj, a.shp);
  }, &a);
}
extern "C" void host_pairs_1pt_bwd(const float* half, const float* box_quat, const float* box_pos,
                                   const float* radius, const float* sph_pos, const int* bs_a,
                                   const int* bs_b, const bool* bs_valid, const int* ss_a,
                                   const int* ss_b, const bool* ss_valid, int n_bs, int n_ss,
                                   const float* gp, const float* gd, const float* gn, float* adj) {
  host_pairs_1pt_bwd_shape(half, box_quat, box_pos, nullptr, radius, sph_pos, nullptr, bs_a, bs_b,
                           bs_valid, ss_a, ss_b, ss_valid, n_bs, n_ss, gp, gd, gn, nullptr, adj,
                           nullptr);
}
"""
ONE_POINT = r"""
struct FwdArgs { Colliders c; Pairs in; int nb, n_bs, n_ss; Slots out; };
struct BwdArgs { Colliders c; Pairs in; int n_bs, n_ss; const float *gp, *gd, *gn; float* adj; };
extern "C" void host_pairs_1pt(const float* half, const float* box_quat, const float* box_pos,
                               const float* box_fric, const int* box_body, const float* radius,
                               const float* sph_pos, const float* sph_fric, const int* sph_body,
                               const int* bs_a, const int* bs_b, const bool* bs_valid, const int* ss_a,
                               const int* ss_b, const bool* ss_valid, int nb, int n_bs, int n_ss,
                               float* normal, float* fr, int* ba, int* bb, float* pos, float* depth,
                               int* feat, bool* pv, int* ga, int* gb) {
  FwdArgs a{Colliders{half, box_quat, box_pos, box_fric, box_body, radius, sph_pos, sph_fric, sph_body},
            Pairs{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid}, nb, n_bs, n_ss,
            Slots{normal, fr, ba, bb, pos, depth, feat, pv, ga, gb}};
  each_thread(n_bs + n_ss, [](void* c) {
    auto& a = *(FwdArgs*)c;
    pairs_1pt_kernel(a.c, a.in, a.nb, a.n_bs, a.n_ss, a.out);
  }, &a);
}
extern "C" void host_pairs_1pt_bwd(const float* half, const float* box_quat, const float* box_pos,
                                   const float* radius, const float* sph_pos, const int* bs_a,
                                   const int* bs_b, const bool* bs_valid, const int* ss_a,
                                   const int* ss_b, const bool* ss_valid, int n_bs, int n_ss,
                                   const float* gp, const float* gd, const float* gn, float* adj) {
  BwdArgs a{Colliders{half, box_quat, box_pos, nullptr, nullptr, radius, sph_pos, nullptr, nullptr},
            Pairs{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid}, n_bs, n_ss, gp, gd, gn, adj};
  each_thread(14LL * (n_bs + n_ss), [](void* c) {
    auto& a = *(BwdArgs*)c;
    pairs_1pt_bwd_kernel(a.c, a.in, a.n_bs, a.n_ss, a.gp, a.gd, a.gn, a.adj);
  }, &a);
}
"""


def build(name: str, root: str) -> dict:
    """g++ builds of `root`'s two narrowphase sources: {file: CDLL}."""
    csrc = os.path.join(root, "nudge_tpu_torch", "csrc")
    out = os.path.join(OUT, name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "stub"))
    with open(os.path.join(out, "stub", "cuda_runtime.h"), "w") as f:
        f.write(STUB)
    for header in os.listdir(csrc):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, header), out)
    libs = {}
    for src, entries, with_shape in (("narrowphase", BOX_BOX, BOX_BOX_SHAPE),
                                     ("narrowphase_1pt", ONE_POINT, ONE_POINT_SHAPE)):
        with open(os.path.join(csrc, src + ".cu")) as f:
            code = f.read()
        if "kShapeInputs" in code:
            entries = with_shape
        cpp = os.path.join(out, src + ".cpp")
        with open(cpp, "w") as f:
            f.write(code[:code.index('extern "C"')] + GRID_LOOP + entries)
        lib = os.path.join(out, f"lib{src}.so")
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                        "-shared", "-w", "-I", os.path.join(out, "stub"), "-o",
                        lib, cpp], check=True)
        libs[src] = ctypes.CDLL(lib)
    return libs


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def as_bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def against_twin(out, twin, live):
    """(integer fields that differ from the twin's, the float fields'
    largest difference over their largest element) on the live slots"""
    ints = [k for k in npk.SLOTS if not out[k].is_floating_point()
            and not torch.equal(out[k][live], twin[k][live])]
    floats = [k for k in npk.SLOTS if out[k].is_floating_point()]
    err = max(float((out[k][live] - twin[k][live]).abs().max()) for k in floats)
    big = max(float(twin[k][live].abs().max()) for k in floats)
    return ints, err / big


def forward_bits(outs, live):
    """fields of the committed forward not bitwise the parent's"""
    return [k for k in npk.SLOTS if not torch.equal(
        as_bits(outs["committed"][k][live]), as_bits(outs["parent"][k][live]))]


def tumbled_pairs(n, seed, spread, tilt):
    """n box pairs (a = 2i, b = 2i + 1), b at a seeded offset from a, both
    turned by seeded axis-angles scaled by `tilt`; 80% of the slots live."""
    g = np.random.default_rng(seed)
    half = torch.tensor(g.uniform(0.2, 0.8, (2 * n, 3)), dtype=torch.float32)
    ax = g.normal(size=(2 * n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    quat = quat_from_axis_angle(
        torch.tensor(ax, dtype=torch.float32),
        torch.tensor(g.uniform(-np.pi, np.pi, 2 * n) * tilt,
                     dtype=torch.float32)).contiguous()
    pos = np.zeros((2 * n, 3), np.float32)
    pos[1::2] = g.normal(size=(n, 3)) * spread * 0.6
    a = torch.arange(0, 2 * n, 2, dtype=torch.int32)
    return dict(half=half, quat=quat, pos=torch.tensor(pos), a=a, b=a + 1,
                valid=torch.tensor(g.uniform(size=n) < 0.8))


def stacked_pairs(n, seed):
    """n pairs of equal unit boxes resting one on another, shifted in x."""
    g = np.random.default_rng(seed)
    quat = torch.zeros((2 * n, 4))
    quat[:, 3] = 1.0
    pos = torch.zeros((2 * n, 3))
    pos[1::2, 1] = 0.99
    pos[1::2, 0] = torch.tensor(g.uniform(-0.25, 0.25, n), dtype=torch.float32)
    a = torch.arange(0, 2 * n, 2, dtype=torch.int32)
    return dict(half=torch.full((2 * n, 3), 0.5), quat=quat, pos=pos, a=a,
                b=a + 1, valid=torch.ones(n, dtype=torch.bool))


def box_box_case(trees, label, x, seed):
    n = x["a"].shape[0]
    fric, body = torch.ones(2 * n), torch.arange(2 * n, dtype=torch.int32)
    live = x["valid"]
    twin = npk.box_box_slots_plain(
        argparse.Namespace(half=x["half"], friction=fric, body=body),
        argparse.Namespace(box_quat=x["quat"], box_pos=x["pos"]),
        argparse.Namespace(a=x["a"], b=x["b"], valid=live))
    g = torch.Generator().manual_seed(seed)
    gp, gd, gn = (torch.randn(s, generator=g) for s in ((n, 4, 3), (n, 4), (n, 3)))
    ia, ib = x["a"].long(), x["b"].long()
    leaves = [t.clone().requires_grad_() for t in
              (x["pos"][ia], x["quat"][ia], x["pos"][ib], x["quat"][ib])]
    o = nps.box_box(x["half"][ia], leaves[1], leaves[0], x["half"][ib], leaves[3],
                    leaves[2])
    loss = (o["pos"] * gp).sum() + (o["depth"] * gd).sum() + (o["normal"] * gn).sum()
    want = torch.cat(torch.autograd.grad(loss, leaves), 1)
    rows, outs = {}, {}
    for name, libs in trees.items():
        out = {k: torch.zeros((n,) + row, dtype=dt) for k, (row, dt) in npk.SLOTS.items()}
        libs["narrowphase"].host_box_box(
            ptr(x["half"]), ptr(x["quat"]), ptr(x["pos"]), ptr(fric), ptr(body), ptr(x["a"]),
            ptr(x["b"]), ptr(live), n, *[ptr(out[k]) for k in npk.SLOTS])
        outs[name] = out
        differ, f_err = against_twin(out, twin, live)
        adj = torch.full((n, 14), float("nan"))
        libs["narrowphase"].host_box_box_bwd(
            ptr(x["half"]), ptr(x["quat"]), ptr(x["pos"]), ptr(x["a"]), ptr(x["b"]),
            ptr(live), n, ptr(gp), ptr(gd), ptr(gn), ptr(adj))
        rows[name] = adj
        dead = "NaN (unwritten)" if bool(adj[~live].isnan().all()) else "written"
        big = float(want[live].abs().max())
        err = float((adj[live] - want[live]).abs().max())
        edge = int((live & (out["feat"][:, 0] >= 1024)).sum())
        if hasattr(libs["narrowphase"], "host_box_box_bwd_shape"):
            box_box_shape_rows(libs["narrowphase"], label, x, fric, gp, gd, gn, adj, seed)
        print(f"{name}: box-box {label}: {n} slots, {int(live.sum())} live ({edge} "
              f"edge case); forward against the twin: integer fields that "
              f"differ {differ or 'none'}, floats {f_err:.2e} of the largest; "
              f"backward rows against float32 twin autograd {err / big:.2e} "
              f"of the largest element; dead rows {dead}", flush=True)
        assert not differ and f_err <= 1e-6 and err <= 1e-5 * big
    if "parent" in rows:
        a, b = rows["committed"][live], rows["parent"][live]
        bits = forward_bits(outs, live)
        print(f"committed vs parent: box-box {label}: forward fields not "
              f"bitwise the parent's: {bits or 'none'}; backward rows "
              f"{float((a - b).abs().max()) / float(b.abs().max()):.2e} of the "
              "largest element", flush=True)
        assert not bits


def shape_report(kind, label, got, want, pose_bits):
    """Print and check a shape instance's rows against autograd: the
    largest difference over the largest element, column group by group."""
    errs = {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, w in want.items()}
    print(f"committed: {kind} {label}: shape instance: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + " of the largest element against float32 twin autograd; pose rows "
          + ("bitwise the pose-only instance's" if pose_bits else "DIFFER from the pose-only"),
          flush=True)
    assert pose_bits and max(errs.values()) <= 1e-5


def box_box_shape_rows(lib, label, x, fric, gp, gd, gn, adj, seed):
    """The box-box kernel's shape instance: its pose rows bitwise the
    pose-only instance's (`adj`), its shape rows (half extents and
    frictions of both boxes) against autograd of the float32 twin."""
    n = x["a"].shape[0]
    live = x["valid"]
    g = torch.Generator().manual_seed(seed + 100)
    fr = torch.tensor(np.random.default_rng(seed).uniform(0.2, 1.0, 2 * n),
                      dtype=torch.float32)
    gf = torch.randn(n, generator=g)
    adj2 = torch.full((n, 14), float("nan"))
    shp = torch.full((n, 10), float("nan"))
    lib.host_box_box_bwd_shape(
        ptr(x["half"]), ptr(x["quat"]), ptr(x["pos"]), ptr(fr), ptr(x["a"]), ptr(x["b"]),
        ptr(live), n, ptr(gp), ptr(gd), ptr(gn), ptr(gf), ptr(adj2), ptr(shp))
    pose_bits = torch.equal(adj2[live], adj[live]) and bool(shp[~live].isnan().all())
    ia, ib = x["a"].long(), x["b"].long()
    leaves = [t.clone().requires_grad_() for t in
              (x["half"][ia], x["half"][ib], fr[ia], fr[ib])]
    o = nps.box_box(leaves[0], x["quat"][ia], x["pos"][ia], leaves[1], x["quat"][ib],
                    x["pos"][ib])
    loss = ((o["pos"] * gp).sum() + (o["depth"] * gd).sum() + (o["normal"] * gn).sum()
            + (npk.combine_friction(leaves[2], leaves[3]) * gf).sum())
    w = torch.autograd.grad(loss, leaves)
    want = dict(half_a=w[0][live], half_b=w[1][live], friction_a=w[2][live],
                friction_b=w[3][live])
    got = dict(half_a=shp[live, 0:3], half_b=shp[live, 5:8], friction_a=shp[live, 3],
               friction_b=shp[live, 8])
    assert bool((shp[live][:, [4, 9]] == 0).all())
    shape_report("box-box", label, got, want, pose_bits)


def one_point_case(trees, seed, nb=600, ns=600, n_bs=1500, n_ss=1500):
    g = np.random.default_rng(seed)
    half = torch.tensor(g.uniform(0.2, 0.8, (nb, 3)), dtype=torch.float32)
    ax = g.normal(size=(nb, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    quat = quat_from_axis_angle(torch.tensor(ax, dtype=torch.float32), torch.tensor(
        g.uniform(-3, 3, nb), dtype=torch.float32)).contiguous()
    bpos = torch.tensor(g.normal(size=(nb, 3)) * 3, dtype=torch.float32)
    radius = torch.tensor(g.uniform(0.1, 0.6, ns), dtype=torch.float32)
    i32 = torch.int32
    bs_a = torch.tensor(g.integers(0, nb, n_bs), dtype=i32)
    bs_b = torch.tensor(g.integers(0, ns, n_bs), dtype=i32)
    spos = torch.tensor(g.normal(size=(ns, 3)), dtype=torch.float32)
    spos[bs_b.long()] = bpos[bs_a.long()] + torch.tensor(
        g.normal(size=(n_bs, 3)) * 0.6, dtype=torch.float32)
    ss_a = torch.tensor(g.integers(0, ns, n_ss), dtype=i32)
    ss_b = torch.tensor(g.integers(0, ns, n_ss), dtype=i32)
    ss_b[:5] = ss_a[:5]                      # coincident centres
    bs_valid = torch.tensor(g.uniform(size=n_bs) < 0.8)
    ss_valid = torch.tensor(g.uniform(size=n_ss) < 0.8)
    live = torch.cat([bs_valid, ss_valid])
    rows = n_bs + n_ss
    gen = torch.Generator().manual_seed(seed)
    gp, gd, gn = (torch.randn(s, generator=gen) for s in ((rows, 4, 3), (rows, 4), (rows, 3)))
    bx = argparse.Namespace(half=half, friction=torch.ones(nb),
                            body=torch.arange(nb, dtype=i32))
    sp = argparse.Namespace(radius=radius, friction=torch.ones(ns),
                            body=torch.arange(ns, dtype=i32))
    wc = argparse.Namespace(box_quat=quat, box_pos=bpos, sph_pos=spos)
    bs = argparse.Namespace(a=bs_a, b=bs_b, valid=bs_valid)
    ss = argparse.Namespace(a=ss_a, b=ss_b, valid=ss_valid)
    from nudge_tpu_torch.ops import narrowphase_1pt as p1pt
    twin = p1pt.pairs_1pt_slots_plain(bx, sp, wc, bs, ss)

    def collider_sums(adj):
        """per-collider sums of the rows' pose adjoints, in float64"""
        adj = torch.nan_to_num(adj.double() * live[:, None], nan=0.0)
        gq = torch.zeros((nb, 4), dtype=torch.float64).index_add_(0, bs_a.long(), adj[:n_bs, 3:7])
        gb = torch.zeros((nb, 3), dtype=torch.float64).index_add_(0, bs_a.long(), adj[:n_bs, 0:3])
        gs = torch.zeros((ns, 3), dtype=torch.float64)
        gs.index_add_(0, bs_b.long(), adj[:n_bs, 7:10])
        gs.index_add_(0, ss_a.long(), adj[n_bs:, 0:3])
        gs.index_add_(0, ss_b.long(), adj[n_bs:, 7:10])
        return gq, gb, gs

    def twin_grad(dt):
        q, b, s = (t.to(dt).requires_grad_() for t in (quat, bpos, spos))
        a, bb, c, d = bs_a.long(), bs_b.long(), ss_a.long(), ss_b.long()
        m1 = nps.box_sphere(half[a].to(dt), q[a], b[a], radius[bb].to(dt), s[bb])
        m2 = nps.sphere_sphere(radius[c].to(dt), s[c], radius[d].to(dt), s[d])
        loss = 0.0
        for m, sl in ((m1, slice(0, n_bs)), (m2, slice(n_bs, rows))):
            w = live[sl].to(dt)
            loss = loss + (((m["pos"] * gp[sl, 0].to(dt)).sum(1)
                            + m["depth"] * gd[sl, 0].to(dt)
                            + (m["normal"] * gn[sl].to(dt)).sum(1)) * w).sum()
        return torch.autograd.grad(loss, [q, b, s])

    want64 = twin_grad(torch.float64)
    want32 = twin_grad(torch.float32)
    names = ("quat", "box_pos", "sph_pos")
    ref = ", ".join(f"{k} {float((y.double() - z).abs().max()) / float(z.abs().max()):.2e}"
                    for k, y, z in zip(names, want32, want64))
    print(f"float32 twin autograd against the float64 twin's: {ref}", flush=True)
    adjs, outs = {}, {}
    for name, libs in trees.items():
        out = {k: torch.zeros((rows,) + row, dtype=dt) for k, (row, dt) in npk.SLOTS.items()}
        libs["narrowphase_1pt"].host_pairs_1pt(
            ptr(half), ptr(quat), ptr(bpos), ptr(bx.friction), ptr(bx.body), ptr(radius),
            ptr(spos), ptr(sp.friction), ptr(sp.body), ptr(bs_a), ptr(bs_b), ptr(bs_valid),
            ptr(ss_a), ptr(ss_b), ptr(ss_valid), nb, n_bs, n_ss,
            *[ptr(out[k]) for k in npk.SLOTS])
        outs[name] = out
        differ, f_err = against_twin(out, twin, live)
        adj = torch.full((rows, 14), float("nan"))
        libs["narrowphase_1pt"].host_pairs_1pt_bwd(
            ptr(half), ptr(quat), ptr(bpos), ptr(radius), ptr(spos), ptr(bs_a), ptr(bs_b),
            ptr(bs_valid), ptr(ss_a), ptr(ss_b), ptr(ss_valid), n_bs, n_ss, ptr(gp),
            ptr(gd), ptr(gn), ptr(adj))
        adjs[name] = adj
        dead = "NaN (unwritten)" if bool(adj[~live].isnan().all()) else "written"
        errs = [float((k - z).abs().max()) / float(z.abs().max())
                for k, z in zip(collider_sums(adj), want64)]
        lib = libs["narrowphase_1pt"]
        if hasattr(lib, "host_pairs_1pt_bwd_shape"):
            gf = torch.randn(rows, generator=gen)
            bf = torch.tensor(g.uniform(0.2, 1.0, nb), dtype=torch.float32)
            sf = torch.tensor(g.uniform(0.2, 1.0, ns), dtype=torch.float32)
            adj2 = torch.full((rows, 14), float("nan"))
            shp = torch.full((rows, 10), float("nan"))
            lib.host_pairs_1pt_bwd_shape(
                ptr(half), ptr(quat), ptr(bpos), ptr(bf), ptr(radius), ptr(spos), ptr(sf),
                ptr(bs_a), ptr(bs_b), ptr(bs_valid), ptr(ss_a), ptr(ss_b), ptr(ss_valid),
                n_bs, n_ss, ptr(gp), ptr(gd), ptr(gn), ptr(gf), ptr(adj2), ptr(shp))
            pose_bits = torch.equal(adj2[live], adj[live]) and bool(shp[~live].isnan().all())
            a_, b_, c_, d_ = bs_a.long(), bs_b.long(), ss_a.long(), ss_b.long()
            lv = [t.clone().requires_grad_() for t in
                  (half[a_], radius[b_], bf[a_], sf[b_], radius[c_], radius[d_], sf[c_],
                   sf[d_])]
            m1 = nps.box_sphere(lv[0], quat[a_], bpos[a_], lv[1], spos[b_])
            m2 = nps.sphere_sphere(lv[4], spos[c_], lv[5], spos[d_])
            loss = 0.0
            for m, fr, sl in ((m1, npk.combine_friction(lv[2], lv[3]), slice(0, n_bs)),
                              (m2, npk.combine_friction(lv[6], lv[7]), slice(n_bs, rows))):
                loss = loss + (((m["pos"] * gp[sl, 0]).sum(1) + m["depth"] * gd[sl, 0]
                                + (m["normal"] * gn[sl]).sum(1) + fr * gf[sl])
                               * live[sl]).sum()
            w = torch.autograd.grad(loss, lv)
            lb, ls = bs_valid, ss_valid
            want = dict(half=w[0][lb], radius_b=torch.cat([w[1][lb], w[5][ls]]),
                        friction_a=torch.cat([w[2][lb], w[6][ls]]),
                        friction_b=torch.cat([w[3][lb], w[7][ls]]), radius_a=w[4][ls])
            sb, ss_ = shp[:n_bs][lb], shp[n_bs:][ls]
            got = dict(half=sb[:, 0:3], radius_b=torch.cat([sb[:, 9], ss_[:, 9]]),
                       friction_a=torch.cat([sb[:, 3], ss_[:, 3]]),
                       friction_b=torch.cat([sb[:, 8], ss_[:, 8]]), radius_a=ss_[:, 4])
            zero = torch.cat([sb[:, [4, 5, 6, 7]].reshape(-1), ss_[:, [0, 1, 2, 5, 6, 7]].reshape(-1)])
            assert bool((zero == 0).all())
            shape_report("one-point", f"seed {seed}", got, want, pose_bits)
        print(f"{name}: one-point seed {seed}: {rows} rows, {int(live.sum())} live; "
              f"forward against the twin: integer fields that differ "
              f"{differ or 'none'}, floats {f_err:.2e} of the largest; "
              "per-collider sums against the float64 twin's autograd: "
              + ", ".join(f"{k} {e:.2e}" for k, e in zip(names, errs))
              + f"; dead rows {dead}", flush=True)
        assert not differ and f_err <= 1e-6 and max(errs) <= 1e-4
    if "parent" in adjs:
        a, b = adjs["committed"][live], adjs["parent"][live]
        bits = forward_bits(outs, live)
        print(f"committed vs parent: one-point seed {seed}: forward fields not "
              f"bitwise the parent's: {bits or 'none'}; backward rows "
              f"{float((a - b).abs().max()) / float(b.abs().max()):.2e} of the "
              "largest element", flush=True)
        assert not bits


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier commit unpacked with git archive")
    args = ap.parse_args()
    if shutil.which("g++") is None:
        raise SystemExit("g++ not found: the host build needs it")
    trees = {"committed": build("committed", REPO)}
    if args.parent:
        trees["parent"] = build("parent", os.path.abspath(args.parent))
    for seed, spread, tilt in ((0, 1.2, 1.0), (1, 0.9, 1.0), (2, 1.5, 0.3),
                               (3, 1.0, 0.05), (7, 1.0, 0.0)):
        box_box_case(trees, f"tumbled (seed {seed}, tilt {tilt})",
                     tumbled_pairs(4000 if tilt else 3000, seed, spread, tilt), seed)
    box_box_case(trees, "resting stack", stacked_pairs(500, 3), 3)
    for seed in (0, 1):
        one_point_case(trees, seed)


if __name__ == "__main__":
    main()
