"""64-bit atomicMin into a thread-block cluster's distributed shared memory.

    python3 scripts/dsm_atomic_probe.py

The coloring kernel (nudge_tpu_torch/csrc/coloring.cu) keeps its claim
tables in global memory. Tables in the cluster's distributed shared memory
(DSM), claimed with atomicMin of 64-bit keys through
cluster.map_shared_rank, gave wrong and run-to-run different colors. This
probe isolates that operation from the coloring's round protocol: one
cluster of 1,024-thread CTAs (16 where the hardware places them, else 8),
a table of 4,096 64-bit slots a CTA (20,481 bodies, body j at slot j /
cluster of CTA j % cluster), 16 claims a thread of keys shaped as the
coloring's ((~round) << 32 | token, three rounds), then one cluster
barrier and a read-back of each CTA's table by its neighbour through DSM.
The result is held against the minima computed on the host, ten launches
a mode:

  generic_dsm     atomicMin(unsigned long long*) on the generic pointer
                  map_shared_rank returns (what the DSM coloring did);
  ptx_cluster     atom.shared::cluster.min.u64 on the address mapa gives;
  cas_dsm         a 64-bit atomicCAS loop on the generic DSM pointer;
  generic_own     atomicMin on a generic pointer into the CTA's own shared
                  memory (each CTA claims only its own bodies);
  shared_own      atomicMin on the CTA's own __shared__ array, known shared
                  to the compiler (each CTA claims only its own bodies);
  generic_dsm_32  32-bit atomicMin of the keys' low words through
                  map_shared_rank (against the low words' minima);
  global          atomicMin into global memory (the shipped kernel's).

Prints the card's name and power limit, nvcc's version, the atomic
instructions of each mode's kernel (cuobjdump -sass), then one line a
mode: slots that
differ from the host's minima in each launch, and whether the ten launches
agree. Needs one NVIDIA GPU and nvcc; builds into build/dsm_probe/
(git-ignored).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "dsm_probe")

SOURCE = r"""
#include <cooperative_groups.h>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace cg = cooperative_groups;

constexpr int kThreads = 1024, kSlots = 4096, kClaims = 16, kBodies = 20481, kRounds = 3;
constexpr unsigned long long kNone = ~0ull;
enum Mode { GENERIC_DSM, PTX_CLUSTER, CAS_DSM, GENERIC_OWN, SHARED_OWN, GENERIC_DSM_32, GLOBAL,
            N_MODES };
const char* kNames[N_MODES] = {"generic_dsm", "ptx_cluster", "cas_dsm", "generic_own",
                               "shared_own", "generic_dsm_32", "global"};

__host__ __device__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}
// claim j of thread t of the cluster: its body and key
__host__ __device__ int claim_body(int t, int j, int cluster, bool own) {
  const int b = (int)(mix(2u * (unsigned)(t * kClaims + j) + 1u) % kBodies);
  if (!own) return b;
  // a body of the thread's own CTA: same slot, rank forced to the CTA's
  const int rank = (t / 32) % cluster;
  const int slot = b / cluster;
  const int body = slot * cluster + rank;
  return body < kBodies ? body : rank;
}
__host__ __device__ unsigned long long claim_key(int t, int j) {
  const unsigned tok = mix(2u * (unsigned)(t * kClaims + j)) & 0x7fffffffu;
  const unsigned r = (unsigned)(j % kRounds);
  return ((unsigned long long)(~r) << 32) | tok;
}

template <int mode>
__global__ void probe(unsigned long long* global_table, unsigned long long* out) {
  extern __shared__ unsigned long long s_table[];  // [kSlots] 64-bit, then [kSlots] 32-bit
  unsigned* s_table32 = reinterpret_cast<unsigned*>(s_table + kSlots);
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // warps interleaved over the CTAs, as in the coloring kernel
  const int t = ((threadIdx.x >> 5) * nb + rank) * 32 + (threadIdx.x & 31);
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    s_table[i] = kNone;
    s_table32[i] = ~0u;
  }
  cluster.sync();
  const bool own = mode == GENERIC_OWN || mode == SHARED_OWN;
  for (int j = 0; j < kClaims; ++j) {
    const int body = claim_body(t, j, nb, own);
    const unsigned long long key = claim_key(t, j);
    const int slot = body / nb, owner = body % nb;
    switch (mode) {
      case GENERIC_DSM:
        atomicMin(cluster.map_shared_rank(s_table + slot, owner), key);
        break;
      case PTX_CLUSTER: {
#ifndef SKIP_PTX
        const unsigned local = (unsigned)__cvta_generic_to_shared(s_table + slot);
        unsigned remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(owner));
        unsigned long long old;
        asm volatile("atom.shared::cluster.min.u64 %0, [%1], %2;"
                     : "=l"(old) : "r"(remote), "l"(key) : "memory");
#endif
        break;
      }
      case CAS_DSM: {
        unsigned long long* p = cluster.map_shared_rank(s_table + slot, owner);
        unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(p);
        while (key < cur) {
          const unsigned long long seen = atomicCAS(p, cur, key);
          if (seen == cur) break;
          cur = seen;
        }
        break;
      }
      case GENERIC_OWN:
        atomicMin(cluster.map_shared_rank(s_table + slot, rank), key);
        break;
      case SHARED_OWN:
        atomicMin(s_table + slot, key);
        break;
      case GENERIC_DSM_32:
        atomicMin(cluster.map_shared_rank(s_table32 + slot, owner),
                  (unsigned)key);
        break;
      case GLOBAL:
        atomicMin(global_table + body, key);
        break;
    }
  }
  cluster.sync();
  if (mode == GLOBAL) return;
  // the neighbour's table, read through DSM
  const int src = (rank + 1) % nb;
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const int body = i * nb + src;
    if (body >= kBodies) continue;
    out[body] = mode == GENERIC_DSM_32
                    ? (unsigned long long)*cluster.map_shared_rank(s_table32 + i, src)
                    : *cluster.map_shared_rank(s_table + i, src);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

#define CHECK(x)                                                             \
  do {                                                                       \
    cudaError_t e_ = (x);                                                    \
    if (e_ != cudaSuccess) {                                                 \
      fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e_));               \
      exit(1);                                                               \
    }                                                                        \
  } while (0)

typedef void (*Kernel)(unsigned long long*, unsigned long long*);
const Kernel kKernels[N_MODES] = {probe<0>, probe<1>, probe<2>, probe<3>,
                                  probe<4>, probe<5>, probe<6>};

int main() {
  const size_t smem = kSlots * (sizeof(unsigned long long) + sizeof(unsigned));
  for (int mode = 0; mode < N_MODES; ++mode) {
    CHECK(cudaFuncSetAttribute(kKernels[mode], cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    CHECK(cudaFuncSetAttribute(kKernels[mode], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem));
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  attr.id = cudaLaunchAttributeClusterDimension;
  int cluster = 16, clusters = 0;
  for (;;) {
    cfg.gridDim = dim3(cluster);
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    CHECK(cudaOccupancyMaxActiveClusters(&clusters, kKernels[0], &cfg));
    if (clusters >= 1 || cluster == 8) break;
    cluster = 8;
  }
  printf("cluster of %d CTAs x %d threads, %d bodies, %d claims\n", cluster, kThreads, kBodies,
         cluster * kThreads * kClaims);
  unsigned long long *d_table, *d_out;
  CHECK(cudaMalloc(&d_table, kBodies * sizeof(unsigned long long)));
  CHECK(cudaMalloc(&d_out, kBodies * sizeof(unsigned long long)));
  int failed = 0;
  for (int mode = 0; mode < N_MODES; ++mode) {
    const bool own = mode == GENERIC_OWN || mode == SHARED_OWN;
    const bool low = mode == GENERIC_DSM_32;  // minima of the keys' low words
    std::vector<unsigned long long> want(kBodies, low ? 0xffffffffull : kNone);
    for (int t = 0; t < cluster * kThreads; ++t)
      for (int j = 0; j < kClaims; ++j) {
        const int b = claim_body(t, j, cluster, own);
        const unsigned long long k = low ? (unsigned)claim_key(t, j) : claim_key(t, j);
        if (k < want[b]) want[b] = k;
      }
    std::vector<unsigned long long> got(kBodies), first(kBodies);
    char diffs[256] = "";
    bool agree = true;
    for (int launch = 0; launch < 10; ++launch) {
      CHECK(cudaMemset(d_table, 0xff, kBodies * sizeof(unsigned long long)));
      CHECK(cudaMemset(d_out, 0xff, kBodies * sizeof(unsigned long long)));
      CHECK(cudaLaunchKernelEx(&cfg, kKernels[mode], d_table, d_out));
      CHECK(cudaDeviceSynchronize());
      CHECK(cudaMemcpy(got.data(), mode == GLOBAL ? d_table : d_out,
                       kBodies * sizeof(unsigned long long), cudaMemcpyDeviceToHost));
      int bad = 0;
      for (int b = 0; b < kBodies; ++b) bad += got[b] != want[b];
      if (launch == 0)
        first = got;
      else
        agree = agree && got == first;
      snprintf(diffs + strlen(diffs), sizeof(diffs) - strlen(diffs), "%s%d", launch ? " " : "",
               bad);
      failed += bad > 0;
    }
    printf("%s: slots differing from the host's minima, by launch: %s; ten launches agree: %s\n",
           kNames[mode], diffs, agree ? "yes" : "no");
  }
  printf("wrong launches over all modes: %d\n", failed);
  return 0;
}
"""


MODES = ("generic_dsm", "ptx_cluster", "cas_dsm", "generic_own", "shared_own",
         "generic_dsm_32", "global")


def nvcc():
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    version = subprocess.run([nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(version.splitlines()[-1], flush=True)
    os.makedirs(OUT, exist_ok=True)
    src, exe = os.path.join(OUT, "probe.cu"), os.path.join(OUT, "probe")
    with open(src, "w") as f:
        f.write(SOURCE)
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-o", exe, src]
    if subprocess.run(cmd).returncode:
        print("ptx_cluster does not build: built without it", flush=True)
        subprocess.run(cmd + ["-DSKIP_PTX"], check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", exe], capture_output=True,
                          text=True).stdout
    for part in sass.split("Function : ")[1:]:
        mode = re.search(r"ILi(\d)E", part.splitlines()[0])
        ops = sorted({m.group(1) for m in re.finditer(
            r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[\w.]+)", part)})
        if mode:
            print(f"{MODES[int(mode.group(1))]}: atomics in SASS: "
                  f"{', '.join(ops) or 'none'}", flush=True)
    res = subprocess.run([exe], timeout=300)
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
