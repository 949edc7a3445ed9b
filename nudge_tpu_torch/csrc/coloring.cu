// Greedy Luby manifold coloring: every claim round in one launch.
//
// Replaces nudge_tpu/ops/coloring_kernel.py: color_manifolds_pallas
// (_color_kernel). The TPU kernel ran its rounds in one pallas_call with a
// while loop, scattering claims and gathering them back through one-hot
// matmuls over membership-bitmask tile windows; here one block of 1024
// threads loops over the manifolds and runs each round in three steps:
//   1. reset the per-body claim table to INT_MAX;
//   2. every uncolored valid manifold i atomicMin's its token i ^ h[r] onto
//      each of its dynamic bodies;
//   3. a manifold whose token holds both claims takes color r.
// __syncthreads separates the steps; the barrier after step 2 also counts
// the uncolored manifolds (__syncthreads_or), and the loop stops when none
// is left or after n_rounds rounds, as the reference's loop does. int32
// atomicMin does not depend on the order of the claims, so the colors equal
// the plain twin's (ops/coloring_kernel.py: color_rounds_plain) bit for bit.
// The round constants h[r] are computed on the host: the hash needs int32
// wraparound and an arithmetic shift.
//
// What bounds it on an H100: one SM. At 61,440 manifolds a round is ~60
// strided passes of 1024 threads, each a few scattered loads and two
// atomics into the L2-resident claim table, and rounds run in sequence.
// The claim table stays in global memory (read back with __ldcg, past L1,
// after the atomics) so that any body count fits; a shared-memory table
// and a grid-wide cooperative version are the next steps if it matters.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kColorThreads = 1024;

__global__ void __launch_bounds__(kColorThreads)
    color_kernel(const int* __restrict__ body_a, const int* __restrict__ body_b,
                 const bool* __restrict__ valid, const bool* __restrict__ dyn,
                 const int* __restrict__ hashes, int m, int n_bodies, int n_rounds,
                 int* __restrict__ claim, int* __restrict__ color) {
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  for (int i = tid; i < m; i += stride) color[i] = -1;
  for (int r = 0; r < n_rounds; ++r) {
    for (int j = tid; j < n_bodies; j += stride) claim[j] = INT_MAX;
    __syncthreads();
    const int h = hashes[r];
    int pending = 0;
    for (int i = tid; i < m; i += stride) {
      if (!valid[i] || color[i] >= 0) continue;
      pending = 1;
      const int tok = i ^ h;
      const int a = body_a[i], b = body_b[i];
      if (dyn[a]) atomicMin(claim + a, tok);
      if (dyn[b]) atomicMin(claim + b, tok);
    }
    if (!__syncthreads_or(pending)) break;
    for (int i = tid; i < m; i += stride) {
      if (!valid[i] || color[i] >= 0) continue;
      const int tok = i ^ h;
      const int a = body_a[i], b = body_b[i];
      const bool ok_a = !dyn[a] || __ldcg(claim + a) == tok;
      const bool ok_b = !dyn[b] || __ldcg(claim + b) == tok;
      if (ok_a && ok_b) color[i] = r;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int nudge_color_rounds(const int* body_a, const int* body_b, const bool* valid,
                                  const bool* dyn, const int* hashes, int m, int n_bodies,
                                  int n_rounds, int* claim, int* color, void* stream) {
  if (m > 0) {
    color_kernel<<<1, kColorThreads, 0, (cudaStream_t)stream>>>(
        body_a, body_b, valid, dyn, hashes, m, n_bodies, n_rounds, claim, color);
  }
  return (int)cudaGetLastError();
}
