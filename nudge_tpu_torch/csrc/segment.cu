// Fixed-order segment sums: the per-body and per-collider sums of the
// backward kernels' adjoint rows, with no float atomics.
//
// No TPU kernel: the reference differentiates its XLA twins, whose
// scatter-adds XLA sums in its own order. The backward kernels here write
// one adjoint row per item (a pair's pose inputs, a manifold's body inputs,
// a slot's static-body reads) and this kernel adds the rows that belong to
// one output row: the caller sorts the rows' keys stably (keys[e] is the
// output row of entry e, INT_MAX for entries that add nothing; perm[e] its
// source row), and one warp an output row finds its entries by binary
// search and adds them column by column in entry order, which is the
// source order within a key. So two runs from one input are bitwise equal, and the sum equals
// the plain version's sequential index_add, bit for bit.
//
// What bounds it on an H100: bytes, and for a row with many entries (a
// static body: the ground is in every manifold of the pile's bottom
// layer) the latency of its walk. So a warp takes an output row, lane c
// its column c: the warp fetches 32 entries' row indices at once, each
// lane then issues its column's 32 loads together and adds them in entry
// order. The entries' rows are read once (scattered by perm) and each
// output row written once; two binary searches find a row's segment.

#include "common.cuh"

namespace {

constexpr int kMaxWidth = 32;  // columns a row: one a lane

__device__ __forceinline__ int lower_bound_key(const int* __restrict__ keys, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// out[r][c] = (accumulate ? out[r][c] : 0) + Σ vals[perm[e]][c] over the
// entries e with keys[e] == r, in entry order: warp r, lane c.
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                       const float* __restrict__ vals, int n_entries, int n_out, int width,
                       int accumulate, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (int)(t >> 5), c = (int)(t & 31);
  if (r >= n_out) return;  // whole warps
  const int lo = lower_bound_key(keys, n_entries, r);
  const int hi = lower_bound_key(keys, n_entries, r + 1);
  const bool mine = c < width;
  float s = (mine && accumulate) ? out[(long long)r * width + c] : 0.0f;
  for (int e0 = lo; e0 < hi; e0 += 32) {
    const int n = min(32, hi - e0);
    const long long row = c < n ? perm[e0 + c] : 0;  // < 2^31 rows
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long long rj = __shfl_sync(0xffffffffu, (int)row, j);
      v[j] = (mine && j < n) ? vals[rj * width + c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < n) s = s + v[j];
  }
  if (mine) out[(long long)r * width + c] = s;
}

}  // namespace

extern "C" int nudge_segment_sum(const int* keys, const long long* perm, const float* vals,
                                 int n_entries, int n_out, int width, int accumulate,
                                 float* out, void* stream) {
  if (width > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    const long long threads = 32LL * n_out;
    segment_sum_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(keys, perm, vals, n_entries, n_out, width,
                                                 accumulate, out);
  }
  return (int)cudaGetLastError();
}
