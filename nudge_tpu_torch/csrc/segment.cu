// Fixed-order segment sums: the per-body and per-collider sums of the
// backward kernels' adjoint rows, with no float atomics.
//
// No TPU kernel: the reference differentiates its XLA twins, whose
// scatter-adds XLA sums in its own order. The backward kernels here write
// one adjoint row per item (a pair's pose inputs, a manifold's body inputs,
// a slot's static-body reads) and this kernel adds the rows that belong to
// one output row: the caller sorts the rows' keys stably (keys[e] is the
// output row of entry e, INT_MAX for entries that add nothing; perm[e] its
// source row), and one thread an output row finds its entries by binary
// search and adds them in entry order, which is the source order within a
// key. So two runs from one input are bitwise equal, and the sum equals
// the plain version's sequential index_add, bit for bit.
//
// What bounds it on an H100: bytes. The entries' rows are read once
// (scattered by perm) and each output row written once; the binary search
// adds log2(E) reads of keys a row.

#include "common.cuh"

namespace {

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
// entries e with keys[e] == r, in entry order.
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                       const float* __restrict__ vals, int n_entries, int n_out, int width,
                       int accumulate, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_out) return;
  const int lo = lower_bound_key(keys, n_entries, r);
  for (int c = 0; c < width; ++c) {
    float s = accumulate ? out[(long long)r * width + c] : 0.0f;
    for (int e = lo; e < n_entries && keys[e] == r; ++e) s = s + vals[perm[e] * width + c];
    out[(long long)r * width + c] = s;
  }
}

}  // namespace

extern "C" int nudge_segment_sum(const int* keys, const long long* perm, const float* vals,
                                 int n_entries, int n_out, int width, int accumulate,
                                 float* out, void* stream) {
  if (n_out > 0) {
    segment_sum_kernel<<<blocks_for(n_out), kThreads, 0, (cudaStream_t)stream>>>(
        keys, perm, vals, n_entries, n_out, width, accumulate, out);
  }
  return (int)cudaGetLastError();
}
