// The iterated projected Gauss-Seidel contact solve: every sweep and every
// color in one launch of one thread-block cluster.
//
// Replaces nudge_tpu/ops/solver_kernel.py: solve_packed (_solve_kernel),
// the second half of setup_solve_fused. The TPU kernel ran the whole solve
// as one sequential grid over 1,024-manifold single-color groups, with body
// velocities resident in VMEM and one-hot matmul gathers. Hopper blocks run
// in no order and no SM holds the pile's velocities, so here one cluster of
// CTAs (16, the largest the hardware places, with the non-portable size
// allowed; 8, the portable size, where cudaOccupancyMaxActiveClusters says
// 16 cannot be placed; chosen once at the first launch, see
// nudge_solve_cluster) loops over sweeps and colors inside the kernel, with
// a cluster barrier (barrier.cluster arrive.release / wait.acquire) between
// colors. The color count, the segment offsets and the spill color are read
// from device memory, so the host never waits on the solve.
//
// Each color's manifolds sit in one segment of the color-sorted slots that
// setup wrote (field-major rows, csrc/common.cuh); the cluster's threads
// stride over the segment, warps interleaved over the CTAs so that a short
// color still spreads over every SM, and each warp reads 32 neighbouring
// words of each field. A slot maps to the same thread on every sweep, so
// the accumulators it updates are its own. Body velocities (velw, 48 B a
// body, <= 1 MB at 20,480 bodies) stay in device memory, L2-resident, and
// are read and written with L2 operations (__ldcg/__stcg): a write from
// one SM is seen by another after the barrier, never a stale L1 line. Each
// thread gathers v, w and the pseudo pair of both bodies, solves its <= 4
// points in sequence (normal impulse clamped >= 0, friction clamped to
// mu·(λn + λpseudo), the split-impulse pseudo channel against pos_bias),
// and, since a regular color is conflict-free for dynamic bodies, writes
// its dynamic bodies as old + (new - old), the operations of the twin's
// scatter. The spill color may repeat a dynamic body and runs as Jacobi, as
// the twin does: every manifold reads the pre-pass state and stores its
// post-pass velocities (scratch rows), a barrier, then one thread per body
// segment of the body-sorted side-a entries adds, in entry order, the
// changes of its spill-color entries against the pre-pass state; a
// barrier; then side b against the state that holds side a's changes; a
// barrier. The entry lists are setup's (every live dynamic entry): entries
// of other colors are skipped, so the per-body order is the twin's. No
// float atomics anywhere. At the end the accumulators go back to manifold
// order (zeros for manifolds that are not live).
//
// In the differentiable mode the wrapper passes a tape: each visit of a
// live slot records the state it starts from (both bodies' velw rows and
// the slot's accumulators, common.cuh kTapeRows), from which
// csrc/solve_bwd.cu replays it backward. With a null tape nothing else
// changes, so the results are bitwise those without one.
//
// What bounds it on an H100: the order. The bytes are small (~560 B of
// rows a live manifold, 64 B of accumulators, and velw: ~13 MB for the
// pile, ~4 us at 3.35 TB/s, L2-resident after the first sweep), but
// Gauss-Seidel makes sweeps x colors dependent passes, and each pass is a
// cluster barrier, an L2 round trip for velw, the manifold's 4-point
// chain of ~1,000 dependent instructions, and the release of its stores
// at the next barrier. One launch instead of one per pass and no host read
// take the launch gaps and the host off that path; what is left is the
// pass itself (PERF.md; scripts/torch_solve_probe.py times its parts).
// 256 threads a CTA is the largest count that ptxas (-Xptxas -v) fits in
// registers without a spill. Loading the next color's rows into shared
// memory with cp.async before the barrier (double-buffered, 192 threads)
// was measured and gained nothing, so the rows are read from L2 in the
// pass.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSolveThreads = 256;  // per CTA

struct SolveArgs {
  const float* rows;    // [kRows, m], slot order
  float* work;          // [kWorkRows, m], slot order: accumulators + scratch
  float* velw;          // [n, 12]
  float* out;           // [4, m, 4]: λn, λt1, λt2, pseudo λ in manifold order
  const int* offsets;   // [max_colors + 1] color segment starts; the last is the live count
  const int* n_colors;  // colors used
  const int* spill_color;
  const int* slot;  // [m] slot of each manifold
  const int *keys_a, *keys_b;
  const long long *perm_a, *perm_b;
  int m, max_colors, iters, split, pfric;
  float* tape;  // [iters, kTapeRows, m], or null: the differentiable mode's record
};

__device__ __forceinline__ void load_row(const float* p, float* r) {
  const float4* q = reinterpret_cast<const float4*>(p);
  for (int k = 0; k < 3; ++k) {
    const float4 x = __ldcg(q + k);
    r[4 * k] = x.x;
    r[4 * k + 1] = x.y;
    r[4 * k + 2] = x.z;
    r[4 * k + 3] = x.w;
  }
}

__device__ __forceinline__ void store_row(float* p, const float* r) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int k = 0; k < 3; ++k)
    __stcg(q + k, make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]));
}

// One manifold of a color pass. jacobi: store the post-pass rows instead of
// writing the bodies. With a tape, record the state the visit starts from
// (sweep `it`): csrc/solve_bwd.cu replays the visit from it.
__device__ __forceinline__ void solve_manifold(const SolveArgs& A, int s, bool jacobi, int it) {
  const long long fm = A.m;
  const float* R = A.rows + s;
  float* W = A.work + s;
  auto q = [&](int f) { return __ldg(R + f * fm); };
  const int a = __float_as_int(q(kRowBodyA));
  const int b = __float_as_int(q(kRowBodyB));
  float olda[kVelRow], oldb[kVelRow];
  load_row(A.velw + kVelRow * a, olda);
  load_row(A.velw + kVelRow * b, oldb);
  float acc[16];  // λn, λt1, λt2, pseudo λ of the 4 points (this thread's own)
#pragma unroll
  for (int f = 0; f < 16; ++f) acc[f] = W[(kWorkAccN + f) * fm];
  if (A.tape) {
    float* T = A.tape + (long long)it * kTapeRows * fm + s;
    for (int c = 0; c < kVelRow; ++c) {
      T[c * fm] = olda[c];
      T[(kVelRow + c) * fm] = oldb[c];
    }
    for (int f = 0; f < 16; ++f) T[(2 * kVelRow + f) * fm] = acc[f];
  }
  const float ima = q(kRowImA), imb = q(kRowImB);
  const float relax = q(kRowRelax);
  const float mu = q(kRowMu);
  auto ld3 = [&](int f) { return v3(q(f), q(f + 1), q(f + 2)); };
  const V3 n = ld3(kRowN), t1 = ld3(kRowT1), t2 = ld3(kRowT2);
  V3 va = v3(olda[0], olda[1], olda[2]), wa = v3(olda[3], olda[4], olda[5]);
  V3 pva = v3(olda[6], olda[7], olda[8]), pwa = v3(olda[9], olda[10], olda[11]);
  V3 vb = v3(oldb[0], oldb[1], oldb[2]), wb = v3(oldb[3], oldb[4], oldb[5]);
  V3 pvb = v3(oldb[6], oldb[7], oldb[8]), pwb = v3(oldb[9], oldb[10], oldb[11]);

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float pm = relax * q(kRowPv + p);
    const V3 ra = ld3(kRowRa + 3 * p), rb = ld3(kRowRb + 3 * p);
    const V3 jna = ld3(kRowJna + 3 * p), jnb = ld3(kRowJnb + 3 * p);
    const V3 jt1a = ld3(kRowJt1a + 3 * p), jt1b = ld3(kRowJt1b + 3 * p);
    const V3 jt2a = ld3(kRowJt2a + 3 * p), jt2b = ld3(kRowJt2b + 3 * p);
    const float mn = q(kRowMn + p), mt1 = q(kRowMt1 + p), mt2 = q(kRowMt2 + p);
    const float an = acc[kWorkAccN + p], at1 = acc[kWorkAccT1 + p];
    const float at2 = acc[kWorkAccT2 + p], pp = acc[kWorkAccP + p];

    const V3 vrel = sub(sub(add(vb, cross(wb, rb)), va), cross(wa, ra));
    const float vn = dot(vrel, n);
    float dln = (q(kRowBias + p) - vn) * mn;
    const float new_n = fmaxf(an + dln, 0.0f);
    dln = pm * (new_n - an);
    const float bound = A.pfric ? mu * (an + dln + pp) : mu * (an + dln + 0.0f);
    const float vt1 = dot(vrel, t1);
    const float new_t1 = fminf(fmaxf(at1 - vt1 * mt1, -bound), bound);
    const float dlt1 = pm * (new_t1 - at1);
    const float vt2 = dot(vrel, t2);
    const float new_t2 = fminf(fmaxf(at2 - vt2 * mt2, -bound), bound);
    const float dlt2 = pm * (new_t2 - at2);

    const V3 Pimp = add(add(scale(n, dln), scale(t1, dlt1)), scale(t2, dlt2));
    va = sub(va, scale(Pimp, ima));
    vb = add(vb, scale(Pimp, imb));
    wa = sub(wa, add(add(scale(jna, dln), scale(jt1a, dlt1)), scale(jt2a, dlt2)));
    wb = add(wb, add(add(scale(jnb, dln), scale(jt1b, dlt1)), scale(jt2b, dlt2)));
    W[(kWorkAccN + p) * fm] = an + dln;
    W[(kWorkAccT1 + p) * fm] = at1 + dlt1;
    W[(kWorkAccT2 + p) * fm] = at2 + dlt2;

    if (A.split) {
      const V3 pvrel = sub(sub(add(pvb, cross(pwb, rb)), pva), cross(pwa, ra));
      const float pvn = dot(pvrel, n);
      float dlp = (q(kRowPosBias + p) - pvn) * mn;
      const float new_p = fmaxf(pp + dlp, 0.0f);
      dlp = pm * (new_p - pp);
      W[(kWorkAccP + p) * fm] = pp + dlp;
      const V3 Pp = scale(n, dlp);
      pva = sub(pva, scale(Pp, ima));
      pvb = add(pvb, scale(Pp, imb));
      pwa = sub(pwa, scale(jna, dlp));
      pwb = add(pwb, scale(jnb, dlp));
    }
  }

  const float na[kVelRow] = {va.x,  va.y,  va.z,  wa.x,  wa.y,  wa.z,
                             pva.x, pva.y, pva.z, pwa.x, pwa.y, pwa.z};
  const float nb[kVelRow] = {vb.x,  vb.y,  vb.z,  wb.x,  wb.y,  wb.z,
                             pvb.x, pvb.y, pvb.z, pwb.x, pwb.y, pwb.z};
  if (!jacobi) {
    float r[kVelRow];
    if (ima > 0.0f) {
      for (int c = 0; c < kVelRow; ++c) r[c] = olda[c] + (na[c] - olda[c]);
      store_row(A.velw + kVelRow * a, r);
    }
    if (imb > 0.0f) {
      for (int c = 0; c < kVelRow; ++c) r[c] = oldb[c] + (nb[c] - oldb[c]);
      store_row(A.velw + kVelRow * b, r);
    }
  } else {
    for (int c = 0; c < kVelRow; ++c) {
      __stcg(W + (kWorkScratch + c) * fm, na[c]);
      __stcg(W + (kWorkScratch + kVelRow + c) * fm, nb[c]);
    }
  }
}

// The spill color's Jacobi sum for one side: one thread per body segment of
// the stably body-sorted entries; it adds, in entry order, (post - pre) of
// the entries whose slot lies in [lo, hi), the spill color's segment.
__device__ __forceinline__ void spill_side(const SolveArgs& A, const int* keys,
                                           const long long* perm, int side, int lo, int hi,
                                           int g, int stride) {
  const long long fm = A.m;
  const float* post = A.work + (kWorkScratch + side * kVelRow) * fm;
  for (int e = g; e < A.m; e += stride) {
    const int body = keys[e];
    if (body == 0x7fffffff) break;
    if (e > 0 && keys[e - 1] == body) continue;  // not the segment's first entry
    float base[kVelRow], acc[kVelRow];
    bool any = false;
    for (int j = e; j < A.m && keys[j] == body; ++j) {
      const int s = A.slot[perm[j]];
      if (s < lo || s >= hi) continue;
      if (!any) {
        load_row(A.velw + kVelRow * body, base);
        for (int c = 0; c < kVelRow; ++c) acc[c] = base[c];
        any = true;
      }
      for (int c = 0; c < kVelRow; ++c) acc[c] = acc[c] + (__ldcg(post + c * fm + s) - base[c]);
    }
    if (any) store_row(A.velw + kVelRow * body, acc);
  }
}

__global__ void __launch_bounds__(kSolveThreads) solve_kernel(SolveArgs A) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int stride = nb * kSolveThreads;
  // this thread's offset in a round of a segment: warps interleaved over
  // the CTAs, so a short color still spreads over every SM of the cluster
  const int g = ((threadIdx.x >> 5) * nb + (int)cluster.block_rank()) * 32 + (threadIdx.x & 31);
  // Every thread reads the same offsets, so the control flow around the
  // barriers is uniform.
  const int n_colors = max(*A.n_colors, 1);
  const int spill = *A.spill_color;
  for (int it = 0; it < A.iters; ++it) {
    for (int c = 0; c < n_colors; ++c) {
      const int lo = A.offsets[c], hi = A.offsets[c + 1];
      if (lo == hi) continue;
      const bool jacobi = c == spill;
      for (int s = lo + g; s < hi; s += stride) solve_manifold(A, s, jacobi, it);
      cluster.sync();
      if (jacobi) {
        spill_side(A, A.keys_a, A.perm_a, 0, lo, hi, g, stride);
        cluster.sync();
        spill_side(A, A.keys_b, A.perm_b, 1, lo, hi, g, stride);
        cluster.sync();
      }
    }
  }
  // the accumulators back in manifold order
  const long long fm = A.m;
  const int live = A.offsets[A.max_colors];
  for (int i = g; i < A.m; i += stride) {
    const int s = A.slot[i];
    const bool on = s < live;
    for (int k = 0; k < 4; ++k) {
      for (int p = 0; p < 4; ++p) {
        const float x = on ? __ldcg(A.work + (4 * k + p) * fm + s) : 0.0f;
        A.out[(k * fm + i) * 4 + p] = x;
      }
    }
  }
}

int g_cluster = 0;  // the cluster size, chosen at the first launch

cudaError_t choose_solve_cluster() {
  return choose_cluster(solve_kernel, kSolveThreads, 0, &g_cluster);
}

}  // namespace

// The cluster size the solve launches with (0 before the first choice).
extern "C" int nudge_solve_cluster() {
  if (choose_solve_cluster() != cudaSuccess) return 0;
  return g_cluster;
}

extern "C" int nudge_solve(
    // constraint rows and work rows from setup (slot order), updated in place
    const float* rows, float* work,
    // body velocities [n, 12], updated in place; accumulators out, manifold order
    float* velw, float* out,
    // color segments (device): offsets[max_colors + 1], color count, spill color
    const int* offsets, const int* n_colors, const int* spill_color,
    // slot of each manifold; body-sorted side-a / side-b entries (setup's)
    const int* slot, const int* keys_a, const long long* perm_a, const int* keys_b,
    const long long* perm_b, int m, int max_colors, int iters, int split, int pfric,
    // the tape [iters, kTapeRows, m] (differentiable mode), or null
    float* tape, void* stream_) {
  if (m <= 0) return 0;
  cudaError_t err = choose_solve_cluster();
  if (err != cudaSuccess) return (int)err;
  SolveArgs A{rows,   work,   velw,   out,  offsets, n_colors, spill_color,
              slot,   keys_a, keys_b, perm_a, perm_b, m,     max_colors,
              iters,  split,  pfric,    tape};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(g_cluster, kSolveThreads, 0, (cudaStream_t)stream_, &attr);
  err = cudaLaunchKernelEx(&cfg, solve_kernel, A);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
