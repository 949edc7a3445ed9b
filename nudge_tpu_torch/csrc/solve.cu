// The iterated projected Gauss-Seidel contact solve.
//
// Replaces nudge_tpu/ops/solver_kernel.py: solve_packed (_solve_kernel),
// the second half of setup_solve_fused. The TPU kernel ran the whole solve
// as one sequential grid over 1,024-manifold single-color groups, with body
// velocities resident in VMEM and one-hot matmul gathers. Hopper blocks run
// in no order, so the sequence lives on the host side of one C entry: it
// enqueues solver_iters x n_colors launches of a one-thread-per-manifold
// color pass on the caller's stream, and stream order is the barrier
// between colors.
//
// Manifolds are visited through `order`, a stable sort by (color, smallest
// dynamic body id), with the color segments' offsets read once per step on
// the host. Each thread gathers v, w and the pseudo pair of both bodies,
// solves its <= 4 points in sequence (normal impulse clamped >= 0, friction
// clamped to mu·(λn + λpseudo), the split-impulse pseudo channel against
// pos_bias) and updates its accumulators. A regular color is conflict-free
// for dynamic bodies, so the thread writes its dynamic bodies directly, as
// old + (new - old), the same operations as the twin's scatter. The spill
// color may repeat a dynamic body and runs as Jacobi, as the twin does:
// every manifold reads the pre-pass state and stores its post-pass values;
// then segment_apply adds, per body and in a fixed order, first the side-a
// changes against the pre-pass state and then the side-b changes against
// the state that holds them. No float atomics anywhere.
//
// What bounds it on an H100: launch latency and memory latency. A color
// pass reads ~130 floats of constraint rows per manifold (gathered through
// `order`, not coalesced) and two 48-byte body rows; the arithmetic is
// trivial. The slice's pile runs ~20 colors x 20 sweeps = ~400 dependent
// launches per step, each short. A persistent kernel with a grid barrier
// or a captured CUDA graph, and a color-sorted copy of the rows for
// coalesced reads, are the next steps.

#include "common.cuh"

// defined in setup.cu
extern "C" int nudge_segment_apply(float* state, const int* keys, const long long* perm,
                                   const float* vals, int n, int stride, int mode,
                                   void* stream);

namespace {

struct Con {
  const float *n, *t1, *t2, *ra, *rb, *jna, *jnb, *jt1a, *jt1b, *jt2a, *jt2b;
  const float *mn, *mt1, *mt2, *bias, *pos_bias, *mu, *im_a, *im_b, *relax;
  const bool* pvalid;
  const int *body_a, *body_b;
};

struct Acc {
  float *n, *t1, *t2, *p;
};

// mode 0: write back to dynamic bodies; mode 1: store post-pass rows.
__global__ void color_pass_kernel(Con C, Acc A, float* __restrict__ velw,
                                  const long long* __restrict__ order, int start, int count,
                                  int split, int pfric, int mode, float* __restrict__ post) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const long long i = order[start + t];
  const int a = C.body_a[i], b = C.body_b[i];
  const float ima = C.im_a[i], imb = C.im_b[i];
  const float relax = C.relax[i];
  const float mu = C.mu[i];
  const V3 n = load3(C.n + 3 * i), t1 = load3(C.t1 + 3 * i), t2 = load3(C.t2 + 3 * i);

  const float* rowa = velw + kVelRow * a;
  const float* rowb = velw + kVelRow * b;
  float olda[kVelRow], oldb[kVelRow];
  for (int c = 0; c < kVelRow; ++c) {
    olda[c] = rowa[c];
    oldb[c] = rowb[c];
  }
  V3 va = v3(olda[0], olda[1], olda[2]), wa = v3(olda[3], olda[4], olda[5]);
  V3 pva = v3(olda[6], olda[7], olda[8]), pwa = v3(olda[9], olda[10], olda[11]);
  V3 vb = v3(oldb[0], oldb[1], oldb[2]), wb = v3(oldb[3], oldb[4], oldb[5]);
  V3 pvb = v3(oldb[6], oldb[7], oldb[8]), pwb = v3(oldb[9], oldb[10], oldb[11]);

  for (int p = 0; p < 4; ++p) {
    const long long ip = 4 * i + p;
    const float pm = relax * (C.pvalid[ip] ? 1.0f : 0.0f);
    const V3 ra = load3(C.ra + 3 * ip), rb = load3(C.rb + 3 * ip);
    const V3 jna = load3(C.jna + 3 * ip), jnb = load3(C.jnb + 3 * ip);
    const V3 jt1a = load3(C.jt1a + 3 * ip), jt1b = load3(C.jt1b + 3 * ip);
    const V3 jt2a = load3(C.jt2a + 3 * ip), jt2b = load3(C.jt2b + 3 * ip);
    const float mn = C.mn[ip], mt1 = C.mt1[ip], mt2 = C.mt2[ip];
    const float an = A.n[ip], at1 = A.t1[ip], at2 = A.t2[ip], pp = A.p[ip];

    const V3 vrel = sub(sub(add(vb, cross(wb, rb)), va), cross(wa, ra));
    const float vn = dot(vrel, n);
    float dln = (C.bias[ip] - vn) * mn;
    const float new_n = fmaxf(an + dln, 0.0f);
    dln = pm * (new_n - an);
    const float bound = pfric ? mu * (an + dln + pp) : mu * (an + dln + 0.0f);
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
    A.n[ip] = an + dln;
    A.t1[ip] = at1 + dlt1;
    A.t2[ip] = at2 + dlt2;

    if (split) {
      const V3 pvrel = sub(sub(add(pvb, cross(pwb, rb)), pva), cross(pwa, ra));
      const float pvn = dot(pvrel, n);
      float dlp = (C.pos_bias[ip] - pvn) * mn;
      const float new_p = fmaxf(pp + dlp, 0.0f);
      dlp = pm * (new_p - pp);
      A.p[ip] = pp + dlp;
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
  if (mode == 0) {
    if (ima > 0.0f) {
      float* wra = velw + kVelRow * a;
      for (int c = 0; c < kVelRow; ++c) wra[c] = olda[c] + (na[c] - olda[c]);
    }
    if (imb > 0.0f) {
      float* wrb = velw + kVelRow * b;
      for (int c = 0; c < kVelRow; ++c) wrb[c] = oldb[c] + (nb[c] - oldb[c]);
    }
  } else {
    float* out = post + 2 * kVelRow * i;
    for (int c = 0; c < kVelRow; ++c) {
      out[c] = na[c];
      out[kVelRow + c] = nb[c];
    }
  }
}

}  // namespace

extern "C" int nudge_solve(
    // constraint rows (manifold-major, as the plain twin's ContactConstraints)
    const float* n, const float* t1, const float* t2, const float* ra, const float* rb,
    const float* jna, const float* jnb, const float* jt1a, const float* jt1b, const float* jt2a,
    const float* jt2b, const float* mn, const float* mt1, const float* mt2, const float* bias,
    const float* pos_bias, const float* mu, const float* im_a, const float* im_b,
    const float* relax, const bool* pvalid, const int* body_a, const int* body_b,
    // state, updated in place
    float* velw, float* acc_n, float* acc_t1, float* acc_t2, float* pacc,
    // color-sorted manifold ids; host array of n_colors+1 segment offsets
    const long long* order, const int* h_offsets, int n_colors, int spill_color, int iters,
    int split, int pfric,
    // spill color: body-sorted side-a / side-b entries and a [M, 24] scratch
    const int* keys_a, const long long* perm_a, const int* keys_b, const long long* perm_b,
    float* post, int n_spill, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  Con C{n,  t1,  t2,   ra,       rb, jna,  jnb,  jt1a,  jt1b,   jt2a, jt2b,   mn,
        mt1, mt2, bias, pos_bias, mu, im_a, im_b, relax, pvalid, body_a, body_b};
  Acc A{acc_n, acc_t1, acc_t2, pacc};
  for (int it = 0; it < iters; ++it) {
    for (int c = 0; c < n_colors; ++c) {
      const int start = h_offsets[c];
      const int count = h_offsets[c + 1] - start;
      if (count <= 0) continue;
      const int mode = c == spill_color ? 1 : 0;
      color_pass_kernel<<<blocks_for(count), kThreads, 0, stream>>>(
          C, A, velw, order, start, count, split, pfric, mode, post);
      if (mode == 1) {
        nudge_segment_apply(velw, keys_a, perm_a, post, n_spill, 2 * kVelRow, 1, stream_);
        nudge_segment_apply(velw, keys_b, perm_b, post + kVelRow, n_spill, 2 * kVelRow, 1,
                            stream_);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
