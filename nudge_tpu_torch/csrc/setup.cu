// Contact-constraint setup, written straight into the solve's color-sorted
// field-major rows, and the warm start's deterministic per-body sum.
//
// Replaces nudge_tpu/ops/setup_kernel.py: setup_pallas (_make_setup_kernel),
// the first half of setup_solve_fused. Per manifold the kernel gathers body
// pos, quat, inverse inertia, inverse mass and pre-step velocity by int32
// index; builds the contact frame n/t1/t2; computes lever arms, the angular
// responses I⁻¹(r×d), the effective masses and the biases (Baumgarte, the
// approach-gated deep bias, the ungated anti-creep floor, the pseudo bias,
// restitution); projects and clamps the warm and warm-pseudo impulses into
// the accumulators.
//
// Layout, as the TPU kernel wrote it for its solve: the launch walks the
// color-sorted slots s < live (live = offsets[max_colors], read on the
// device) and takes the manifold i = order[s]; every row the solve reads is
// stored at rows[f * M + s] (common.cuh kRow*), the accumulators and the
// warm-start velocity changes at work[f * M + s] (kWork*). Walking slots
// rather than manifolds makes every store coalesce: neighbouring threads
// write neighbouring words of each field, and only the per-manifold reads
// (~156 B) are gathered. Manifold slots past `live` are never touched; t1/t2
// are also written in manifold order (`frame`, for the cache's world
// impulse), whose non-live rows the caller zeroes.
//
// The warm-start velocity change does not depend on velocities, so the
// kernel stores it per manifold and side (12 floats: v, w, pseudo v,
// pseudo w), and warm_apply adds those into the bodies: one thread per
// body, which finds its entries in the stably body-sorted side-a and side-b
// lists by binary search and sums them in list order (manifold order), side
// a before side b. That is the order of the plain twin's sequential
// index_add, and there are no float atomics, so runs repeat bit for bit.
//
// What bounds it on an H100: memory. Per live manifold ~156 B are read and
// ~656 B written (139 row words, 16 accumulators, 24 delta words, 24 B of
// frame); at the pile's 11,971 live manifolds that is ~10 MB, ~3 us at
// 3.35 TB/s; the arithmetic (three effective masses per point) is far
// below the float rate. One thread per manifold with ~2,000 dependent
// instructions, so at this size the chain's latency, not the bytes, sets
// the time.

#include "common.cuh"

namespace {

struct SetupParams {
  float bod;  // baumgarte / dt
  float slop, max_bias_vel, deep_bias_depth, deep_bias_gate, ungated_depth, ungated_vel;
  float max_pseudo_vel, restitution;
  int split, warm_start, use_pwarm;
};

constexpr int kSetupBlocks = 264;  // 2 per SM; a grid-stride loop covers the rest

__device__ __forceinline__ void eff(V3 ra, V3 rb, V3 d, Q4 qa, Q4 qb, V3 iia, V3 iib, float ima,
                                    float imb, V3* ja, V3* jb, float* m) {
  V3 rna = cross(ra, d);
  V3 rnb = cross(rb, d);
  *ja = inv_inertia_apply(qa, iia, rna);
  *jb = inv_inertia_apply(qb, iib, rnb);
  float k = ima + imb + dot(rna, *ja) + dot(rnb, *jb);
  *m = k > 0.0f ? 1.0f / fmaxf(k, 1e-12f) : 0.0f;
}

__global__ void setup_kernel(const float* __restrict__ bpos, const float* __restrict__ bquat,
                             const float* __restrict__ bvel, const float* __restrict__ bang,
                             const float* __restrict__ binvm, const float* __restrict__ binvi,
                             const int* __restrict__ body_a, const int* __restrict__ body_b,
                             const float* __restrict__ normal, const float* __restrict__ fric,
                             const float* __restrict__ mpos, const float* __restrict__ mdepth,
                             const bool* __restrict__ pvalid, const float* __restrict__ warm,
                             const float* __restrict__ pwarm_in, const float* __restrict__ relax,
                             const long long* __restrict__ order, const int* __restrict__ offsets,
                             int max_colors, int m, SetupParams P, float* __restrict__ rows,
                             float* __restrict__ work, float* __restrict__ frame) {
  const int live = offsets[max_colors];
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < live; s += gridDim.x * blockDim.x) {
    const long long i = order[s];
    float* R = rows + s;  // R[f * m]: field f of this slot
    float* W = work + s;
    const long long fm = m;
    const int a = body_a[i], b = body_b[i];
    const V3 n = load3(normal + 3 * i);
    V3 t1, t2;
    orthonormal_basis(n, &t1, &t2);
    store3(frame + 3 * i, t1);
    store3(frame + 3 * (fm + i), t2);
    const V3 pa = load3(bpos + 3 * a), pb = load3(bpos + 3 * b);
    const Q4 qa = load4(bquat + 4 * a), qb = load4(bquat + 4 * b);
    const V3 iia = load3(binvi + 3 * a), iib = load3(binvi + 3 * b);
    const float ima = binvm[a], imb = binvm[b];
    const V3 va0 = load3(bvel + 3 * a), vb0 = load3(bvel + 3 * b);
    const V3 wa0 = load3(bang + 3 * a), wb0 = load3(bang + 3 * b);
    const float mu = fric[i];
    for (int k = 0; k < 3; ++k) {
      R[(kRowN + k) * fm] = get(n, k);
      R[(kRowT1 + k) * fm] = get(t1, k);
      R[(kRowT2 + k) * fm] = get(t2, k);
    }
    R[kRowMu * fm] = mu;
    R[kRowImA * fm] = ima;
    R[kRowImB * fm] = imb;
    R[kRowRelax * fm] = relax[i];
    R[kRowBodyA * fm] = __int_as_float(a);
    R[kRowBodyB * fm] = __int_as_float(b);

    // Σ over points (in point order) of the warm impulses' effects
    float sn = 0.0f, s1 = 0.0f, s2 = 0.0f, sp = 0.0f;
    V3 dwa = v3(0.0f, 0.0f, 0.0f), dwb = dwa, pdwa = dwa, pdwb = dwa;

    for (int p = 0; p < 4; ++p) {
      const long long ip = 4 * i + p;
      const bool pv = pvalid[ip];
      const V3 cp = load3(mpos + 3 * ip);
      const V3 ra = sub(cp, pa), rb = sub(cp, pb);
      V3 jna, jnb, jt1a, jt1b, jt2a, jt2b;
      float mn, mt1, mt2;
      eff(ra, rb, n, qa, qb, iia, iib, ima, imb, &jna, &jnb, &mn);
      eff(ra, rb, t1, qa, qb, iia, iib, ima, imb, &jt1a, &jt1b, &mt1);
      eff(ra, rb, t2, qa, qb, iia, iib, ima, imb, &jt2a, &jt2b, &mt2);

      const float depth = mdepth[ip];
      const float baum = fminf(P.bod * fmaxf(depth - P.slop, 0.0f), P.max_bias_vel);
      float vn0 = 0.0f;
      const bool need_vn0 = P.restitution > 0.0f || (P.split && P.deep_bias_gate >= 0.0f);
      if (need_vn0) {
        V3 vrel0 = sub(add(vb0, cross(wb0, rb)), add(va0, cross(wa0, ra)));
        vn0 = dot(vrel0, n);
      }
      float bias, pos_bias;
      if (P.split) {
        bias = fminf(P.bod * fmaxf(depth - P.deep_bias_depth, 0.0f), P.max_bias_vel);
        if (P.deep_bias_gate >= 0.0f) {
          bias = fminf(bias, fmaxf(-vn0 - P.deep_bias_gate, 0.0f));
          bias = fmaxf(bias, fminf(P.bod * fmaxf(depth - P.ungated_depth, 0.0f), P.ungated_vel));
        }
        pos_bias = fminf(P.bod * fmaxf(depth - P.slop, 0.0f), P.max_pseudo_vel);
      } else {
        bias = baum;
        pos_bias = 0.0f;
      }
      if (P.restitution > 0.0f) bias = fmaxf(bias, P.restitution * fmaxf(-vn0 - 1.0f, 0.0f));

      float an = 0.0f, at1 = 0.0f, at2 = 0.0f;
      if (P.warm_start) {
        const V3 wi = load3(warm + 3 * ip);
        float n_ = fmaxf(dot(wi, n), 0.0f);
        float bound = mu * n_;
        float x1 = fminf(fmaxf(dot(wi, t1), -bound), bound);
        float x2 = fminf(fmaxf(dot(wi, t2), -bound), bound);
        an = pv ? n_ : 0.0f;
        at1 = pv ? x1 : 0.0f;
        at2 = pv ? x2 : 0.0f;
      }
      const float pw = (P.use_pwarm && pv) ? pwarm_in[ip] : 0.0f;

      for (int k = 0; k < 3; ++k) {
        const int c = 3 * p + k;
        R[(kRowRa + c) * fm] = get(ra, k);
        R[(kRowRb + c) * fm] = get(rb, k);
        R[(kRowJna + c) * fm] = get(jna, k);
        R[(kRowJnb + c) * fm] = get(jnb, k);
        R[(kRowJt1a + c) * fm] = get(jt1a, k);
        R[(kRowJt1b + c) * fm] = get(jt1b, k);
        R[(kRowJt2a + c) * fm] = get(jt2a, k);
        R[(kRowJt2b + c) * fm] = get(jt2b, k);
      }
      R[(kRowMn + p) * fm] = mn;
      R[(kRowMt1 + p) * fm] = mt1;
      R[(kRowMt2 + p) * fm] = mt2;
      R[(kRowBias + p) * fm] = bias;
      R[(kRowPosBias + p) * fm] = pos_bias;
      R[(kRowPwarm + p) * fm] = pw;
      R[(kRowPv + p) * fm] = pv ? 1.0f : 0.0f;
      W[(kWorkAccN + p) * fm] = an;
      W[(kWorkAccT1 + p) * fm] = at1;
      W[(kWorkAccT2 + p) * fm] = at2;
      W[(kWorkAccP + p) * fm] = pw;

      // per-point angular terms, then the running sums over points
      const V3 ta = add(add(scale(jna, an), scale(jt1a, at1)), scale(jt2a, at2));
      const V3 tb = add(add(scale(jnb, an), scale(jt1b, at1)), scale(jt2b, at2));
      const V3 pta = scale(jna, pw), ptb = scale(jnb, pw);
      if (p == 0) {
        sn = an;
        s1 = at1;
        s2 = at2;
        sp = pw;
        dwa = ta;
        dwb = tb;
        pdwa = pta;
        pdwb = ptb;
      } else {
        sn = sn + an;
        s1 = s1 + at1;
        s2 = s2 + at2;
        sp = sp + pw;
        dwa = add(dwa, ta);
        dwb = add(dwb, tb);
        pdwa = add(pdwa, pta);
        pdwb = add(pdwb, ptb);
      }
    }

    const V3 Pw = add(add(scale(n, sn), scale(t1, s1)), scale(t2, s2));
    const V3 Pp = scale(n, sp);
    const V3 da[4] = {scale(neg(Pw), ima), neg(dwa), scale(neg(Pp), ima), neg(pdwa)};
    const V3 db[4] = {scale(Pw, imb), dwb, scale(Pp, imb), pdwb};
    for (int q = 0; q < 4; ++q) {
      for (int k = 0; k < 3; ++k) {
        W[(kWorkScratch + 3 * q + k) * fm] = get(da[q], k);
        W[(kWorkScratch + kVelRow + 3 * q + k) * fm] = get(db[q], k);
      }
    }
  }
}

// First index of `v` in the ascending keys[0..n), or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int v) {
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

// velw[body] = (v, w, 0, 0) + Σ side-a deltas + Σ side-b deltas, each in the
// order of its stably sorted entry list (keys[e]: the body of entry e, or
// INT_MAX for entries that add nothing; perm[e]: its manifold).
__global__ void warm_apply_kernel(const float* __restrict__ bvel, const float* __restrict__ bang,
                                  const int* __restrict__ keys_a,
                                  const long long* __restrict__ perm_a,
                                  const int* __restrict__ keys_b,
                                  const long long* __restrict__ perm_b,
                                  const int* __restrict__ slot, const float* __restrict__ work,
                                  int m, int n, float* __restrict__ velw) {
  const int body = blockIdx.x * blockDim.x + threadIdx.x;
  if (body >= n) return;
  float acc[kVelRow];
  for (int k = 0; k < 3; ++k) {
    acc[k] = bvel[3 * body + k];
    acc[3 + k] = bang[3 * body + k];
    acc[6 + k] = 0.0f;
    acc[9 + k] = 0.0f;
  }
  const long long fm = m;
  for (int side = 0; side < 2; ++side) {
    const int* keys = side ? keys_b : keys_a;
    const long long* perm = side ? perm_b : perm_a;
    const float* d = work + (kWorkScratch + side * kVelRow) * fm;
    for (int j = lower_bound(keys, m, body); j < m && keys[j] == body; ++j) {
      const int s = slot[perm[j]];
      for (int c = 0; c < kVelRow; ++c) acc[c] = acc[c] + d[c * fm + s];
    }
  }
  for (int c = 0; c < kVelRow; ++c) velw[kVelRow * body + c] = acc[c];
}

}  // namespace

extern "C" int nudge_setup(
    // bodies
    const float* bpos, const float* bquat, const float* bvel, const float* bang,
    const float* binvm, const float* binvi,
    // manifolds, their warm starts and under-relaxation
    const int* body_a, const int* body_b, const float* normal, const float* fric,
    const float* mpos, const float* mdepth, const bool* pvalid, const float* warm,
    const float* pwarm_in, const float* relax,
    // the color-sorted order, its segment offsets and the body-sorted entries
    const long long* order, const int* offsets, const int* slot, const int* keys_a,
    const long long* perm_a, const int* keys_b, const long long* perm_b, int max_colors, int m,
    int n,
    // constants
    float bod, float slop, float max_bias_vel, float deep_bias_depth, float deep_bias_gate,
    float ungated_depth, float ungated_vel, float max_pseudo_vel, float restitution,
    int split, int warm_start, int use_pwarm,
    // outputs: rows[kRows, m], work[kWorkRows, m], frame[2, m, 3], velw[n, 12]
    float* rows, float* work, float* frame, float* velw, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  SetupParams P{bod,           slop,        max_bias_vel,   deep_bias_depth, deep_bias_gate,
                ungated_depth, ungated_vel, max_pseudo_vel, restitution,     split,
                warm_start,    use_pwarm};
  if (m > 0) {
    const int blocks = blocks_for(m) < kSetupBlocks ? blocks_for(m) : kSetupBlocks;
    setup_kernel<<<blocks, kThreads, 0, stream>>>(
        bpos, bquat, bvel, bang, binvm, binvi, body_a, body_b, normal, fric, mpos, mdepth,
        pvalid, warm, pwarm_in, relax, order, offsets, max_colors, m, P, rows, work, frame);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    warm_apply_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        bvel, bang, keys_a, perm_a, keys_b, perm_b, slot, work, m, n, velw);
  }
  return (int)cudaGetLastError();
}
