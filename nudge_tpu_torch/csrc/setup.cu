// Contact-constraint setup (one thread per manifold, its <= 4 points in
// sequence) and the deterministic per-body segment sum.
//
// Replaces nudge_tpu/ops/setup_kernel.py: setup_pallas (_make_setup_kernel),
// the first half of setup_solve_fused. Per manifold the kernel gathers body
// pos, quat, inverse inertia, inverse mass and pre-step velocity by int32
// index; builds the contact frame n/t1/t2; computes lever arms, the angular
// responses I⁻¹(r×d), the effective masses and the biases (Baumgarte, the
// approach-gated deep bias, the ungated anti-creep floor, the pseudo bias,
// restitution); projects and clamps the warm and warm-pseudo impulses into
// the accumulators. It writes the constraint rows that the solve kernel
// reads, in the manifold-major layout of the plain twin's
// ContactConstraints, so the two are compared field by field.
//
// The warm-start velocity change does not depend on velocities, so the
// kernel writes it per manifold and side (12 floats: v, w, pseudo v,
// pseudo w) and segment_apply adds those into the bodies: one thread per
// body, over the manifolds that touch it in a stably sorted order. No float
// atomics: the sum order is fixed, so runs repeat bit for bit.
//
// What bounds it on an H100: memory. Each manifold reads ~90 floats and
// writes ~330 (the constraint rows are ~4x the geometry), so at 61,440
// manifold slots one call moves ~100 MB; the arithmetic (three effective
// masses per point) is far below the card's float rate. Outputs are written
// as whole rows per thread; a [rows, M] layout with coalesced stores is the
// next step if the solve's reads allow it.

#include "common.cuh"

namespace {

struct SetupParams {
  float bod;  // baumgarte / dt
  float slop, max_bias_vel, deep_bias_depth, deep_bias_gate, ungated_depth, ungated_vel;
  float max_pseudo_vel, restitution;
  int split, warm_start, use_pwarm;
};

struct SetupOut {
  float *t1, *t2;
  float *ra, *rb, *jna, *jnb, *jt1a, *jt1b, *jt2a, *jt2b;
  float *mn, *mt1, *mt2, *bias, *pos_bias, *pwarm;
  float *im_a, *im_b;
  float *acc_n, *acc_t1, *acc_t2;
  float *delta_a, *delta_b;
};

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
                             const float* __restrict__ pwarm_in, int m, SetupParams P,
                             SetupOut o) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int a = body_a[i], b = body_b[i];
  const V3 n = load3(normal + 3 * i);
  V3 t1, t2;
  orthonormal_basis(n, &t1, &t2);
  store3(o.t1 + 3 * i, t1);
  store3(o.t2 + 3 * i, t2);
  const V3 pa = load3(bpos + 3 * a), pb = load3(bpos + 3 * b);
  const Q4 qa = load4(bquat + 4 * a), qb = load4(bquat + 4 * b);
  const V3 iia = load3(binvi + 3 * a), iib = load3(binvi + 3 * b);
  const float ima = binvm[a], imb = binvm[b];
  const V3 va0 = load3(bvel + 3 * a), vb0 = load3(bvel + 3 * b);
  const V3 wa0 = load3(bang + 3 * a), wb0 = load3(bang + 3 * b);
  const float mu = fric[i];
  o.im_a[i] = ima;
  o.im_b[i] = imb;

  // Σ over points (in point order) of the warm impulses' effects
  float sn = 0.0f, s1 = 0.0f, s2 = 0.0f, sp = 0.0f;
  V3 dwa = v3(0.0f, 0.0f, 0.0f), dwb = dwa, pdwa = dwa, pdwb = dwa;

  for (int p = 0; p < 4; ++p) {
    const int ip = 4 * i + p;
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

    store3(o.ra + 3 * ip, ra);
    store3(o.rb + 3 * ip, rb);
    store3(o.jna + 3 * ip, jna);
    store3(o.jnb + 3 * ip, jnb);
    store3(o.jt1a + 3 * ip, jt1a);
    store3(o.jt1b + 3 * ip, jt1b);
    store3(o.jt2a + 3 * ip, jt2a);
    store3(o.jt2b + 3 * ip, jt2b);
    o.mn[ip] = mn;
    o.mt1[ip] = mt1;
    o.mt2[ip] = mt2;
    o.bias[ip] = bias;
    o.pos_bias[ip] = pos_bias;
    o.pwarm[ip] = pw;
    o.acc_n[ip] = an;
    o.acc_t1[ip] = at1;
    o.acc_t2[ip] = at2;

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
  float* da = o.delta_a + kVelRow * i;
  float* db = o.delta_b + kVelRow * i;
  store3(da + 0, scale(neg(Pw), ima));
  store3(da + 3, neg(dwa));
  store3(da + 6, scale(neg(Pp), ima));
  store3(da + 9, neg(pdwa));
  store3(db + 0, scale(Pw, imb));
  store3(db + 3, dwb);
  store3(db + 6, scale(Pp, imb));
  store3(db + 9, pdwb);
}

}  // namespace

// One thread per body segment of a stably sorted (key, manifold) list.
// keys[e] is the body of entry e (INT_MAX for entries to skip, sorted last),
// perm[e] its manifold; rows of `vals` are kVelRow floats `stride` apart.
// mode 0: state[body] += Σ vals (in entry order);
// mode 1: state[body] += Σ (vals - state[body] as it was before the sum),
// the Jacobi update of the solver's spill color.
__global__ void segment_apply_kernel(float* __restrict__ state, const int* __restrict__ keys,
                                     const long long* __restrict__ perm,
                                     const float* __restrict__ vals, int n, int stride,
                                     int mode) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int body = keys[e];
  if (body == 0x7fffffff) return;
  if (e > 0 && keys[e - 1] == body) return;  // not the segment's first entry
  float base[kVelRow], acc[kVelRow];
  for (int c = 0; c < kVelRow; ++c) {
    base[c] = state[kVelRow * body + c];
    acc[c] = base[c];
  }
  for (int j = e; j < n && keys[j] == body; ++j) {
    const float* row = vals + (long long)stride * perm[j];
    if (mode == 0) {
      for (int c = 0; c < kVelRow; ++c) acc[c] = acc[c] + row[c];
    } else {
      for (int c = 0; c < kVelRow; ++c) acc[c] = acc[c] + (row[c] - base[c]);
    }
  }
  for (int c = 0; c < kVelRow; ++c) state[kVelRow * body + c] = acc[c];
}

extern "C" int nudge_segment_apply(float* state, const int* keys, const long long* perm,
                                   const float* vals, int n, int stride, int mode,
                                   void* stream) {
  if (n > 0) {
    segment_apply_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        state, keys, perm, vals, n, stride, mode);
  }
  return (int)cudaGetLastError();
}

extern "C" int nudge_setup(
    // bodies
    const float* bpos, const float* bquat, const float* bvel, const float* bang,
    const float* binvm, const float* binvi,
    // manifolds
    const int* body_a, const int* body_b, const float* normal, const float* fric,
    const float* mpos, const float* mdepth, const bool* pvalid, const float* warm,
    const float* pwarm_in, int m,
    // constants
    float bod, float slop, float max_bias_vel, float deep_bias_depth, float deep_bias_gate,
    float ungated_depth, float ungated_vel, float max_pseudo_vel, float restitution,
    int split, int warm_start, int use_pwarm,
    // outputs
    float* t1, float* t2, float* ra, float* rb, float* jna, float* jnb, float* jt1a,
    float* jt1b, float* jt2a, float* jt2b, float* mn, float* mt1, float* mt2, float* bias,
    float* pos_bias, float* pwarm, float* im_a, float* im_b, float* acc_n, float* acc_t1,
    float* acc_t2, float* delta_a, float* delta_b, void* stream) {
  SetupParams P{bod,           slop,        max_bias_vel,   deep_bias_depth, deep_bias_gate,
                ungated_depth, ungated_vel, max_pseudo_vel, restitution,     split,
                warm_start,    use_pwarm};
  SetupOut o{t1,  t2,  ra,  rb,   jna,      jnb,      jt1a,  jt1b,  jt2a,   jt2b,   mn,     mt1,
             mt2, bias, pos_bias, pwarm, im_a, im_b, acc_n, acc_t1, acc_t2, delta_a, delta_b};
  if (m > 0) {
    setup_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        bpos, bquat, bvel, bang, binvm, binvi, body_a, body_b, normal, fric, mpos, mdepth,
        pvalid, warm, pwarm_in, m, P, o);
  }
  return (int)cudaGetLastError();
}
