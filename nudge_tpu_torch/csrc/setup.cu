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
// A point's math is setup_point, built from eff, warm_of and bias_of; the
// backward kernel (setup_bwd_kernel, differentiable mode) runs those same
// functions on the same inputs for its point before it takes each one's
// reverse, so the backward's forward values are the forward's bits.
//
// What bounds it on an H100: memory. Per live manifold ~156 B are read and
// ~656 B written (139 row words, 16 accumulators, 24 delta words, 24 B of
// frame); at the pile's 11,971 live manifolds that is ~10 MB, ~3 us at
// 3.35 TB/s; the arithmetic (three effective masses per point) is far
// below the float rate. One thread per manifold with ~2,000 dependent
// instructions, so at this size the chain's latency, not the bytes, sets
// the time.

#include "adjoint.cuh"

namespace {

struct SetupParams {
  float bod;  // baumgarte / dt
  float slop, max_bias_vel, deep_bias_depth, deep_bias_gate, ungated_depth, ungated_vel;
  float max_pseudo_vel, restitution;
  int split, warm_start, use_pwarm;
};

constexpr int kSetupBlocks = 264;  // 2 per SM; a grid-stride loop covers the rest
// the per-body adjoint rows of the backward: pos (0-2), quat (3-6), vel
// (7-9), angvel (10-12); the mass instance adds inv_mass (13) and
// inv_inertia (14-16)
constexpr int kBodyInputs = 13;
constexpr int kBodyInputsMass = 17;
constexpr int kNoBody = 0x7fffffff;

struct SetupIn {
  const float *bpos, *bquat, *bvel, *bang, *binvm, *binvi;
  const float *normal, *fric, *mpos, *mdepth;
  const bool* pvalid;
  const float *warm, *pwarm;
};

// What a manifold's points share: its frame and its two bodies' pose,
// inverse inertia and inverse mass.
struct ManifoldIn {
  V3 n, t1, t2, pa, pb, iia, iib;
  Q4 qa, qb;
  float ima, imb, mu;
};

__device__ __forceinline__ ManifoldIn load_manifold(const SetupIn& in, long long i, int a,
                                                    int b) {
  ManifoldIn M;
  M.n = load3(in.normal + 3 * i);
  orthonormal_basis(M.n, &M.t1, &M.t2);
  M.pa = load3(in.bpos + 3 * a);
  M.pb = load3(in.bpos + 3 * b);
  M.qa = load4(in.bquat + 4 * a);
  M.qb = load4(in.bquat + 4 * b);
  M.iia = load3(in.binvi + 3 * a);
  M.iib = load3(in.binvi + 3 * b);
  M.ima = in.binvm[a];
  M.imb = in.binvm[b];
  M.mu = in.fric[i];
  return M;
}

// The twin's eff(d): the angular responses of both bodies to a unit
// impulse along d at the lever arms ra, rb, and the effective mass.
struct Eff {
  V3 rna, rnb, ja, jb;
  float k, m;
};

__device__ __forceinline__ Eff eff(const ManifoldIn& M, V3 ra, V3 rb, V3 d) {
  Eff e;
  e.rna = cross(ra, d);
  e.rnb = cross(rb, d);
  e.ja = inv_inertia_apply(M.qa, M.iia, e.rna);
  e.jb = inv_inertia_apply(M.qb, M.iib, e.rnb);
  e.k = M.ima + M.imb + dot(e.rna, e.ja) + dot(e.rnb, e.jb);
  e.m = e.k > 0.0f ? 1.0f / clamp_min(e.k, 1e-12f) : 0.0f;
  return e;
}

// clamp_max(bod * clamp_min(depth - c, 0), cap): the biases' ramp
__device__ __forceinline__ float ramp(float bod, float depth, float c, float cap) {
  return clamp_max(bod * clamp_min(depth - c, 0.0f), cap);
}

// A point's velocity bias and pseudo bias, with the values its reverse
// pass reads: the deep bias b0, the approach gate g, min(b0, g) b1, the
// ungated floor u, max(b1, u) b2 (under split impulse with the gate on;
// else b2 is the deep bias or Baumgarte's), and restitution's r.
struct Bias {
  float b0, g, b1, u, b2, r, bias, pos_bias;
};

__device__ __forceinline__ Bias bias_of(float depth, float vn0, const SetupParams& P) {
  Bias B{};
  if (P.split) {
    B.b0 = ramp(P.bod, depth, P.deep_bias_depth, P.max_bias_vel);
    B.b2 = B.b0;
    if (P.deep_bias_gate >= 0.0f) {
      B.g = clamp_min(-vn0 - P.deep_bias_gate, 0.0f);
      B.b1 = minimum(B.b0, B.g);
      B.u = ramp(P.bod, depth, P.ungated_depth, P.ungated_vel);
      B.b2 = maximum(B.b1, B.u);
    }
    B.pos_bias = ramp(P.bod, depth, P.slop, P.max_pseudo_vel);
  } else {
    B.b2 = ramp(P.bod, depth, P.slop, P.max_bias_vel);
    B.pos_bias = 0.0f;
  }
  B.bias = B.b2;
  if (P.restitution > 0.0f) {
    B.r = P.restitution * clamp_min(-vn0 - 1.0f, 0.0f);
    B.bias = maximum(B.b2, B.r);
  }
  return B;
}

__device__ __forceinline__ bool needs_vn0(const SetupParams& P) {
  return P.restitution > 0.0f || (P.split && P.deep_bias_gate >= 0.0f);
}

// the approach velocity along n at the point: vrel0 = (vb + wb × rb) -
// (va + wa × ra) before the step
__device__ __forceinline__ V3 approach(const SetupIn& in, int a, int b, V3 ra, V3 rb) {
  const V3 va0 = load3(in.bvel + 3 * a), vb0 = load3(in.bvel + 3 * b);
  const V3 wa0 = load3(in.bang + 3 * a), wb0 = load3(in.bang + 3 * b);
  return sub(add(vb0, cross(wb0, rb)), add(va0, cross(wa0, ra)));
}

// A point's warm-started accumulators: the warm impulse wi projected on
// the frame, the normal part clamped >= 0, the tangent parts to ±mu an;
// zeros on an invalid point or without a warm start.
struct Warm {
  float an, at1, at2;
};

__device__ __forceinline__ Warm warm_of(const SetupIn& in, const ManifoldIn& M, long long ip,
                                        bool pv, const SetupParams& P) {
  Warm w{0.0f, 0.0f, 0.0f};
  if (P.warm_start) {
    const V3 wi = load3(in.warm + 3 * ip);
    const float n_ = clamp_min(dot(wi, M.n), 0.0f);
    const float bound = M.mu * n_;
    const float x1 = minimum(maximum(dot(wi, M.t1), -bound), bound);
    const float x2 = minimum(maximum(dot(wi, M.t2), -bound), bound);
    w.an = pv ? n_ : 0.0f;
    w.at1 = pv ? x1 : 0.0f;
    w.at2 = pv ? x2 : 0.0f;
  }
  return w;
}

// What point p of a manifold writes: its rows, its accumulators and its
// pseudo impulse pw.
struct PointOut {
  V3 ra, rb;
  Eff en, e1, e2;
  Bias B;
  Warm w;
  float pw;
};

// Point ip = 4i + p of manifold i (bodies a, b): the twin's math.
__device__ __forceinline__ PointOut setup_point(const SetupIn& in, const ManifoldIn& M,
                                                long long ip, int a, int b,
                                                const SetupParams& P) {
  PointOut o;
  const bool pv = in.pvalid[ip];
  const V3 cp = load3(in.mpos + 3 * ip);
  o.ra = sub(cp, M.pa);
  o.rb = sub(cp, M.pb);
  o.en = eff(M, o.ra, o.rb, M.n);
  o.e1 = eff(M, o.ra, o.rb, M.t1);
  o.e2 = eff(M, o.ra, o.rb, M.t2);
  const float vn0 = needs_vn0(P) ? dot(approach(in, a, b, o.ra, o.rb), M.n) : 0.0f;
  o.B = bias_of(in.mdepth[ip], vn0, P);
  o.w = warm_of(in, M, ip, pv, P);
  o.pw = (P.use_pwarm && pv) ? in.pwarm[ip] : 0.0f;
  return o;
}

__global__ void setup_kernel(SetupIn in, const int* __restrict__ body_a,
                             const int* __restrict__ body_b, const float* __restrict__ relax,
                             const long long* __restrict__ order, const int* __restrict__ offsets,
                             int max_colors, int m, SetupParams P, float* __restrict__ rows,
                             float* __restrict__ work, float* __restrict__ frame) {
  const int live = offsets[max_colors];
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < live; s += gridDim.x * blockDim.x) {
    const long long i = order[s];
    const long long fm = m;
    const int a = body_a[i], b = body_b[i];
    float* R = rows + s;  // R[f * m]: field f of this slot
    float* W = work + s;
    R[kRowRelax * fm] = relax[i];
    R[kRowBodyA * fm] = __int_as_float(a);
    R[kRowBodyB * fm] = __int_as_float(b);
    const ManifoldIn M = load_manifold(in, i, a, b);
    for (int k = 0; k < 3; ++k) {
      frame[3 * i + k] = get(M.t1, k);
      frame[3 * (fm + i) + k] = get(M.t2, k);
      R[(kRowN + k) * fm] = get(M.n, k);
      R[(kRowT1 + k) * fm] = get(M.t1, k);
      R[(kRowT2 + k) * fm] = get(M.t2, k);
    }
    R[kRowMu * fm] = M.mu;
    R[kRowImA * fm] = M.ima;
    R[kRowImB * fm] = M.imb;

    // Σ over points (in point order) of the warm impulses' effects
    float sn = 0.0f, s1 = 0.0f, s2 = 0.0f, sp = 0.0f;
    V3 dwa = v3(0.0f, 0.0f, 0.0f), dwb = dwa, pdwa = dwa, pdwb = dwa;
    for (int p = 0; p < 4; ++p) {
      const long long ip = 4 * i + p;
      const PointOut o = setup_point(in, M, ip, a, b, P);
      for (int k = 0; k < 3; ++k) {
        const int c = 3 * p + k;
        R[(kRowRa + c) * fm] = get(o.ra, k);
        R[(kRowRb + c) * fm] = get(o.rb, k);
        R[(kRowJna + c) * fm] = get(o.en.ja, k);
        R[(kRowJnb + c) * fm] = get(o.en.jb, k);
        R[(kRowJt1a + c) * fm] = get(o.e1.ja, k);
        R[(kRowJt1b + c) * fm] = get(o.e1.jb, k);
        R[(kRowJt2a + c) * fm] = get(o.e2.ja, k);
        R[(kRowJt2b + c) * fm] = get(o.e2.jb, k);
      }
      R[(kRowMn + p) * fm] = o.en.m;
      R[(kRowMt1 + p) * fm] = o.e1.m;
      R[(kRowMt2 + p) * fm] = o.e2.m;
      R[(kRowBias + p) * fm] = o.B.bias;
      R[(kRowPosBias + p) * fm] = o.B.pos_bias;
      R[(kRowPwarm + p) * fm] = o.pw;
      R[(kRowPv + p) * fm] = in.pvalid[ip] ? 1.0f : 0.0f;
      W[(kWorkAccN + p) * fm] = o.w.an;
      W[(kWorkAccT1 + p) * fm] = o.w.at1;
      W[(kWorkAccT2 + p) * fm] = o.w.at2;
      W[(kWorkAccP + p) * fm] = o.pw;

      // per-point angular terms, then the running sums over points
      const V3 ta =
          add(add(scale(o.en.ja, o.w.an), scale(o.e1.ja, o.w.at1)), scale(o.e2.ja, o.w.at2));
      const V3 tb =
          add(add(scale(o.en.jb, o.w.an), scale(o.e1.jb, o.w.at1)), scale(o.e2.jb, o.w.at2));
      const V3 pta = scale(o.en.ja, o.pw), ptb = scale(o.en.jb, o.pw);
      if (p == 0) {
        sn = o.w.an;
        s1 = o.w.at1;
        s2 = o.w.at2;
        sp = o.pw;
        dwa = ta;
        dwb = tb;
        pdwa = pta;
        pdwb = ptb;
      } else {
        sn = sn + o.w.an;
        s1 = s1 + o.w.at1;
        s2 = s2 + o.w.at2;
        sp = sp + o.pw;
        dwa = add(dwa, ta);
        dwb = add(dwb, tb);
        pdwa = add(pdwa, pta);
        pdwb = add(pdwb, ptb);
      }
    }

    const V3 Pw = add(add(scale(M.n, sn), scale(M.t1, s1)), scale(M.t2, s2));
    const V3 Pp = scale(M.n, sp);
    const V3 da[4] = {scale(neg(Pw), M.ima), neg(dwa), scale(neg(Pp), M.ima), neg(pdwa)};
    const V3 db[4] = {scale(Pw, M.imb), dwb, scale(Pp, M.imb), pdwb};
    for (int q = 0; q < 4; ++q) {
      for (int k = 0; k < 3; ++k) {
        W[(kWorkScratch + 3 * q + k) * fm] = get(da[q], k);
        W[(kWorkScratch + kVelRow + 3 * q + k) * fm] = get(db[q], k);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The backward (differentiable mode): a hand-written reverse pass of
// setup_point and of the warm start's sums.
//
// Lane map: one live slot on four lanes of a warp (a quad), lane p holding
// point p. Each lane recomputes its point's forward values with
// setup_point's parts (the forward's bits, so every clamp_min, clamp_max,
// maximum, minimum and select takes the forward's branch), one effective
// mass at a time, and runs the reverse of the point's outputs: its row
// words, its accumulators and pseudo impulse, and its term of the
// warm-start velocity changes, which are sums over points and so hand
// every point's term the same adjoint. The corners
// are autograd's for the twin's operations (adjoint.cuh states them):
// clamp_min / clamp_max pass the adjoint where x >= c / x <= c, maximum /
// minimum split it in halves at a tie, a select takes its branch's.
//
// Who writes what: lane p writes its point's input adjoints (pos, depth,
// warm, pwarm). The shared inputs' adjoints (the normal, directly and
// through t1/t2, and both bodies' pos, quat, vel, angvel) are summed over
// the quad in a fixed order, ((lane 0 + lane 1) + (lane 2 + lane 3)) by two
// xor shuffles, which leaves the same bits in every lane; then lane 0
// writes body a's row of adj_body ([2M, 13], row 2i + side), lane 1 body
// b's, and lane 2 adds the frame's adjoint, takes the reverse of
// orthonormal_basis and writes adj_normal. A slot past the live count
// writes zeros into its manifold's input adjoints, so the caller zeroes
// nothing. Lanes 0 and 1 also write the manifold's static-body keys (the
// body of a live manifold's static side, else kNoBody), which the caller
// sorts for the per-body sums of static bodies.
//
// What bounds it on an H100: the chain. Per lane ~2,500 dependent
// operations (the point's forward, then its reverse: six rotations'
// adjoints for the three effective masses); per live slot ~156 B of
// inputs and ~0.7 KB of output adjoints read, 61 adjoints written; at the
// pile's ~12,000 live slots ~48,000 lanes, one wave at up to 168
// registers a thread (3 blocks of 128 an SM: 50,688 lanes), which holds the
// reverse pass without a spill.

__device__ __forceinline__ float quad_sum(unsigned mask, float x) {
  x = x + __shfl_xor_sync(mask, x, 1, 4);
  return x + __shfl_xor_sync(mask, x, 2, 4);
}
__device__ __forceinline__ V3 quad_sum3(unsigned mask, V3 v) {
  return v3(quad_sum(mask, v.x), quad_sum(mask, v.y), quad_sum(mask, v.z));
}
__device__ __forceinline__ Q4 quad_sum4(unsigned mask, Q4 q) {
  Q4 r;
  r.x = quad_sum(mask, q.x);
  r.y = quad_sum(mask, q.y);
  r.z = quad_sum(mask, q.z);
  r.w = quad_sum(mask, q.w);
  return r;
}

__device__ __forceinline__ Q4 qadd(Q4 a, Q4 b) {
  Q4 r;
  r.x = a.x + b.x;
  r.y = a.y + b.y;
  r.z = a.z + b.z;
  r.w = a.w + b.w;
  return r;
}

// The adjoints of quat_rotate(q, v) = v + 2 (w c + u × c), c = u × v, u =
// q.xyz, from the output's adjoint g: of q (returned) and of v (added into
// *gv).
__device__ __forceinline__ Q4 quat_rotate_adjoint(Q4 q, V3 v, V3 g, V3* gv) {
  const V3 u = v3(q.x, q.y, q.z);
  const V3 c = cross(u, v);
  // of c: 2 w g from 2 w c, 2 g × u from 2 u × c
  const V3 gc = add(scale(g, 2.0f * q.w), scale(cross(g, u), 2.0f));
  // of u: 2 c × g from u × c, v × gc from c = u × v
  const V3 gu = add(scale(cross(c, g), 2.0f), cross(v, gc));
  *gv = add(add(*gv, g), cross(gc, u));
  Q4 r;
  r.x = gu.x;
  r.y = gu.y;
  r.z = gu.z;
  r.w = 2.0f * dot(g, c);
  return r;
}

// The adjoints of inv_inertia_apply(q, ii, v) = R (ii ⊙ Rᵀ v), from the
// output's adjoint g: of q (returned) and of v (added into *gv); with
// kMass also of ii (added into *gii).
template <bool kMass>
__device__ __forceinline__ Q4 inv_inertia_adjoint(Q4 q, V3 ii, V3 v, V3 g, V3* gv, V3* gii) {
  Q4 c;  // the conjugate: quat_rotate_inv(q, v) = quat_rotate(c, v)
  c.x = -q.x;
  c.y = -q.y;
  c.z = -q.z;
  c.w = q.w;
  const V3 l = quat_rotate(c, v);
  V3 gs = v3(0.0f, 0.0f, 0.0f);
  Q4 gq = quat_rotate_adjoint(q, v3(ii.x * l.x, ii.y * l.y, ii.z * l.z), g, &gs);
  if constexpr (kMass) *gii = add(*gii, v3(gs.x * l.x, gs.y * l.y, gs.z * l.z));
  const Q4 gc = quat_rotate_adjoint(c, v, v3(ii.x * gs.x, ii.y * gs.y, ii.z * gs.z), gv);
  gq.x = gq.x - gc.x;
  gq.y = gq.y - gc.y;
  gq.z = gq.z - gc.z;
  gq.w = gq.w + gc.w;
  return gq;
}

// The adjoints flowing back from eff(d): of ra, rb, d (added into *g_ra,
// *g_rb, *g_d) and of both quaternions (into *g_qa, *g_qb), from those of
// ja, jb and m, at the forward's values e; with kMass also of the inverse
// masses (k's, added into *g_k) and inertias (into *g_iia, *g_iib).
template <bool kMass>
__device__ __forceinline__ void eff_adjoint(const ManifoldIn& M, const Eff& e, V3 ra, V3 rb,
                                            V3 d, V3 g_ja, V3 g_jb, float g_m, V3* g_ra,
                                            V3* g_rb, V3* g_d, Q4* g_qa, Q4* g_qb, float* g_km,
                                            V3* g_iia, V3* g_iib) {
  // m = where(k > 0, 1 / clamp_min(k, 1e-12), 0)
  const float g_k = (e.k > 0.0f && e.k >= 1e-12f) ? -(g_m * e.m) * e.m : 0.0f;
  // k = ima + imb + rna · ja + rnb · jb
  if constexpr (kMass) *g_km = *g_km + g_k;
  V3 g_rna = scale(e.ja, g_k), g_rnb = scale(e.jb, g_k);
  g_ja = add(g_ja, scale(e.rna, g_k));
  g_jb = add(g_jb, scale(e.rnb, g_k));
  *g_qa = qadd(*g_qa, inv_inertia_adjoint<kMass>(M.qa, M.iia, e.rna, g_ja, &g_rna, g_iia));
  *g_qb = qadd(*g_qb, inv_inertia_adjoint<kMass>(M.qb, M.iib, e.rnb, g_jb, &g_rnb, g_iib));
  // rna = ra × d, rnb = rb × d
  *g_ra = add(*g_ra, cross(d, g_rna));
  *g_rb = add(*g_rb, cross(d, g_rnb));
  *g_d = add(add(*g_d, cross(g_rna, ra)), cross(g_rnb, rb));
}

// ramp(bod, depth, c, cap)'s adjoint of depth from g
__device__ __forceinline__ float ramp_adjoint(float g, float bod, float depth, float c,
                                              float cap) {
  const float x = depth - c;
  const float g_u = bod * clamp_min(x, 0.0f) <= cap ? g : 0.0f;
  return x >= 0.0f ? bod * g_u : 0.0f;
}

// bias_of's adjoints: of depth (returned) and of vn0 (*g_vn0), from those
// of bias and pos_bias, at the forward's values B.
__device__ __forceinline__ float bias_adjoint(const Bias& B, float depth, float vn0,
                                              const SetupParams& P, float g_bias,
                                              float g_pos_bias, float* g_vn0) {
  float g_b2 = g_bias, g_depth = 0.0f;
  *g_vn0 = 0.0f;
  if (P.restitution > 0.0f) {
    const float2 g = max_adjoint(g_bias, B.b2, B.r);
    g_b2 = g.x;
    // r = restitution * clamp_min(-vn0 - 1, 0)
    if (-vn0 - 1.0f >= 0.0f) *g_vn0 = *g_vn0 - P.restitution * g.y;
  }
  if (P.split) {
    float g_b0 = g_b2;
    if (P.deep_bias_gate >= 0.0f) {
      const float2 gm = max_adjoint(g_b2, B.b1, B.u);
      g_depth = g_depth + ramp_adjoint(gm.y, P.bod, depth, P.ungated_depth, P.ungated_vel);
      // minimum(b0, g): maximum's adjoints with the arguments swapped
      const float2 gn = max_adjoint(gm.x, B.g, B.b0);
      g_b0 = gn.x;
      if (-vn0 - P.deep_bias_gate >= 0.0f) *g_vn0 = *g_vn0 - gn.y;
    }
    g_depth = g_depth + ramp_adjoint(g_b0, P.bod, depth, P.deep_bias_depth, P.max_bias_vel);
    g_depth = g_depth + ramp_adjoint(g_pos_bias, P.bod, depth, P.slop, P.max_pseudo_vel);
  } else {
    g_depth = g_depth + ramp_adjoint(g_b2, P.bod, depth, P.slop, P.max_bias_vel);
  }
  return g_depth;
}

// The mass instance (kMass, launched when inv_mass, inv_inertia or the
// manifolds' friction carry a gradient) adds the adjoints of both bodies'
// inverse mass and inverse inertia (adj_body columns 13-16) and of the
// manifold's friction (adj_fric[i], lane 3): the inverse masses through
// the im rows, the effective masses' k and the warm-start velocity
// changes; the inertias through the angular responses' I⁻¹; the friction
// through the mu row and the warm start's tangent bound. A static side
// (inverse mass 0) takes its inverse mass's and inertia's adjoints too, as
// in the twin's autograd, where the warm start adds -P ima and -dwa into
// every body: so this instance reads d_velw for a static side as well
// (its other terms are then products with a zero inverse mass or a zero
// angular response, and add nothing).
template <bool kMass>
__global__ void __launch_bounds__(kThreads, 3)
    setup_bwd_kernel(SetupIn in, const int* __restrict__ body_a,
                     const int* __restrict__ body_b, const long long* __restrict__ order,
                     const int* __restrict__ offsets, int max_colors, int m, SetupParams P,
                     const float* __restrict__ d_rows, const float* __restrict__ d_work,
                     const float* __restrict__ d_frame, const float* __restrict__ d_velw,
                     float* __restrict__ adj_body, float* __restrict__ adj_normal,
                     float* __restrict__ adj_pos, float* __restrict__ adj_depth,
                     float* __restrict__ adj_warm, float* __restrict__ adj_pwarm,
                     int* __restrict__ static_keys, float* __restrict__ adj_fric) {
  constexpr int W = kMass ? kBodyInputsMass : kBodyInputs;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(t >> 2), p = (int)(t & 3);
  if (s >= m) return;  // whole quads: blocks hold whole quads
  const unsigned mask = 0xfu << (threadIdx.x & 28);
  const long long i = order[s];
  const long long ip = 4 * i + p;
  if (s >= offsets[max_colors]) {  // not live: no gradient
    store3(adj_pos + 3 * ip, v3(0.0f, 0.0f, 0.0f));
    store3(adj_warm + 3 * ip, v3(0.0f, 0.0f, 0.0f));
    adj_depth[ip] = 0.0f;
    adj_pwarm[ip] = 0.0f;
    if (p == 0) store3(adj_normal + 3 * i, v3(0.0f, 0.0f, 0.0f));
    if (p < 2) static_keys[2 * i + p] = kNoBody;
    if (kMass && p == 3) adj_fric[i] = 0.0f;
    return;
  }
  const int a = body_a[i], b = body_b[i];
  const ManifoldIn M = load_manifold(in, i, a, b);
  const bool pv = in.pvalid[ip];
  const long long fm = m;
  const float* DR = d_rows + s;
  auto dr = [&](int f) { return DR[f * fm]; };
  auto dr3 = [&](int f) { return v3(dr(f), dr(f + 1), dr(f + 2)); };
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  // the point's forward values, part by part as setup_point computes them
  const V3 cp = load3(in.mpos + 3 * ip);
  const V3 ra = sub(cp, M.pa), rb = sub(cp, M.pb);
  const Warm w = warm_of(in, M, ip, pv, P);
  const float pw = (P.use_pwarm && pv) ? in.pwarm[ip] : 0.0f;

  // The warm-start velocity changes: da = (-Pw ima, -dwa, -Pp ima, -pdwa),
  // db = (Pw imb, dwb, Pp imb, pdwb), added into a dynamic side's velw;
  // Pw = n Σan + t1 Σat1 + t2 Σat2, Pp = n Σpw, dwa = Σ (jna an + jt1a at1
  // + jt2a at2), pdwa = Σ jna pw (b alike). A static side takes none.
  const float* Da = (kMass || M.ima > 0.0f) ? d_velw + kVelRow * a : nullptr;
  const float* Db = (kMass || M.imb > 0.0f) ? d_velw + kVelRow * b : nullptr;
  auto dv = [&](const float* D, int c) { return D ? load3(D + c) : zero; };
  const V3 g_dwa = neg(dv(Da, 3)), g_dwb = dv(Db, 3);
  const V3 g_pdwa = neg(dv(Da, 9)), g_pdwb = dv(Db, 9);
  const float* DW = d_work + s;
  float g_an, g_at1, g_at2, g_pw;
  V3 g_n, g_t1, g_t2;  // this lane's share of the frame's adjoints
  {
    const V3 g_Pw = sub(scale(dv(Db, 0), M.imb), scale(dv(Da, 0), M.ima));
    const V3 g_Pp = sub(scale(dv(Db, 6), M.imb), scale(dv(Da, 6), M.ima));
    g_n = add(scale(g_Pw, w.an), scale(g_Pp, pw));
    g_t1 = scale(g_Pw, w.at1);
    g_t2 = scale(g_Pw, w.at2);
    g_an = dot(g_Pw, M.n) + DW[(kWorkAccN + p) * fm];
    g_at1 = dot(g_Pw, M.t1) + DW[(kWorkAccT1 + p) * fm];
    g_at2 = dot(g_Pw, M.t2) + DW[(kWorkAccT2 + p) * fm];
    g_pw = (dot(g_Pp, M.n) + DW[(kWorkAccP + p) * fm]) + dr(kRowPwarm + p);
  }
  // kMass: this lane's part of the inverse masses', inertias' and
  // friction's adjoints; the warm start's changes -Pw ima, Pw imb, -Pp ima,
  // Pp imb, with this point's terms of Pw and Pp
  float g_ima = 0.0f, g_imb = 0.0f, g_mu = 0.0f;
  V3 g_iia = zero, g_iib = zero;
  if constexpr (kMass) {
    const V3 Pw = add(add(scale(M.n, w.an), scale(M.t1, w.at1)), scale(M.t2, w.at2));
    const V3 Pp = scale(M.n, pw);
    g_ima = -(dot(dv(Da, 0), Pw) + dot(dv(Da, 6), Pp));
    g_imb = dot(dv(Db, 0), Pw) + dot(dv(Db, 6), Pp);
  }

  // the angular responses and effective masses, one direction at a time:
  // their rows' adjoints and their warm-start terms' (jd_a λ, jd_b λ)
  V3 g_ra = dr3(kRowRa + 3 * p), g_rb = dr3(kRowRb + 3 * p);
  float g_km = 0.0f;  // of the effective masses' k (kMass)
  Q4 g_qa, g_qb;
  g_qa.x = g_qa.y = g_qa.z = g_qa.w = 0.0f;
  g_qb = g_qa;
  {
    const Eff e = eff(M, ra, rb, M.n);
    g_an = g_an + dot(g_dwa, e.ja) + dot(g_dwb, e.jb);
    g_pw = g_pw + dot(g_pdwa, e.ja) + dot(g_pdwb, e.jb);
    eff_adjoint<kMass>(M, e, ra, rb, M.n,
                       add(add(dr3(kRowJna + 3 * p), scale(g_dwa, w.an)), scale(g_pdwa, pw)),
                       add(add(dr3(kRowJnb + 3 * p), scale(g_dwb, w.an)), scale(g_pdwb, pw)),
                       dr(kRowMn + p), &g_ra, &g_rb, &g_n, &g_qa, &g_qb, &g_km, &g_iia,
                       &g_iib);
  }
  adj_pwarm[ip] = (P.use_pwarm && pv) ? g_pw : 0.0f;
  {
    const Eff e = eff(M, ra, rb, M.t1);
    g_at1 = g_at1 + dot(g_dwa, e.ja) + dot(g_dwb, e.jb);
    eff_adjoint<kMass>(M, e, ra, rb, M.t1, add(dr3(kRowJt1a + 3 * p), scale(g_dwa, w.at1)),
                       add(dr3(kRowJt1b + 3 * p), scale(g_dwb, w.at1)), dr(kRowMt1 + p), &g_ra,
                       &g_rb, &g_t1, &g_qa, &g_qb, &g_km, &g_iia, &g_iib);
  }
  {
    const Eff e = eff(M, ra, rb, M.t2);
    g_at2 = g_at2 + dot(g_dwa, e.ja) + dot(g_dwb, e.jb);
    eff_adjoint<kMass>(M, e, ra, rb, M.t2, add(dr3(kRowJt2a + 3 * p), scale(g_dwa, w.at2)),
                       add(dr3(kRowJt2b + 3 * p), scale(g_dwb, w.at2)), dr(kRowMt2 + p), &g_ra,
                       &g_rb, &g_t2, &g_qa, &g_qb, &g_km, &g_iia, &g_iib);
  }
  if constexpr (kMass) {  // k = ima + imb + ...: both take k's adjoint
    g_ima = g_ima + g_km;
    g_imb = g_imb + g_km;
  }

  // the warm start: an = clamp_min(wi · n, 0), at = clamp(wi · t, ±mu an)
  // on a valid point
  V3 g_wi = zero;
  if (P.warm_start && pv) {
    const V3 wi = load3(in.warm + 3 * ip);
    const float dn = dot(wi, M.n);
    const float bound = M.mu * clamp_min(dn, 0.0f);
    float g_bound = 0.0f;
    const float g_y1 = clamp2_adjoint(g_at1, dot(wi, M.t1), bound, &g_bound);
    const float g_y2 = clamp2_adjoint(g_at2, dot(wi, M.t2), bound, &g_bound);
    const float g_dn = dn >= 0.0f ? g_an + M.mu * g_bound : 0.0f;
    if constexpr (kMass) g_mu = g_bound * clamp_min(dn, 0.0f);  // bound = mu an
    g_wi = add(add(scale(M.n, g_dn), scale(M.t1, g_y1)), scale(M.t2, g_y2));
    g_n = add(g_n, scale(wi, g_dn));
    g_t1 = add(g_t1, scale(wi, g_y1));
    g_t2 = add(g_t2, scale(wi, g_y2));
  }
  store3(adj_warm + 3 * ip, g_wi);

  // the biases, through depth and the approach velocity vrel0 = (vb + wb ×
  // rb) - (va + wa × ra), vn0 = vrel0 · n
  V3 vrel0 = zero;
  float vn0 = 0.0f;
  if (needs_vn0(P)) {
    vrel0 = approach(in, a, b, ra, rb);
    vn0 = dot(vrel0, M.n);
  }
  const float depth = in.mdepth[ip];
  float g_vn0;
  adj_depth[ip] = bias_adjoint(bias_of(depth, vn0, P), depth, vn0, P, dr(kRowBias + p),
                               dr(kRowPosBias + p), &g_vn0);
  const V3 g_vrel = scale(M.n, g_vn0);
  g_n = add(g_n, scale(vrel0, g_vn0));
  const V3 wa0 = load3(in.bang + 3 * a), wb0 = load3(in.bang + 3 * b);
  const V3 g_va = neg(g_vrel), g_vb = g_vrel;
  const V3 g_wa = neg(cross(ra, g_vrel)), g_wb = cross(rb, g_vrel);
  g_ra = sub(g_ra, cross(g_vrel, wa0));
  g_rb = add(g_rb, cross(g_vrel, wb0));
  // ra = cp - pa, rb = cp - pb
  store3(adj_pos + 3 * ip, add(g_ra, g_rb));

  // the shared inputs: sums over the quad, then one lane each
  g_n = quad_sum3(mask, g_n);
  g_t1 = quad_sum3(mask, g_t1);
  g_t2 = quad_sum3(mask, g_t2);
  const V3 g_pa = quad_sum3(mask, neg(g_ra)), g_pb = quad_sum3(mask, neg(g_rb));
  g_qa = quad_sum4(mask, g_qa);
  g_qb = quad_sum4(mask, g_qb);
  const V3 s_va = quad_sum3(mask, g_va), s_vb = quad_sum3(mask, g_vb);
  const V3 s_wa = quad_sum3(mask, g_wa), s_wb = quad_sum3(mask, g_wb);
  if constexpr (kMass) {
    g_ima = quad_sum(mask, g_ima);
    g_imb = quad_sum(mask, g_imb);
    g_iia = quad_sum3(mask, g_iia);
    g_iib = quad_sum3(mask, g_iib);
    g_mu = quad_sum(mask, g_mu);
  }
  if (p < 2) {
    const int body = p ? b : a;
    const V3 gp = p ? g_pb : g_pa;
    const Q4 gq = p ? g_qb : g_qa;
    float* r = adj_body + (2 * i + p) * W;
    store3(r, gp);
    r[3] = gq.x;
    r[4] = gq.y;
    r[5] = gq.z;
    r[6] = gq.w;
    store3(r + 7, p ? s_vb : s_va);
    store3(r + 10, p ? s_wb : s_wa);
    if constexpr (kMass) {
      r[13] = p ? g_imb + dr(kRowImB) : g_ima + dr(kRowImA);
      store3(r + 14, p ? g_iib : g_iia);
    }
    static_keys[2 * i + p] = in.binvm[body] > 0.0f ? kNoBody : body;
  } else if (kMass && p == 3) {
    adj_fric[i] = g_mu + dr(kRowMu);
  } else if (p == 2) {
    // the rows' and the frame's own adjoints, then orthonormal_basis:
    // a = -1 / (sign + nz), b = nx ny a, t1 = (1 + sign nx nx a, sign b,
    // -sign nx), t2 = (b, sign + ny ny a, -ny), sign constant
    g_n = add(g_n, dr3(kRowN));
    g_t1 = add(add(g_t1, dr3(kRowT1)), load3(d_frame + 3 * i));
    g_t2 = add(add(g_t2, dr3(kRowT2)), load3(d_frame + 3 * (fm + i)));
    const V3 n = M.n;
    const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
    const float ca = -1.0f / (sign + n.z);
    const float g_b = sign * g_t1.y + g_t2.x;
    const float g_a = (sign * n.x * n.x) * g_t1.x + (n.y * n.y) * g_t2.y + (n.x * n.y) * g_b;
    g_n.x = g_n.x + (2.0f * sign * n.x * ca) * g_t1.x - sign * g_t1.z + (n.y * ca) * g_b;
    g_n.y = g_n.y + (2.0f * n.y * ca) * g_t2.y - g_t2.z + (n.x * ca) * g_b;
    g_n.z = g_n.z + (ca * ca) * g_a;
    store3(adj_normal + 3 * i, g_n);
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

// Adds into acc the adj_body rows (W words) of `body`'s entries in
// keys[0..n) (row 2 perm[e] + side, or perm[e] for side < 0), lane l
// taking entries l, l + 32, ... of the body's segment in order.
template <int W>
__device__ __forceinline__ void warp_rows(const int* __restrict__ keys,
                                          const long long* __restrict__ perm, int n, int side,
                                          int body, int lane,
                                          const float* __restrict__ adj_body, float* acc) {
  const int lo = lower_bound(keys, n, body);
  for (int e0 = lo;; e0 += 32) {
    const int e = e0 + lane;
    const bool in = e < n && keys[e] == body;
    if (in) {
      const long long row = side < 0 ? perm[e] : 2 * perm[e] + side;
      const float* r = adj_body + row * W;
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] = acc[c] + r[c];
    }
    if (!__any_sync(0xffffffffu, in)) break;
  }
}

// The backward's per-body sums, one warp a body: a dynamic body's rows
// through the forward's body-sorted side-a and side-b lists (live dynamic
// entries: keys_a/perm_a, keys_b/perm_b, which warm_apply walks), a static
// body's through the sorted static keys that setup_bwd_kernel wrote. Each
// lane sums its entries in order, then a fixed xor butterfly over the warp;
// velw's own adjoint (velw = v | w + the warm-start changes) is added to
// vel and angvel. W = kBodyInputsMass: also the inverse mass and inertia.
template <int W>
__global__ void __launch_bounds__(kThreads)
    setup_body_sum_kernel(const float* __restrict__ binvm, const int* __restrict__ keys_a,
                          const long long* __restrict__ perm_a, const int* __restrict__ keys_b,
                          const long long* __restrict__ perm_b,
                          const int* __restrict__ static_keys,
                          const long long* __restrict__ static_perm,
                          const float* __restrict__ adj_body, const float* __restrict__ d_velw,
                          int m, int n, float* __restrict__ g_pos, float* __restrict__ g_quat,
                          float* __restrict__ g_vel, float* __restrict__ g_ang,
                          float* __restrict__ g_invm, float* __restrict__ g_invi) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int body = (int)(t >> 5), lane = (int)(t & 31);
  if (body >= n) return;  // whole warps
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  if (binvm[body] > 0.0f) {
    warp_rows<W>(keys_a, perm_a, m, 0, body, lane, adj_body, acc);
    warp_rows<W>(keys_b, perm_b, m, 1, body, lane, adj_body, acc);
  } else {
    warp_rows<W>(static_keys, static_perm, 2 * m, -1, body, lane, adj_body, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < W; ++c)
      acc[c] = acc[c] + __shfl_xor_sync(0xffffffffu, acc[c], off);
  float x = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (lane == c) x = acc[c];
  if (lane < 3)
    g_pos[3 * body + lane] = x;
  else if (lane < 7)
    g_quat[4 * body + lane - 3] = x;
  else if (lane < 10)
    g_vel[3 * body + lane - 7] = x + d_velw[kVelRow * body + lane - 7];
  else if (lane < kBodyInputs)
    g_ang[3 * body + lane - 10] = x + d_velw[kVelRow * body + lane - 7];
  else if (lane == kBodyInputs && W > kBodyInputs)
    g_invm[body] = x;
  else if (lane < W)
    g_invi[3 * body + lane - kBodyInputs - 1] = x;
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

SetupParams params(float bod, float slop, float max_bias_vel, float deep_bias_depth,
                   float deep_bias_gate, float ungated_depth, float ungated_vel,
                   float max_pseudo_vel, float restitution, int split, int warm_start,
                   int use_pwarm) {
  return SetupParams{bod,           slop,        max_bias_vel,   deep_bias_depth, deep_bias_gate,
                     ungated_depth, ungated_vel, max_pseudo_vel, restitution,     split,
                     warm_start,    use_pwarm};
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
  const SetupParams P =
      params(bod, slop, max_bias_vel, deep_bias_depth, deep_bias_gate, ungated_depth,
             ungated_vel, max_pseudo_vel, restitution, split, warm_start, use_pwarm);
  if (m > 0) {
    const int blocks = blocks_for(m) < kSetupBlocks ? blocks_for(m) : kSetupBlocks;
    const SetupIn in{bpos, bquat, bvel, bang, binvm, binvi, normal,
                     fric, mpos, mdepth, pvalid, warm, pwarm_in};
    setup_kernel<<<blocks, kThreads, 0, stream>>>(in, body_a, body_b, relax, order, offsets,
                                                  max_colors, m, P, rows, work, frame);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    warm_apply_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        bvel, bang, keys_a, perm_a, keys_b, perm_b, slot, work, m, n, velw);
  }
  return (int)cudaGetLastError();
}

// The backward kernel of nudge_setup: from the adjoints of its outputs
// (d_rows, d_work in slot order, d_frame, d_velw) the adjoints of the
// manifolds' normal, pos, depth, warm and pwarm (every manifold: zeros for
// those not live), of each live manifold's two bodies' pos | quat | vel |
// angvel, adj_body[2m, 13] (row 2i + side), and the static-body keys
// static_keys[2m] (entry 2i + side: the body of a live manifold's static
// side, else INT_MAX). With adj_fric (else null) the mass instance: also
// the manifolds' friction adjoints adj_fric[m], and adj_body[2m, 17] rows
// with the bodies' inv_mass | inv_inertia adjoints after angvel's.
extern "C" int nudge_setup_bwd(
    const float* bpos, const float* bquat, const float* bvel, const float* bang,
    const float* binvm, const float* binvi, const int* body_a, const int* body_b,
    const float* normal, const float* fric, const float* mpos, const float* mdepth,
    const bool* pvalid, const float* warm, const float* pwarm_in, const long long* order,
    const int* offsets, int max_colors, int m, float bod, float slop, float max_bias_vel,
    float deep_bias_depth, float deep_bias_gate, float ungated_depth, float ungated_vel,
    float max_pseudo_vel, float restitution, int split, int warm_start, int use_pwarm,
    const float* d_rows, const float* d_work, const float* d_frame, const float* d_velw,
    float* adj_body, float* adj_normal, float* adj_pos, float* adj_depth, float* adj_warm,
    float* adj_pwarm, int* static_keys, float* adj_fric, void* stream_) {
  if (m <= 0) return 0;
  const SetupParams P =
      params(bod, slop, max_bias_vel, deep_bias_depth, deep_bias_gate, ungated_depth,
             ungated_vel, max_pseudo_vel, restitution, split, warm_start, use_pwarm);
  const SetupIn in{bpos, bquat, bvel, bang, binvm, binvi, normal,
                   fric, mpos, mdepth, pvalid, warm, pwarm_in};
  // one quad a manifold slot; slots past the live count write zeros
  const long long threads = 4LL * m;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (adj_fric)
    setup_bwd_kernel<true><<<blocks, kThreads, 0, stream>>>(
        in, body_a, body_b, order, offsets, max_colors, m, P, d_rows, d_work, d_frame, d_velw,
        adj_body, adj_normal, adj_pos, adj_depth, adj_warm, adj_pwarm, static_keys, adj_fric);
  else
    setup_bwd_kernel<false><<<blocks, kThreads, 0, stream>>>(
        in, body_a, body_b, order, offsets, max_colors, m, P, d_rows, d_work, d_frame, d_velw,
        adj_body, adj_normal, adj_pos, adj_depth, adj_warm, adj_pwarm, static_keys, adj_fric);
  return (int)cudaGetLastError();
}

// The backward's per-body sums (setup_body_sum_kernel): the adjoints of the
// bodies' pos [n, 3], quat [n, 4], vel [n, 3] and angvel [n, 3]; with g_invm
// (else null: adj_body rows of kBodyInputs words) also of inv_mass [n] and
// inv_inertia g_invi [n, 3], from rows of kBodyInputsMass words.
extern "C" int nudge_setup_body_sum(const float* binvm, const int* keys_a,
                                    const long long* perm_a, const int* keys_b,
                                    const long long* perm_b, const int* static_keys,
                                    const long long* static_perm, const float* adj_body,
                                    const float* d_velw, int m, int n, float* g_pos,
                                    float* g_quat, float* g_vel, float* g_ang, float* g_invm,
                                    float* g_invi, void* stream_) {
  if (n <= 0) return 0;
  const long long threads = 32LL * n;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (g_invm)
    setup_body_sum_kernel<kBodyInputsMass><<<blocks, kThreads, 0, stream>>>(
        binvm, keys_a, perm_a, keys_b, perm_b, static_keys, static_perm, adj_body, d_velw, m, n,
        g_pos, g_quat, g_vel, g_ang, g_invm, g_invi);
  else
    setup_body_sum_kernel<kBodyInputs><<<blocks, kThreads, 0, stream>>>(
        binvm, keys_a, perm_a, keys_b, perm_b, static_keys, static_perm, adj_body, d_velw, m, n,
        g_pos, g_quat, g_vel, g_ang, g_invm, g_invi);
  return (int)cudaGetLastError();
}
