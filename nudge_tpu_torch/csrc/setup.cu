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
// The per-manifold math, setup_manifold, is a template over its scalar
// type and hands every output to an emitter: the forward kernel's stores
// it, the backward kernel's (setup_bwd_kernel, differentiable mode) runs it
// on the dual numbers of dual.cuh with one input seeded and dots the
// outputs' tangents with their adjoints.
//
// What bounds it on an H100: memory. Per live manifold ~156 B are read and
// ~656 B written (139 row words, 16 accumulators, 24 delta words, 24 B of
// frame); at the pile's 11,971 live manifolds that is ~10 MB, ~3 us at
// 3.35 TB/s; the arithmetic (three effective masses per point) is far
// below the float rate. One thread per manifold with ~2,000 dependent
// instructions, so at this size the chain's latency, not the bytes, sets
// the time.

#include "dual.cuh"

namespace {

struct SetupParams {
  float bod;  // baumgarte / dt
  float slop, max_bias_vel, deep_bias_depth, deep_bias_gate, ungated_depth, ungated_vel;
  float max_pseudo_vel, restitution;
  int split, warm_start, use_pwarm;
};

constexpr int kSetupBlocks = 264;  // 2 per SM; a grid-stride loop covers the rest

// The inputs of one manifold's setup that carry a gradient, in the order of
// the backward kernel's tangents: body a's pos (0-2), quat (3-6), vel
// (7-9), angvel (10-12), then body b's (13-25), the normal (26-28), the 4
// points' pos (29-40), depth (41-44), warm impulse (45-56) and warm pseudo
// impulse (57-60).
constexpr int kBodyInputs = 13;
constexpr int kInNormal = 26;
constexpr int kInPos = 29;
constexpr int kInDepth = 41;
constexpr int kInWarm = 45;
constexpr int kInPwarm = 57;
constexpr int kSetupTangents = 61;

struct SetupIn {
  const float *bpos, *bquat, *bvel, *bang, *binvm, *binvi;
  const float *normal, *fric, *mpos, *mdepth;
  const bool* pvalid;
  const float *warm, *pwarm;
};

template <typename T>
__device__ __forceinline__ void eff(Vec3<T> ra, Vec3<T> rb, Vec3<T> d, Quat<T> qa, Quat<T> qb,
                                    Vec3<T> iia, Vec3<T> iib, float ima, float imb,
                                    Vec3<T>* ja, Vec3<T>* jb, T* m) {
  Vec3<T> rna = cross(ra, d);
  Vec3<T> rnb = cross(rb, d);
  *ja = inv_inertia_apply(qa, iia, rna);
  *jb = inv_inertia_apply(qb, iib, rnb);
  T k = ima + imb + dot(rna, *ja) + dot(rnb, *jb);
  *m = k > 0.0f ? 1.0f / clamp_min(k, 1e-12f) : T(0.0f);
}

// Manifold i's setup (bodies a, b), the twin's math over scalars of type T
// (float, or Dual with input `seed` seeded, -1 for none). Every output goes
// through `out`: out.row(f, x) for constraint row field f, out.work(f, x)
// for accumulator row f, out.frame(k, x) for t1 (k < 3) and t2, and
// out.delta(side, c, x) for column c of the warm-start velocity change of
// side a (0) or b (1).
template <typename T, typename Out>
__device__ __forceinline__ void setup_manifold(const SetupIn& in, long long i, int a, int b,
                                               const SetupParams& P, int seed, Out& out) {
  const Vec3<T> n = seeded3<T>(in.normal + 3 * i, kInNormal, seed);
  Vec3<T> t1, t2;
  orthonormal_basis(n, &t1, &t2);
  for (int k = 0; k < 3; ++k) {
    out.frame(k, get(t1, k));
    out.frame(3 + k, get(t2, k));
  }
  const Vec3<T> pa = seeded3<T>(in.bpos + 3 * a, 0, seed);
  const Vec3<T> pb = seeded3<T>(in.bpos + 3 * b, kBodyInputs, seed);
  const Quat<T> qa = seeded4<T>(in.bquat + 4 * a, 3, seed);
  const Quat<T> qb = seeded4<T>(in.bquat + 4 * b, kBodyInputs + 3, seed);
  const V3 iia_f = load3(in.binvi + 3 * a), iib_f = load3(in.binvi + 3 * b);
  const Vec3<T> iia = v3(T(iia_f.x), T(iia_f.y), T(iia_f.z));
  const Vec3<T> iib = v3(T(iib_f.x), T(iib_f.y), T(iib_f.z));
  const float ima = in.binvm[a], imb = in.binvm[b];
  const Vec3<T> va0 = seeded3<T>(in.bvel + 3 * a, 7, seed);
  const Vec3<T> vb0 = seeded3<T>(in.bvel + 3 * b, kBodyInputs + 7, seed);
  const Vec3<T> wa0 = seeded3<T>(in.bang + 3 * a, 10, seed);
  const Vec3<T> wb0 = seeded3<T>(in.bang + 3 * b, kBodyInputs + 10, seed);
  const float mu = in.fric[i];
  for (int k = 0; k < 3; ++k) {
    out.row(kRowN + k, get(n, k));
    out.row(kRowT1 + k, get(t1, k));
    out.row(kRowT2 + k, get(t2, k));
  }
  out.row(kRowMu, T(mu));
  out.row(kRowImA, T(ima));
  out.row(kRowImB, T(imb));

  // Σ over points (in point order) of the warm impulses' effects
  T sn = 0.0f, s1 = 0.0f, s2 = 0.0f, sp = 0.0f;
  Vec3<T> dwa = v3(T(0.0f), T(0.0f), T(0.0f)), dwb = dwa, pdwa = dwa, pdwb = dwa;

  for (int p = 0; p < 4; ++p) {
    const long long ip = 4 * i + p;
    const bool pv = in.pvalid[ip];
    const Vec3<T> cp = seeded3<T>(in.mpos + 3 * ip, kInPos + 3 * p, seed);
    const Vec3<T> ra = sub(cp, pa), rb = sub(cp, pb);
    Vec3<T> jna, jnb, jt1a, jt1b, jt2a, jt2b;
    T mn, mt1, mt2;
    eff(ra, rb, n, qa, qb, iia, iib, ima, imb, &jna, &jnb, &mn);
    eff(ra, rb, t1, qa, qb, iia, iib, ima, imb, &jt1a, &jt1b, &mt1);
    eff(ra, rb, t2, qa, qb, iia, iib, ima, imb, &jt2a, &jt2b, &mt2);

    const T depth = seeded<T>(in.mdepth[ip], kInDepth + p, seed);
    const T baum = clamp_max(P.bod * clamp_min(depth - P.slop, 0.0f), P.max_bias_vel);
    T vn0 = 0.0f;
    const bool need_vn0 = P.restitution > 0.0f || (P.split && P.deep_bias_gate >= 0.0f);
    if (need_vn0) {
      Vec3<T> vrel0 = sub(add(vb0, cross(wb0, rb)), add(va0, cross(wa0, ra)));
      vn0 = dot(vrel0, n);
    }
    T bias, pos_bias;
    if (P.split) {
      bias = clamp_max(P.bod * clamp_min(depth - P.deep_bias_depth, 0.0f), P.max_bias_vel);
      if (P.deep_bias_gate >= 0.0f) {
        bias = minimum(bias, clamp_min(-vn0 - P.deep_bias_gate, 0.0f));
        bias = maximum(bias, clamp_max(P.bod * clamp_min(depth - P.ungated_depth, 0.0f),
                                       P.ungated_vel));
      }
      pos_bias = clamp_max(P.bod * clamp_min(depth - P.slop, 0.0f), P.max_pseudo_vel);
    } else {
      bias = baum;
      pos_bias = 0.0f;
    }
    if (P.restitution > 0.0f)
      bias = maximum(bias, P.restitution * clamp_min(-vn0 - 1.0f, 0.0f));

    T an = 0.0f, at1 = 0.0f, at2 = 0.0f;
    if (P.warm_start) {
      const Vec3<T> wi = seeded3<T>(in.warm + 3 * ip, kInWarm + 3 * p, seed);
      T n_ = clamp_min(dot(wi, n), 0.0f);
      T bound = mu * n_;
      T x1 = minimum(maximum(dot(wi, t1), -bound), bound);
      T x2 = minimum(maximum(dot(wi, t2), -bound), bound);
      an = pv ? n_ : T(0.0f);
      at1 = pv ? x1 : T(0.0f);
      at2 = pv ? x2 : T(0.0f);
    }
    const T pw =
        (P.use_pwarm && pv) ? seeded<T>(in.pwarm[ip], kInPwarm + p, seed) : T(0.0f);

    for (int k = 0; k < 3; ++k) {
      const int c = 3 * p + k;
      out.row(kRowRa + c, get(ra, k));
      out.row(kRowRb + c, get(rb, k));
      out.row(kRowJna + c, get(jna, k));
      out.row(kRowJnb + c, get(jnb, k));
      out.row(kRowJt1a + c, get(jt1a, k));
      out.row(kRowJt1b + c, get(jt1b, k));
      out.row(kRowJt2a + c, get(jt2a, k));
      out.row(kRowJt2b + c, get(jt2b, k));
    }
    out.row(kRowMn + p, mn);
    out.row(kRowMt1 + p, mt1);
    out.row(kRowMt2 + p, mt2);
    out.row(kRowBias + p, bias);
    out.row(kRowPosBias + p, pos_bias);
    out.row(kRowPwarm + p, pw);
    out.row(kRowPv + p, T(pv ? 1.0f : 0.0f));
    out.work(kWorkAccN + p, an);
    out.work(kWorkAccT1 + p, at1);
    out.work(kWorkAccT2 + p, at2);
    out.work(kWorkAccP + p, pw);

    // per-point angular terms, then the running sums over points
    const Vec3<T> ta = add(add(scale(jna, an), scale(jt1a, at1)), scale(jt2a, at2));
    const Vec3<T> tb = add(add(scale(jnb, an), scale(jt1b, at1)), scale(jt2b, at2));
    const Vec3<T> pta = scale(jna, pw), ptb = scale(jnb, pw);
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

  const Vec3<T> Pw = add(add(scale(n, sn), scale(t1, s1)), scale(t2, s2));
  const Vec3<T> Pp = scale(n, sp);
  const Vec3<T> da[4] = {scale(neg(Pw), ima), neg(dwa), scale(neg(Pp), ima), neg(pdwa)};
  const Vec3<T> db[4] = {scale(Pw, imb), dwb, scale(Pp, imb), pdwb};
  for (int q = 0; q < 4; ++q) {
    for (int k = 0; k < 3; ++k) {
      out.delta(0, 3 * q + k, get(da[q], k));
      out.delta(1, 3 * q + k, get(db[q], k));
    }
  }
}

// The forward's outputs: slot s's rows and work rows, manifold i's frame.
struct SetupStore {
  float *R, *W, *F;
  long long fm, i;
  __device__ __forceinline__ void row(int f, float x) { R[f * fm] = x; }
  __device__ __forceinline__ void work(int f, float x) { W[f * fm] = x; }
  __device__ __forceinline__ void frame(int k, float x) {
    if (k < 3)
      F[3 * i + k] = x;
    else
      F[3 * (fm + i) + k - 3] = x;
  }
  __device__ __forceinline__ void delta(int side, int c, float x) {
    W[(kWorkScratch + side * kVelRow + c) * fm] = x;
  }
};

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
    R[kRowRelax * fm] = relax[i];
    R[kRowBodyA * fm] = __int_as_float(a);
    R[kRowBodyB * fm] = __int_as_float(b);
    SetupStore out{R, work + s, frame, fm, i};
    setup_manifold<float>(in, i, a, b, P, -1, out);
  }
}

// The backward's adjoint dot: Σ tangent · output adjoint over slot s's rows
// and accumulator rows, manifold i's frame and, for a dynamic side, the
// warm-start change's adjoint (the body's velw adjoint: warm_apply adds it
// to the body's row).
struct SetupAdjoint {
  const float *d_rows, *d_work, *d_frame, *d_va, *d_vb;
  long long fm, s, i;
  float g;
  __device__ __forceinline__ void row(int f, Dual x) { g = g + x.d * d_rows[f * fm + s]; }
  __device__ __forceinline__ void work(int f, Dual x) { g = g + x.d * d_work[f * fm + s]; }
  __device__ __forceinline__ void frame(int k, Dual x) {
    g = g + x.d * (k < 3 ? d_frame[3 * i + k] : d_frame[3 * (fm + i) + k - 3]);
  }
  __device__ __forceinline__ void delta(int side, int c, Dual x) {
    const float* d = side ? d_vb : d_va;
    if (d) g = g + x.d * d[c];
  }
};

// The backward: thread (s, j) runs live slot s's manifold once more with
// input j seeded (setup_manifold<Dual>, kSetupTangents threads a slot) and
// writes the adjoint of input j: a body input into the manifold's body row
// adj_body[2i + side][0..12] (the per-body sums are csrc/segment.cu's), a
// manifold input into its own adjoint array, which no other thread writes.
//
// What bounds it on an H100: the forward's chain with a tangent beside each
// value (~3x its ~2,200 operations), 61 times a live manifold; per slot it
// reads the forward's ~156 B of inputs and ~1 KB of output adjoints (L2
// hits after the first of its 61 threads) and writes 61 floats.
__global__ void __launch_bounds__(kThreads)
    setup_bwd_kernel(SetupIn in, const int* __restrict__ body_a,
                     const int* __restrict__ body_b, const long long* __restrict__ order,
                     const int* __restrict__ offsets, int max_colors, int m, SetupParams P,
                     const float* __restrict__ d_rows, const float* __restrict__ d_work,
                     const float* __restrict__ d_frame, const float* __restrict__ d_velw,
                     float* __restrict__ adj_body, float* __restrict__ adj_normal,
                     float* __restrict__ adj_pos, float* __restrict__ adj_depth,
                     float* __restrict__ adj_warm, float* __restrict__ adj_pwarm) {
  const int live = offsets[max_colors];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)live * kSetupTangents) return;
  const int s = (int)(t / kSetupTangents), j = (int)(t % kSetupTangents);
  const long long i = order[s];
  const int a = body_a[i], b = body_b[i];
  SetupAdjoint out{d_rows,
                   d_work,
                   d_frame,
                   in.binvm[a] > 0.0f ? d_velw + kVelRow * a : nullptr,
                   in.binvm[b] > 0.0f ? d_velw + kVelRow * b : nullptr,
                   m,
                   s,
                   i,
                   0.0f};
  setup_manifold<Dual>(in, i, a, b, P, j, out);
  const float g = out.g;
  if (j < 2 * kBodyInputs)
    adj_body[(2 * i + j / kBodyInputs) * kBodyInputs + j % kBodyInputs] = g;
  else if (j < kInPos)
    adj_normal[3 * i + j - kInNormal] = g;
  else if (j < kInDepth)
    adj_pos[12 * i + j - kInPos] = g;
  else if (j < kInWarm)
    adj_depth[4 * i + j - kInDepth] = g;
  else if (j < kInPwarm)
    adj_warm[12 * i + j - kInWarm] = g;
  else
    adj_pwarm[4 * i + j - kInPwarm] = g;
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

// The backward of nudge_setup: from the adjoints of its outputs (d_rows,
// d_work in slot order, d_frame, d_velw) the adjoints of the manifolds'
// normal, pos, depth, warm and pwarm (zeroed by the caller: only live
// manifolds are written) and of each live manifold's two bodies'
// pos | quat | vel | angvel, adj_body[2m, 13] (row 2i + side).
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
    float* adj_pwarm, void* stream_) {
  if (m <= 0) return 0;
  const SetupParams P{bod,           slop,        max_bias_vel,   deep_bias_depth, deep_bias_gate,
                      ungated_depth, ungated_vel, max_pseudo_vel, restitution,     split,
                      warm_start,    use_pwarm};
  const SetupIn in{bpos, bquat, bvel, bang, binvm, binvi, normal,
                   fric, mpos, mdepth, pvalid, warm, pwarm_in};
  // one thread a (manifold slot, input); slots past the live count exit
  const long long threads = (long long)m * kSetupTangents;
  setup_bwd_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream_>>>(in, body_a, body_b, order, offsets, max_colors, m,
                                              P, d_rows, d_work, d_frame, d_velw, adj_body,
                                              adj_normal, adj_pos, adj_depth, adj_warm,
                                              adj_pwarm);
  return (int)cudaGetLastError();
}
