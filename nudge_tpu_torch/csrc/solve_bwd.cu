// The backward of the iterated contact solve: the reverse sweep, in one
// launch of one thread-block cluster, as the forward (csrc/solve.cu).
//
// No TPU kernel had a backward: the reference differentiates its XLA twin
// of the solve (nudge_tpu/engine.py:35-40, "Pallas kernels carry no VJP"),
// as the port's CPU path differentiates ops/solver.py's solve_from.
//
// The forward, run with a tape (differentiable mode), records at each visit
// of a live slot the state the visit starts from: the two bodies' velw rows
// and the slot's 16 accumulators (common.cuh kTapeRows). This kernel runs
// the sweeps, the colors and, inside a visit, the <= 4 points in reverse.
// A visit is replayed from its tape row with the forward's operations in
// the forward's order (built with -fmad=false, so the replay is bitwise the
// forward's and every clamp takes the branch the forward took); point p is
// reached by replaying points 0..p-1, then its adjoint is taken. The clamp
// adjoints are autograd's for the twin's operations: torch.clamp_min passes
// the gradient where x >= 0, torch.maximum / torch.minimum split it in
// halves at a tie.
//
// Adjoint state, all in device memory:
//   - adj_velw[n, 12]: the adjoint of the bodies' velw at the current point
//     of the reverse sweep. A regular color writes a dynamic body in one
//     manifold only, so the reverse visit replaces the body's adjoint with
//     that of the velw it read (the write new = old + (new - old) passes
//     none to old directly), read and written as L2 operations between
//     cluster barriers, as the forward does with velw.
//   - adj_acc[16, m], adj_rows[kRows, m] (slot order): each slot's own
//     columns, updated only by the thread that owns the slot.
//   - adj_static[24, m]: static and sleeping bodies are never written, and
//     many manifolds of one color read them; each visit adds its reads'
//     adjoint to its own slot's column, over all sweeps, and the wrapper
//     sums the columns per body afterwards in a fixed order
//     (csrc/segment.cu). No float atomics anywhere: two backward runs from
//     one tape are bitwise equal.
//   - The spill color (Jacobi, the forward's spill_side): side b's sum is
//     undone first, then side a's, through the same body-sorted entry
//     lists: each entry's post-pass adjoint is its body's adjoint, and the
//     body keeps (1 - entries) of it; then the visits; then each body adds
//     its entries' read adjoints, side a then side b, in entry order.
//
// What bounds it on an H100: the order, as in the forward: sweeps x colors
// dependent passes, each a cluster barrier, an L2 round trip for adj_velw
// and the replayed 4-point chain (10 point updates and 4 point adjoints a
// visit). Bytes: per live manifold and sweep 160 B of tape, the rows and
// ~0.5 KB of row adjoints read and written.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBwdThreads = 256;  // per CTA
// scratch rows: the spill color's post-pass adjoints (side a | side b),
// then its read adjoints (side a | side b)
constexpr int kScratchPost = 0;
constexpr int kScratchRead = 2 * kVelRow;
constexpr int kScratchRows = 4 * kVelRow;

struct SolveBwdArgs {
  const float* rows;   // [kRows, m], slot order
  const float* tape;   // [iters, kTapeRows, m]
  float* adj_velw;     // [n, 12]: in, of the output velw; out, of the input velw
                       // except the static reads (adj_static)
  float* adj_acc;      // [16, m]: in, of the final accumulators; out, of the initial
  float* adj_rows;     // [kRows, m], zeroed by the caller
  float* adj_static;   // [24, m], zeroed by the caller: side a | side b
  float* scratch;      // [kScratchRows, m]
  const int* offsets;  // [max_colors + 1]
  const int* n_colors;
  const int* spill_color;
  const int* slot;
  const int *keys_a, *keys_b;
  const long long *perm_a, *perm_b;
  int m, iters, split, pfric;
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

// The running velocities of a visit's two bodies (v, w, pseudo v, pseudo w
// of side a, then of side b), or their adjoints.
struct Vel {
  V3 va, wa, pva, pwa, vb, wb, pvb, pwb;
};

__device__ __forceinline__ Vel vel_of(const float* a, const float* b) {
  Vel S;
  S.va = v3(a[0], a[1], a[2]);
  S.wa = v3(a[3], a[4], a[5]);
  S.pva = v3(a[6], a[7], a[8]);
  S.pwa = v3(a[9], a[10], a[11]);
  S.vb = v3(b[0], b[1], b[2]);
  S.wb = v3(b[3], b[4], b[5]);
  S.pvb = v3(b[6], b[7], b[8]);
  S.pwb = v3(b[9], b[10], b[11]);
  return S;
}

__device__ __forceinline__ void row_of(V3 v, V3 w, V3 pv, V3 pw, float* r) {
  const float x[kVelRow] = {v.x, v.y, v.z, w.x, w.y, w.z, pv.x, pv.y, pv.z, pw.x, pw.y, pw.z};
  for (int c = 0; c < kVelRow; ++c) r[c] = x[c];
}

// What a visit reads of its slot's rows (common.cuh kRow*).
struct Rows {
  const float* R;
  long long fm;
  __device__ __forceinline__ float q(int f) const { return __ldg(R + f * fm); }
  __device__ __forceinline__ V3 q3(int f) const { return v3(q(f), q(f + 1), q(f + 2)); }
};

// Point p of a visit, forward: csrc/solve.cu solve_manifold's operations in
// its order, on the running velocities S.
__device__ __forceinline__ void point_fwd(const Rows& R, int p, float relax, float mu, float ima,
                                          float imb, V3 n, V3 t1, V3 t2, const float* acc,
                                          bool split, bool pfric, Vel& S) {
  const float pm = relax * R.q(kRowPv + p);
  const V3 ra = R.q3(kRowRa + 3 * p), rb = R.q3(kRowRb + 3 * p);
  const V3 jna = R.q3(kRowJna + 3 * p), jnb = R.q3(kRowJnb + 3 * p);
  const V3 jt1a = R.q3(kRowJt1a + 3 * p), jt1b = R.q3(kRowJt1b + 3 * p);
  const V3 jt2a = R.q3(kRowJt2a + 3 * p), jt2b = R.q3(kRowJt2b + 3 * p);
  const float mn = R.q(kRowMn + p), mt1 = R.q(kRowMt1 + p), mt2 = R.q(kRowMt2 + p);
  const float an = acc[kWorkAccN + p], at1 = acc[kWorkAccT1 + p];
  const float at2 = acc[kWorkAccT2 + p], pp = acc[kWorkAccP + p];

  const V3 vrel = sub(sub(add(S.vb, cross(S.wb, rb)), S.va), cross(S.wa, ra));
  const float vn = dot(vrel, n);
  float dln = (R.q(kRowBias + p) - vn) * mn;
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
  S.va = sub(S.va, scale(Pimp, ima));
  S.vb = add(S.vb, scale(Pimp, imb));
  S.wa = sub(S.wa, add(add(scale(jna, dln), scale(jt1a, dlt1)), scale(jt2a, dlt2)));
  S.wb = add(S.wb, add(add(scale(jnb, dln), scale(jt1b, dlt1)), scale(jt2b, dlt2)));

  if (split) {
    const V3 pvrel = sub(sub(add(S.pvb, cross(S.pwb, rb)), S.pva), cross(S.pwa, ra));
    const float pvn = dot(pvrel, n);
    float dlp = (R.q(kRowPosBias + p) - pvn) * mn;
    const float new_p = fmaxf(pp + dlp, 0.0f);
    dlp = pm * (new_p - pp);
    const V3 Pp = scale(n, dlp);
    S.pva = sub(S.pva, scale(Pp, ima));
    S.pvb = add(S.pvb, scale(Pp, imb));
    S.pwa = sub(S.pwa, scale(jna, dlp));
    S.pwb = add(S.pwb, scale(jnb, dlp));
  }
}

// The adjoints of torch.minimum(torch.maximum(y, -bound), bound) at the
// forward's values: of y, and added into *a_bound.
__device__ __forceinline__ float clamp2_adjoint(float g, float y, float bound, float* a_bound) {
  const float m = fmaxf(y, -bound);
  float gm;  // of m = maximum(y, -bound)
  if (m < bound) {
    gm = g;
  } else if (m == bound) {
    gm = 0.5f * g;
    *a_bound = *a_bound + 0.5f * g;
  } else {
    gm = 0.0f;
    *a_bound = *a_bound + g;
  }
  float gy, gnb;  // of y and of -bound
  if (y > -bound) {
    gy = gm;
    gnb = 0.0f;
  } else if (y == -bound) {
    gy = 0.5f * gm;
    gnb = 0.5f * gm;
  } else {
    gy = 0.0f;
    gnb = gm;
  }
  *a_bound = *a_bound - gnb;
  return gy;
}

__device__ __forceinline__ void radd(float* AR, long long fm, int f, float x) {
  AR[f * fm] = AR[f * fm] + x;
}
__device__ __forceinline__ void radd3(float* AR, long long fm, int f, V3 x) {
  radd(AR, fm, f, x.x);
  radd(AR, fm, f + 1, x.y);
  radd(AR, fm, f + 2, x.z);
}

// The shared row adjoints of a visit: normal, tangents, friction.
struct Shared {
  V3 n, t1, t2;
  float mu;
};

// Point p of a visit, backward: S holds the velocities before the point
// (replayed), G the adjoint of those after it (on return, before it),
// Aacc the adjoint of the accumulators after the visit's point p (on
// return, before it). Row adjoints go to the slot's adj_rows column AR,
// the shared ones to `sh`.
__device__ __forceinline__ void point_bwd(const Rows& R, float* AR, int p, float relax, float mu,
                                          float ima, float imb, V3 n, V3 t1, V3 t2,
                                          const float* acc, bool split, bool pfric,
                                          const Vel& S, Vel& G, float* Aacc, Shared& sh) {
  const long long fm = R.fm;
  const float pm = relax * R.q(kRowPv + p);
  const V3 ra = R.q3(kRowRa + 3 * p), rb = R.q3(kRowRb + 3 * p);
  const V3 jna = R.q3(kRowJna + 3 * p), jnb = R.q3(kRowJnb + 3 * p);
  const V3 jt1a = R.q3(kRowJt1a + 3 * p), jt1b = R.q3(kRowJt1b + 3 * p);
  const V3 jt2a = R.q3(kRowJt2a + 3 * p), jt2b = R.q3(kRowJt2b + 3 * p);
  const float mn = R.q(kRowMn + p), mt1 = R.q(kRowMt1 + p), mt2 = R.q(kRowMt2 + p);
  const float bias = R.q(kRowBias + p), pos_bias = R.q(kRowPosBias + p);
  const float an = acc[kWorkAccN + p], at1 = acc[kWorkAccT1 + p];
  const float at2 = acc[kWorkAccT2 + p], pp = acc[kWorkAccP + p];

  // the forward's values at this point (point_fwd's operations)
  const V3 vrel = sub(sub(add(S.vb, cross(S.wb, rb)), S.va), cross(S.wa, ra));
  const float vn = dot(vrel, n);
  const float xn = an + (bias - vn) * mn;
  const float dln = pm * (fmaxf(xn, 0.0f) - an);
  const float sb = pfric ? an + dln + pp : an + dln + 0.0f;
  const float bound = mu * sb;
  const float vt1 = dot(vrel, t1);
  const float y1 = at1 - vt1 * mt1;
  const float dlt1 = pm * (fminf(fmaxf(y1, -bound), bound) - at1);
  const float vt2 = dot(vrel, t2);
  const float y2 = at2 - vt2 * mt2;
  const float dlt2 = pm * (fminf(fmaxf(y2, -bound), bound) - at2);
  V3 pvrel = v3(0.0f, 0.0f, 0.0f);
  float pvn = 0.0f, xp = 0.0f, dlp = 0.0f;
  if (split) {
    pvrel = sub(sub(add(S.pvb, cross(S.pwb, rb)), S.pva), cross(S.pwa, ra));
    pvn = dot(pvrel, n);
    xp = pp + (pos_bias - pvn) * mn;
    dlp = pm * (fmaxf(xp, 0.0f) - pp);
  }

  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 Ara = zero, Arb = zero, Ajna = zero, Ajnb = zero;
  float Amn = 0.0f, Apos_bias = 0.0f;
  // pp' = pp + dlp (split), else pp' = pp
  float App = Aacc[kWorkAccP + p];
  if (split) {
    float Adlp = Aacc[kWorkAccP + p];
    // pva' = pva - Pp ima, pvb' = pvb + Pp imb, pwa' = pwa - jna dlp,
    // pwb' = pwb + jnb dlp, Pp = n dlp
    const V3 APp = sub(scale(G.pvb, imb), scale(G.pva, ima));
    Adlp = Adlp + dot(G.pwb, jnb) - dot(G.pwa, jna);
    Ajna = sub(Ajna, scale(G.pwa, dlp));
    Ajnb = add(Ajnb, scale(G.pwb, dlp));
    sh.n = add(sh.n, scale(APp, dlp));
    Adlp = Adlp + dot(APp, n);
    // dlp = pm (clamp_min(xp, 0) - pp), xp = pp + (pos_bias - pvn) mn
    App = App - pm * Adlp;
    const float Axp = xp >= 0.0f ? pm * Adlp : 0.0f;
    App = App + Axp;
    Apos_bias = Axp * mn;
    Amn = Amn + Axp * (pos_bias - pvn);
    const float Apvn = -(Axp * mn);
    const V3 Apvrel = scale(n, Apvn);
    sh.n = add(sh.n, scale(pvrel, Apvn));
    G.pvb = add(G.pvb, Apvrel);
    G.pva = sub(G.pva, Apvrel);
    G.pwb = add(G.pwb, cross(rb, Apvrel));
    Arb = add(Arb, cross(Apvrel, S.pwb));
    G.pwa = sub(G.pwa, cross(ra, Apvrel));
    Ara = sub(Ara, cross(Apvrel, S.pwa));
  }

  // λ' = λ + Δλ for the three accumulators
  float Aan = Aacc[kWorkAccN + p], Adln = Aacc[kWorkAccN + p];
  float Aat1 = Aacc[kWorkAccT1 + p], Adlt1 = Aacc[kWorkAccT1 + p];
  float Aat2 = Aacc[kWorkAccT2 + p], Adlt2 = Aacc[kWorkAccT2 + p];
  // wa' = wa - (jna dln + jt1a dlt1 + jt2a dlt2), wb' = wb + (jnb dln + ...)
  Adln = Adln + dot(G.wb, jnb) - dot(G.wa, jna);
  Adlt1 = Adlt1 + dot(G.wb, jt1b) - dot(G.wa, jt1a);
  Adlt2 = Adlt2 + dot(G.wb, jt2b) - dot(G.wa, jt2a);
  Ajnb = add(Ajnb, scale(G.wb, dln));
  Ajna = sub(Ajna, scale(G.wa, dln));
  const V3 Ajt1b = scale(G.wb, dlt1), Ajt1a = neg(scale(G.wa, dlt1));
  const V3 Ajt2b = scale(G.wb, dlt2), Ajt2a = neg(scale(G.wa, dlt2));
  // va' = va - Pimp ima, vb' = vb + Pimp imb, Pimp = n dln + t1 dlt1 + t2 dlt2
  const V3 APimp = sub(scale(G.vb, imb), scale(G.va, ima));
  sh.n = add(sh.n, scale(APimp, dln));
  sh.t1 = add(sh.t1, scale(APimp, dlt1));
  sh.t2 = add(sh.t2, scale(APimp, dlt2));
  Adln = Adln + dot(APimp, n);
  Adlt1 = Adlt1 + dot(APimp, t1);
  Adlt2 = Adlt2 + dot(APimp, t2);
  // dlt = pm (clamp(y, ±bound) - at), y = at - vt mt, vt = vrel · t
  float Abound = 0.0f;
  V3 Avrel = zero;
  {
    Aat2 = Aat2 - pm * Adlt2;
    const float Ay = clamp2_adjoint(pm * Adlt2, y2, bound, &Abound);
    Aat2 = Aat2 + Ay;
    const float Avt = -(Ay * mt2);
    radd(AR, fm, kRowMt2 + p, -(Ay * vt2));
    Avrel = add(Avrel, scale(t2, Avt));
    sh.t2 = add(sh.t2, scale(vrel, Avt));
  }
  {
    Aat1 = Aat1 - pm * Adlt1;
    const float Ay = clamp2_adjoint(pm * Adlt1, y1, bound, &Abound);
    Aat1 = Aat1 + Ay;
    const float Avt = -(Ay * mt1);
    radd(AR, fm, kRowMt1 + p, -(Ay * vt1));
    Avrel = add(Avrel, scale(t1, Avt));
    sh.t1 = add(sh.t1, scale(vrel, Avt));
  }
  // bound = mu ((an + dln) + pp)
  sh.mu = sh.mu + Abound * sb;
  const float Asb = Abound * mu;
  Aan = Aan + Asb;
  Adln = Adln + Asb;
  if (pfric) App = App + Asb;
  // dln = pm (clamp_min(xn, 0) - an), xn = an + (bias - vn) mn
  Aan = Aan - pm * Adln;
  const float Axn = xn >= 0.0f ? pm * Adln : 0.0f;
  Aan = Aan + Axn;
  const float Abias = Axn * mn;
  Amn = Amn + Axn * (bias - vn);
  const float Avn = -(Axn * mn);
  Avrel = add(Avrel, scale(n, Avn));
  sh.n = add(sh.n, scale(vrel, Avn));
  // vrel = ((vb + wb × rb) - va) - wa × ra
  G.vb = add(G.vb, Avrel);
  G.va = sub(G.va, Avrel);
  G.wb = add(G.wb, cross(rb, Avrel));
  Arb = add(Arb, cross(Avrel, S.wb));
  G.wa = sub(G.wa, cross(ra, Avrel));
  Ara = sub(Ara, cross(Avrel, S.wa));

  Aacc[kWorkAccN + p] = Aan;
  Aacc[kWorkAccT1 + p] = Aat1;
  Aacc[kWorkAccT2 + p] = Aat2;
  Aacc[kWorkAccP + p] = App;
  radd3(AR, fm, kRowRa + 3 * p, Ara);
  radd3(AR, fm, kRowRb + 3 * p, Arb);
  radd3(AR, fm, kRowJna + 3 * p, Ajna);
  radd3(AR, fm, kRowJnb + 3 * p, Ajnb);
  radd3(AR, fm, kRowJt1a + 3 * p, Ajt1a);
  radd3(AR, fm, kRowJt1b + 3 * p, Ajt1b);
  radd3(AR, fm, kRowJt2a + 3 * p, Ajt2a);
  radd3(AR, fm, kRowJt2b + 3 * p, Ajt2b);
  radd(AR, fm, kRowMn + p, Amn);
  radd(AR, fm, kRowBias + p, Abias);
  radd(AR, fm, kRowPosBias + p, Apos_bias);
}

// The reverse of slot s's visit in sweep `it`. jacobi (the spill color):
// the visit's output adjoints are the post-pass adjoints in scratch, and
// its dynamic read adjoints go to scratch for the per-body sums.
__device__ __forceinline__ void reverse_visit(const SolveBwdArgs& A, int s, int it, bool jacobi) {
  const long long fm = A.m;
  const Rows R{A.rows + s, fm};
  const int a = __float_as_int(R.q(kRowBodyA));
  const int b = __float_as_int(R.q(kRowBodyB));
  const float ima = R.q(kRowImA), imb = R.q(kRowImB);
  const float relax = R.q(kRowRelax), mu = R.q(kRowMu);
  const V3 n = R.q3(kRowN), t1 = R.q3(kRowT1), t2 = R.q3(kRowT2);
  const bool dyn_a = ima > 0.0f, dyn_b = imb > 0.0f;

  const float* T = A.tape + (long long)it * kTapeRows * fm + s;
  float olda[kVelRow], oldb[kVelRow], acc[16];
  for (int c = 0; c < kVelRow; ++c) {
    olda[c] = T[c * fm];
    oldb[c] = T[(kVelRow + c) * fm];
  }
  for (int f = 0; f < 16; ++f) acc[f] = T[(2 * kVelRow + f) * fm];

  // the adjoint of what the visit wrote: a static side writes nothing
  float ga[kVelRow], gb[kVelRow];
  for (int c = 0; c < kVelRow; ++c) ga[c] = gb[c] = 0.0f;
  if (!jacobi) {
    if (dyn_a) load_row(A.adj_velw + kVelRow * a, ga);
    if (dyn_b) load_row(A.adj_velw + kVelRow * b, gb);
  } else {
    for (int c = 0; c < kVelRow; ++c) {
      if (dyn_a) ga[c] = __ldcg(A.scratch + (kScratchPost + c) * fm + s);
      if (dyn_b) gb[c] = __ldcg(A.scratch + (kScratchPost + kVelRow + c) * fm + s);
    }
  }
  float Aacc[16];
  for (int f = 0; f < 16; ++f) Aacc[f] = A.adj_acc[f * fm + s];
  Vel G = vel_of(ga, gb);
  Shared sh{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), 0.0f};
  float* AR = A.adj_rows + s;
  const bool split = A.split, pfric = A.pfric;
  for (int p = 3; p >= 0; --p) {
    Vel S = vel_of(olda, oldb);
    for (int k = 0; k < p; ++k)
      point_fwd(R, k, relax, mu, ima, imb, n, t1, t2, acc, split, pfric, S);
    point_bwd(R, AR, p, relax, mu, ima, imb, n, t1, t2, acc, split, pfric, S, G, Aacc, sh);
  }
  for (int f = 0; f < 16; ++f) A.adj_acc[f * fm + s] = Aacc[f];
  radd3(AR, fm, kRowN, sh.n);
  radd3(AR, fm, kRowT1, sh.t1);
  radd3(AR, fm, kRowT2, sh.t2);
  radd(AR, fm, kRowMu, sh.mu);

  // the adjoints of the reads
  float ra_[kVelRow], rb_[kVelRow];
  row_of(G.va, G.wa, G.pva, G.pwa, ra_);
  row_of(G.vb, G.wb, G.pvb, G.pwb, rb_);
  const bool dyn[2] = {dyn_a, dyn_b};
  const int body[2] = {a, b};
  for (int side = 0; side < 2; ++side) {
    const float* r = side ? rb_ : ra_;
    if (!dyn[side]) {
      float* st = A.adj_static + side * kVelRow * fm + s;
      for (int c = 0; c < kVelRow; ++c) st[c * fm] = st[c * fm] + r[c];
    } else if (!jacobi) {
      store_row(A.adj_velw + kVelRow * body[side], r);
    } else {
      for (int c = 0; c < kVelRow; ++c)
        __stcg(A.scratch + (kScratchRead + side * kVelRow + c) * fm + s, r[c]);
    }
  }
}

// The spill color's Jacobi sum for one side, reversed: one thread per body
// segment of the body-sorted entries; each entry in [lo, hi) takes the
// body's adjoint as its post-pass adjoint, and the body keeps its adjoint
// minus one copy of it per entry (the forward added post - base per entry).
__device__ __forceinline__ void spill_side_bwd(const SolveBwdArgs& A, const int* keys,
                                               const long long* perm, int side, int lo, int hi,
                                               int g, int stride) {
  const long long fm = A.m;
  float* post = A.scratch + (kScratchPost + side * kVelRow) * fm;
  for (int e = g; e < A.m; e += stride) {
    const int body = keys[e];
    if (body == 0x7fffffff) break;
    if (e > 0 && keys[e - 1] == body) continue;  // not the segment's first entry
    float base[kVelRow], h[kVelRow];
    bool any = false;
    for (int j = e; j < A.m && keys[j] == body; ++j) {
      const int s = A.slot[perm[j]];
      if (s < lo || s >= hi) continue;
      if (!any) {
        load_row(A.adj_velw + kVelRow * body, base);
        for (int c = 0; c < kVelRow; ++c) h[c] = base[c];
        any = true;
      }
      for (int c = 0; c < kVelRow; ++c) {
        __stcg(post + c * fm + s, base[c]);
        h[c] = h[c] - base[c];
      }
    }
    if (any) store_row(A.adj_velw + kVelRow * body, h);
  }
}

// Each body adds its spill-color entries' read adjoints (one side), in
// entry order.
__device__ __forceinline__ void spill_side_reads(const SolveBwdArgs& A, const int* keys,
                                                 const long long* perm, int side, int lo, int hi,
                                                 int g, int stride) {
  const long long fm = A.m;
  const float* rd = A.scratch + (kScratchRead + side * kVelRow) * fm;
  for (int e = g; e < A.m; e += stride) {
    const int body = keys[e];
    if (body == 0x7fffffff) break;
    if (e > 0 && keys[e - 1] == body) continue;
    float acc[kVelRow];
    bool any = false;
    for (int j = e; j < A.m && keys[j] == body; ++j) {
      const int s = A.slot[perm[j]];
      if (s < lo || s >= hi) continue;
      if (!any) {
        load_row(A.adj_velw + kVelRow * body, acc);
        any = true;
      }
      for (int c = 0; c < kVelRow; ++c) acc[c] = acc[c] + __ldcg(rd + c * fm + s);
    }
    if (any) store_row(A.adj_velw + kVelRow * body, acc);
  }
}

__global__ void __launch_bounds__(kBwdThreads) solve_bwd_kernel(SolveBwdArgs A) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int stride = nb * kBwdThreads;
  // the forward's slot-to-thread map: a slot's columns are this thread's
  const int g = ((threadIdx.x >> 5) * nb + (int)cluster.block_rank()) * 32 + (threadIdx.x & 31);
  const int n_colors = max(*A.n_colors, 1);
  const int spill = *A.spill_color;
  for (int it = A.iters - 1; it >= 0; --it) {
    for (int c = n_colors - 1; c >= 0; --c) {
      const int lo = A.offsets[c], hi = A.offsets[c + 1];
      if (lo == hi) continue;
      if (c == spill) {
        spill_side_bwd(A, A.keys_b, A.perm_b, 1, lo, hi, g, stride);
        cluster.sync();
        spill_side_bwd(A, A.keys_a, A.perm_a, 0, lo, hi, g, stride);
        cluster.sync();
        for (int s = lo + g; s < hi; s += stride) reverse_visit(A, s, it, true);
        cluster.sync();
        spill_side_reads(A, A.keys_a, A.perm_a, 0, lo, hi, g, stride);
        cluster.sync();
        spill_side_reads(A, A.keys_b, A.perm_b, 1, lo, hi, g, stride);
        cluster.sync();
      } else {
        for (int s = lo + g; s < hi; s += stride) reverse_visit(A, s, it, false);
        cluster.sync();
      }
    }
  }
}

int g_cluster = 0;  // the cluster size, chosen at the first launch

cudaError_t choose_bwd_cluster() {
  return choose_cluster(solve_bwd_kernel, kBwdThreads, 0, &g_cluster);
}

}  // namespace

// The cluster size the backward launches with (0 before the first choice).
extern "C" int nudge_solve_bwd_cluster() {
  if (choose_bwd_cluster() != cudaSuccess) return 0;
  return g_cluster;
}

extern "C" int nudge_solve_bwd(
    // the forward's rows and tape
    const float* rows, const float* tape,
    // adjoints: velw [n, 12] and the accumulators [16, m] (in and out), the
    // rows [kRows, m] and the static reads [24, m] (out, zeroed), scratch
    float* adj_velw, float* adj_acc, float* adj_rows, float* adj_static, float* scratch,
    // the forward's color segments, slots and body-sorted entries
    const int* offsets, const int* n_colors, const int* spill_color, const int* slot,
    const int* keys_a, const long long* perm_a, const int* keys_b, const long long* perm_b,
    int m, int iters, int split, int pfric, void* stream_) {
  if (m <= 0) return 0;
  cudaError_t err = choose_bwd_cluster();
  if (err != cudaSuccess) return (int)err;
  SolveBwdArgs A{rows,     tape,    adj_velw,    adj_acc, adj_rows, adj_static,
                 scratch,  offsets, n_colors,    spill_color, slot, keys_a,
                 keys_b,   perm_a,  perm_b,      m,       iters,    split,
                 pfric};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(g_cluster, kBwdThreads, 0, (cudaStream_t)stream_, &attr);
  err = cudaLaunchKernelEx(&cfg, solve_bwd_kernel, A);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
