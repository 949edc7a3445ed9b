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
// the sweeps and the colors in reverse, and each visit's <= 4 points.
//
// Lane map: one manifold on two lanes of a warp (a lane pair), lane l
// holding points 2l and 2l + 1. A pair walks the same slots on every
// sweep (warps interleaved over the cluster's CTAs as in the forward), so
// a slot's accumulator and row adjoints are only ever touched by its own
// lanes.
//   - The forward replay climbs the pair: lane 0 runs points 0 and 1 from
//     the tape's two velw rows and hands the 24 running velocities to lane
//     1 (__shfl_up_sync), which runs point 2: 3 point updates in series,
//     each lane keeping the velocities before each of its points. Each
//     update is the forward's operations in the forward's order (built
//     with -fmad=false), so the replay is bitwise the forward's and every
//     clamp takes the branch the forward took.
//   - The reverse chain descends it: lane 1 takes the adjoint of what the
//     visit wrote and runs points 3 and 2's adjoints, hands G, the 24
//     velocity adjoints, to lane 0 (__shfl_down_sync), which runs points 1
//     and 0's and holds the adjoint of the visit's reads: 4 point adjoints
//     in series. The clamp adjoints are autograd's for the twin's
//     operations: torch.clamp_min passes the gradient where x >= 0,
//     torch.maximum / torch.minimum split it in halves at a tie.
//   - The stash: at the visit's start cp.async copies into shared memory
//     each lane's points' row words (30 a point) and every word the visit
//     adds into (the points' 29 row adjoints and 4 accumulator adjoints,
//     the shared rows the lane adds, on lane 0 the static-read columns);
//     the replay and the reverse read the rows there, the visit adds into
//     the stash, and its end writes the added words back, once each. So
//     no row word is read from device memory twice in a visit, the rows
//     take no registers between the replay and the reverse, and no add
//     waits on device memory: with a load and a store a field issued in
//     turn, each point waited out 29 round trips, which was most of a
//     pass.
//   - The shared row adjoints (n, t1, t2, mu) are summed over the pair,
//     lane 0 + lane 1 by an xor shuffle, which leaves the same bits in both
//     lanes; lane 0 then adds n and t2, lane 1 t1 and mu.
//   - Two lanes, not four: a manifold on four lanes needs more than the
//     128 registers 512 threads a CTA leave (it spilled and ran slower);
//     on two lanes at 256 threads it fits 255 registers. Either way 2,048
//     manifolds a round on 16 CTAs (PERF.md).
//
// Adjoint state, all in device memory:
//   - adj_velw[n, 12]: the adjoint of the bodies' velw at the current point
//     of the reverse sweep. A regular color writes a dynamic body in one
//     manifold only, so the reverse visit replaces the body's adjoint with
//     that of the velw it read (the write new = old + (new - old) passes
//     none to old directly), read and written as L2 operations between
//     cluster barriers, as the forward does with velw.
//   - adj_acc[16, m], adj_rows[kRows, m] (slot order): each slot's own
//     columns, updated only by its own lanes.
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
//     its entries' read adjoints, side a then side b, in entry order. One
//     thread a body segment, on the forward's thread map.
//
// What bounds it on an H100: the order, as in the forward: sweeps x colors
// dependent passes, each a cluster barrier and one round of visits (more
// for a color of more than 2,048 live manifolds: 16 CTAs of 256 threads,
// 250 registers and a 160 KB stash each, hold 2,048). A visit is two
// memory round trips (the rows, the tape and the stash; then adj_velw by
// body id) and a chain of ~2,000 mostly dependent instructions (3 point
// updates, 4 point adjoints, two hand-offs) on a warp that shares its
// scheduler with one other: the chain, not the bytes, sets a round
// (PERF.md). Bytes: per live manifold and sweep 160 B of tape, the rows
// and ~0.6 KB of adjoints read and written.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// A manifold's 4 points on kLanes lanes of a warp, kPointsPerLane a lane.
constexpr int kPointsPerLane = 2;
constexpr int kLanes = 4 / kPointsPerLane;
constexpr int kBwdThreads = 256;  // per CTA
constexpr int kGroupsPerWarp = 32 / kLanes;
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

// Lane-to-lane hand-offs inside a manifold's lanes (width kLanes): up,
// lane l takes lane l - 1's value; down, lane l + 1's.
__device__ __forceinline__ V3 shfl_up3(unsigned mask, V3 v) {
  return v3(__shfl_up_sync(mask, v.x, 1, kLanes), __shfl_up_sync(mask, v.y, 1, kLanes),
            __shfl_up_sync(mask, v.z, 1, kLanes));
}
__device__ __forceinline__ V3 shfl_down3(unsigned mask, V3 v) {
  return v3(__shfl_down_sync(mask, v.x, 1, kLanes), __shfl_down_sync(mask, v.y, 1, kLanes),
            __shfl_down_sync(mask, v.z, 1, kLanes));
}
__device__ __forceinline__ Vel shfl_up_vel(unsigned mask, const Vel& S) {
  return Vel{shfl_up3(mask, S.va),  shfl_up3(mask, S.wa),  shfl_up3(mask, S.pva),
             shfl_up3(mask, S.pwa), shfl_up3(mask, S.vb),  shfl_up3(mask, S.wb),
             shfl_up3(mask, S.pvb), shfl_up3(mask, S.pwb)};
}
__device__ __forceinline__ Vel shfl_down_vel(unsigned mask, const Vel& S) {
  return Vel{shfl_down3(mask, S.va),  shfl_down3(mask, S.wa),  shfl_down3(mask, S.pva),
             shfl_down3(mask, S.pwa), shfl_down3(mask, S.vb),  shfl_down3(mask, S.wb),
             shfl_down3(mask, S.pvb), shfl_down3(mask, S.pwb)};
}

// The sum over a manifold's lanes by xor shuffles, (lane 0 + lane 1) (+
// (lane 2 + lane 3)), in every lane: float addition commutes bit for bit,
// so all hold the same.
__device__ __forceinline__ float lanes_sum(unsigned mask, float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) x = x + __shfl_xor_sync(mask, x, off, kLanes);
  return x;
}
__device__ __forceinline__ V3 lanes_sum3(unsigned mask, V3 v) {
  return v3(lanes_sum(mask, v.x), lanes_sum(mask, v.y), lanes_sum(mask, v.z));
}

// One point's row words (common.cuh kRow*).
struct Point {
  float pm, mn, mt1, mt2, bias, pos_bias;
  V3 ra, rb, jna, jnb, jt1a, jt1b, jt2a, jt2b;
};

// What every lane of a visit shares: the frame, friction and inverse masses.
struct Frame {
  V3 n, t1, t2;
  float mu, ima, imb;
};

// A point of a visit, forward: csrc/solve.cu solve_manifold's operations in
// its order, on the running velocities S, from the point's accumulators
// (an, at1, at2, pp) before the visit.
__device__ __forceinline__ void point_fwd(const Point& P, const Frame& F, float an, float at1,
                                          float at2, float pp, bool split, bool pfric, Vel& S) {
  const V3 n = F.n, t1 = F.t1, t2 = F.t2;
  const float mu = F.mu, pm = P.pm;
  const V3 vrel = sub(sub(add(S.vb, cross(S.wb, P.rb)), S.va), cross(S.wa, P.ra));
  const float vn = dot(vrel, n);
  float dln = (P.bias - vn) * P.mn;
  const float new_n = fmaxf(an + dln, 0.0f);
  dln = pm * (new_n - an);
  const float bound = pfric ? mu * (an + dln + pp) : mu * (an + dln + 0.0f);
  const float vt1 = dot(vrel, t1);
  const float new_t1 = fminf(fmaxf(at1 - vt1 * P.mt1, -bound), bound);
  const float dlt1 = pm * (new_t1 - at1);
  const float vt2 = dot(vrel, t2);
  const float new_t2 = fminf(fmaxf(at2 - vt2 * P.mt2, -bound), bound);
  const float dlt2 = pm * (new_t2 - at2);

  const V3 Pimp = add(add(scale(n, dln), scale(t1, dlt1)), scale(t2, dlt2));
  S.va = sub(S.va, scale(Pimp, F.ima));
  S.vb = add(S.vb, scale(Pimp, F.imb));
  S.wa = sub(S.wa, add(add(scale(P.jna, dln), scale(P.jt1a, dlt1)), scale(P.jt2a, dlt2)));
  S.wb = add(S.wb, add(add(scale(P.jnb, dln), scale(P.jt1b, dlt1)), scale(P.jt2b, dlt2)));

  if (split) {
    const V3 pvrel = sub(sub(add(S.pvb, cross(S.pwb, P.rb)), S.pva), cross(S.pwa, P.ra));
    const float pvn = dot(pvrel, n);
    float dlp = (P.pos_bias - pvn) * P.mn;
    const float new_p = fmaxf(pp + dlp, 0.0f);
    dlp = pm * (new_p - pp);
    const V3 Pp = scale(n, dlp);
    S.pva = sub(S.pva, scale(Pp, F.ima));
    S.pvb = add(S.pvb, scale(Pp, F.imb));
    S.pwa = sub(S.pwa, scale(P.jna, dlp));
    S.pwb = add(S.pwb, scale(P.jnb, dlp));
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

// A point's row adjoints: the vector rows ra, rb, jna, jnb, jt1a, jt1b,
// jt2a, jt2b (v[k] at row kRowRa + 12 k + 3 p) and the scalar rows mn,
// mt1, mt2, bias, pos_bias (s[k] at row kRowMn + 4 k + p).
struct RowAdj {
  V3 v[8];
  float s[5];
};
static_assert(kRowJt2b == kRowRa + 12 * 7 && kRowPosBias == kRowMn + 4 * 4,
              "RowAdj's row layout");

// A point's row-adjoint word w (0-28) of point p: its row in adj_rows.
__device__ __forceinline__ int row_word(int w, int p) {
  return w < 24 ? kRowRa + 12 * (w / 3) + 3 * p + w % 3 : kRowMn + 4 * (w - 24) + p;
}

// The stash: the words a visit's read-modify-writes touch, in shared
// memory, one column a thread (word k at stash[k * kBwdThreads]). cp.async
// copies them in at the visit's start, the visit adds into them, and its
// end writes them back, so no add waits on device memory: the lane's
// points' row adjoints (29 words a point), the shared rows it adds (n, t1,
// t2, mu: group g on lane g % kLanes, at most 6 words), and on lane 0 the
// slot's static-read columns (side a | side b); then the adjoints of the
// lane's points' accumulators (4 a point), and the points' row words (30
// a point), which the visit only reads.
constexpr int kPointWords = 29;
constexpr int kStashShared = kPointWords * kPointsPerLane;
constexpr int kStashStatic = kStashShared + 6;
constexpr int kStashAcc = kStashStatic + 2 * kVelRow;
constexpr int kStashRows = kStashAcc + 4 * kPointsPerLane;
constexpr int kPointRowWords = 30;
constexpr int kStashWords = kStashRows + kPointRowWords * kPointsPerLane;
constexpr size_t kStashBytes = sizeof(float) * kStashWords * kBwdThreads;

__device__ __forceinline__ void stash_in(float* word, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(word);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void stash_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void stash_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row word w (0-29) of point p: pv, then the vector rows ra ... jt2b,
// then mn, mt1, mt2, bias, pos_bias.
__device__ __forceinline__ int point_row(int w, int p) {
  return w == 0 ? kRowPv + p : (w < 25 ? row_word(w - 1, p) : kRowMn + 4 * (w - 25) + p);
}

// A point's rows from its stash words st[w * kBwdThreads].
__device__ __forceinline__ Point stashed_point(const float* st, float relax) {
  auto q = [&](int w) { return st[w * kBwdThreads]; };
  auto q3 = [&](int w) { return v3(q(w), q(w + 1), q(w + 2)); };
  Point P;
  P.pm = relax * q(0);
  P.ra = q3(1);
  P.rb = q3(4);
  P.jna = q3(7);
  P.jnb = q3(10);
  P.jt1a = q3(13);
  P.jt1b = q3(16);
  P.jt2a = q3(19);
  P.jt2b = q3(22);
  P.mn = q(25);
  P.mt1 = q(26);
  P.mt2 = q(27);
  P.bias = q(28);
  P.pos_bias = q(29);
  return P;
}

// The shared rows lane l adds: group g (n, t1, t2, mu) is lane g %
// kLanes's; fn(stash word, row) for each of its words.
template <typename Fn>
__device__ __forceinline__ void shared_words(int l, Fn fn) {
  int k = kStashShared;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (g % kLanes != l) continue;
    const int row = g == 0 ? kRowN : (g == 1 ? kRowT1 : (g == 2 ? kRowT2 : kRowMu));
#pragma unroll
    for (int c = 0; c < (g == 3 ? 1 : 3); ++c) fn(k++, row + c);
  }
}

// The shared row adjoints of a visit: normal, tangents, friction.
struct Shared {
  V3 n, t1, t2;
  float mu;
};

// Point p of a visit, backward: S holds the velocities before the point
// (replayed), G the adjoint of those after it (on return, before it),
// A[0..3] the adjoints of the point's accumulators (λn, λt1, λt2, pseudo
// λ) after it (on return, before it). Returns the point's row adjoints;
// this lane's part of the shared ones goes to `sh`.
__device__ __forceinline__ RowAdj point_bwd(const Point& P, const Frame& F, float an, float at1,
                                            float at2, float pp, bool split, bool pfric,
                                            const Vel& S, Vel& G, float* A, Shared& sh) {
  const V3 n = F.n, t1 = F.t1, t2 = F.t2;
  const float mu = F.mu, ima = F.ima, imb = F.imb, pm = P.pm, mn = P.mn;

  // the forward's values at this point (point_fwd's operations)
  const V3 vrel = sub(sub(add(S.vb, cross(S.wb, P.rb)), S.va), cross(S.wa, P.ra));
  const float vn = dot(vrel, n);
  const float xn = an + (P.bias - vn) * mn;
  const float dln = pm * (fmaxf(xn, 0.0f) - an);
  const float sb = pfric ? an + dln + pp : an + dln + 0.0f;
  const float bound = mu * sb;
  const float vt1 = dot(vrel, t1);
  const float y1 = at1 - vt1 * P.mt1;
  const float dlt1 = pm * (fminf(fmaxf(y1, -bound), bound) - at1);
  const float vt2 = dot(vrel, t2);
  const float y2 = at2 - vt2 * P.mt2;
  const float dlt2 = pm * (fminf(fmaxf(y2, -bound), bound) - at2);

  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 Ara = zero, Arb = zero, Ajna = zero, Ajnb = zero;
  float Amn = 0.0f, Apos_bias = 0.0f;
  // pp' = pp + dlp (split), else pp' = pp
  float App = A[3];
  if (split) {
    const V3 pvrel = sub(sub(add(S.pvb, cross(S.pwb, P.rb)), S.pva), cross(S.pwa, P.ra));
    const float pvn = dot(pvrel, n);
    const float xp = pp + (P.pos_bias - pvn) * mn;
    const float dlp = pm * (fmaxf(xp, 0.0f) - pp);
    float Adlp = A[3];
    // pva' = pva - Pp ima, pvb' = pvb + Pp imb, pwa' = pwa - jna dlp,
    // pwb' = pwb + jnb dlp, Pp = n dlp
    const V3 APp = sub(scale(G.pvb, imb), scale(G.pva, ima));
    Adlp = Adlp + dot(G.pwb, P.jnb) - dot(G.pwa, P.jna);
    Ajna = sub(Ajna, scale(G.pwa, dlp));
    Ajnb = add(Ajnb, scale(G.pwb, dlp));
    sh.n = add(sh.n, scale(APp, dlp));
    Adlp = Adlp + dot(APp, n);
    // dlp = pm (clamp_min(xp, 0) - pp), xp = pp + (pos_bias - pvn) mn
    App = App - pm * Adlp;
    const float Axp = xp >= 0.0f ? pm * Adlp : 0.0f;
    App = App + Axp;
    Apos_bias = Axp * mn;
    Amn = Amn + Axp * (P.pos_bias - pvn);
    const float Apvn = -(Axp * mn);
    const V3 Apvrel = scale(n, Apvn);
    sh.n = add(sh.n, scale(pvrel, Apvn));
    G.pvb = add(G.pvb, Apvrel);
    G.pva = sub(G.pva, Apvrel);
    G.pwb = add(G.pwb, cross(P.rb, Apvrel));
    Arb = add(Arb, cross(Apvrel, S.pwb));
    G.pwa = sub(G.pwa, cross(P.ra, Apvrel));
    Ara = sub(Ara, cross(Apvrel, S.pwa));
  }

  // λ' = λ + Δλ for the three accumulators
  float Aan = A[0], Adln = A[0];
  float Aat1 = A[1], Adlt1 = A[1];
  float Aat2 = A[2], Adlt2 = A[2];
  // wa' = wa - (jna dln + jt1a dlt1 + jt2a dlt2), wb' = wb + (jnb dln + ...)
  Adln = Adln + dot(G.wb, P.jnb) - dot(G.wa, P.jna);
  Adlt1 = Adlt1 + dot(G.wb, P.jt1b) - dot(G.wa, P.jt1a);
  Adlt2 = Adlt2 + dot(G.wb, P.jt2b) - dot(G.wa, P.jt2a);
  Ajnb = add(Ajnb, scale(G.wb, dln));
  Ajna = sub(Ajna, scale(G.wa, dln));
  RowAdj D;
  D.v[5] = scale(G.wb, dlt1);
  D.v[4] = neg(scale(G.wa, dlt1));
  D.v[7] = scale(G.wb, dlt2);
  D.v[6] = neg(scale(G.wa, dlt2));
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
    const float Avt = -(Ay * P.mt2);
    D.s[2] = -(Ay * vt2);
    Avrel = add(Avrel, scale(t2, Avt));
    sh.t2 = add(sh.t2, scale(vrel, Avt));
  }
  {
    Aat1 = Aat1 - pm * Adlt1;
    const float Ay = clamp2_adjoint(pm * Adlt1, y1, bound, &Abound);
    Aat1 = Aat1 + Ay;
    const float Avt = -(Ay * P.mt1);
    D.s[1] = -(Ay * vt1);
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
  D.s[3] = Axn * mn;
  Amn = Amn + Axn * (P.bias - vn);
  const float Avn = -(Axn * mn);
  Avrel = add(Avrel, scale(n, Avn));
  sh.n = add(sh.n, scale(vrel, Avn));
  // vrel = ((vb + wb × rb) - va) - wa × ra
  G.vb = add(G.vb, Avrel);
  G.va = sub(G.va, Avrel);
  G.wb = add(G.wb, cross(P.rb, Avrel));
  Arb = add(Arb, cross(Avrel, S.wb));
  G.wa = sub(G.wa, cross(P.ra, Avrel));
  Ara = sub(Ara, cross(Avrel, S.wa));

  A[0] = Aan;
  A[1] = Aat1;
  A[2] = Aat2;
  A[3] = App;
  D.v[0] = Ara;
  D.v[1] = Arb;
  D.v[2] = Ajna;
  D.v[3] = Ajnb;
  D.s[0] = Amn;
  D.s[4] = Apos_bias;
  return D;
}

// The reverse of slot s's visit in sweep `it`, on lane l of the
// manifold's lanes, which holds points l * kPointsPerLane + j. jacobi (the
// spill color): the visit's output adjoints are the post-pass adjoints in
// scratch, and its dynamic read adjoints go to scratch for the per-body
// sums.
__device__ __forceinline__ void reverse_visit(const SolveBwdArgs& A, int s, int it, bool jacobi,
                                              int l, unsigned mask, float* stash) {
  constexpr int Q = kPointsPerLane;
  const long long fm = A.m;
  const float* R = A.rows + s;
  const int a = __float_as_int(__ldg(R + kRowBodyA * fm));
  const int b = __float_as_int(__ldg(R + kRowBodyB * fm));
  const float relax = __ldg(R + kRowRelax * fm);
  Frame F;
  F.ima = __ldg(R + kRowImA * fm);
  F.imb = __ldg(R + kRowImB * fm);
  F.mu = __ldg(R + kRowMu * fm);
  F.n = v3(__ldg(R + kRowN * fm), __ldg(R + (kRowN + 1) * fm), __ldg(R + (kRowN + 2) * fm));
  F.t1 = v3(__ldg(R + kRowT1 * fm), __ldg(R + (kRowT1 + 1) * fm), __ldg(R + (kRowT1 + 2) * fm));
  F.t2 = v3(__ldg(R + kRowT2 * fm), __ldg(R + (kRowT2 + 1) * fm), __ldg(R + (kRowT2 + 2) * fm));
  const bool dyn_a = F.ima > 0.0f, dyn_b = F.imb > 0.0f;

  // the stash in; and this lane's points' accumulators before the visit
  // (no other point writes them)
  float* AR = A.adj_rows + s;
  float* SA = A.adj_static + s;
  float* AA = A.adj_acc + s;
  const float* T = A.tape + (long long)it * kTapeRows * fm + s;
  const float* Tacc = T + 2 * kVelRow * fm;
  auto word = [&](int k) { return stash + k * kBwdThreads; };
  float acc[Q][4];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int p = l * Q + j;
    for (int w = 0; w < kPointWords; ++w)
      stash_in(word(kPointWords * j + w), AR + row_word(w, p) * fm);
    for (int w = 0; w < kPointRowWords; ++w)
      stash_in(word(kStashRows + kPointRowWords * j + w), R + point_row(w, p) * fm);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      stash_in(word(kStashAcc + 4 * j + f), AA + (4 * f + p) * fm);
      acc[j][f] = Tacc[(4 * f + p) * fm];
    }
  }
  shared_words(l, [&](int k, int row) { stash_in(word(k), AR + row * fm); });
  if (l == 0)
    for (int c = 0; c < 2 * kVelRow; ++c) stash_in(word(kStashStatic + c), SA + c * fm);
  stash_commit();
  auto point = [&](int j) { return stashed_point(word(kStashRows + kPointRowWords * j), relax); };

  // the adjoint of what the visit wrote (the reverse chain starts in the
  // last lane; every lane loads it, the others replace it before they use
  // it); a static side writes nothing
  Vel G;
  {
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
    G = vel_of(ga, gb);
  }

  // the forward replay, up the lanes: lane k runs its points from the
  // velocities before its first (S[0]), keeping those before each (S[j]),
  // and hands lane k + 1 the velocities after its last
  const bool split = A.split, pfric = A.pfric;
  stash_wait();
  Vel S[Q];
  {
    float olda[kVelRow], oldb[kVelRow];
    for (int c = 0; c < kVelRow; ++c) {
      olda[c] = T[c * fm];
      oldb[c] = T[(kVelRow + c) * fm];
    }
    S[0] = vel_of(olda, oldb);
  }
#pragma unroll 1
  for (int k = 0; k < kLanes; ++k) {
    Vel U = S[0];
    if (l == k) {
#pragma unroll
      for (int j = 0; j + 1 < Q; ++j) {
        S[j + 1] = S[j];
        point_fwd(point(j), F, acc[j][0], acc[j][1], acc[j][2], acc[j][3], split, pfric,
                  S[j + 1]);
      }
      if (k + 1 < kLanes) {
        U = S[Q - 1];
        point_fwd(point(Q - 1), F, acc[Q - 1][0], acc[Q - 1][1], acc[Q - 1][2], acc[Q - 1][3],
                  split, pfric, U);
      }
    }
    if (k + 1 < kLanes) {
      U = shfl_up_vel(mask, U);
      if (l == k + 1) S[0] = U;
    }
  }

  // the reverse chain, down the lanes: lane k takes its points' adjoints,
  // last first, and hands lane k - 1 the adjoint of the velocities before
  // its first point
  Shared sh{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), 0.0f};
#pragma unroll 1
  for (int k = kLanes - 1; k >= 0; --k) {
    if (l == k) {
#pragma unroll
      for (int j = Q - 1; j >= 0; --j) {
        float Aacc[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) Aacc[f] = *word(kStashAcc + 4 * j + f);
        const RowAdj D = point_bwd(point(j), F, acc[j][0], acc[j][1], acc[j][2], acc[j][3],
                                   split, pfric, S[j], G, Aacc, sh);
#pragma unroll
        for (int f = 0; f < 4; ++f) *word(kStashAcc + 4 * j + f) = Aacc[f];
#pragma unroll
        for (int v = 0; v < 8; ++v)
#pragma unroll
          for (int c = 0; c < 3; ++c) *word(kPointWords * j + 3 * v + c) += get(D.v[v], c);
#pragma unroll
        for (int v = 0; v < 5; ++v) *word(kPointWords * j + 24 + v) += D.s[v];
      }
    }
    if (k > 0) {
      const Vel H = shfl_down_vel(mask, G);
      if (l == k - 1) G = H;
    }
  }

  // the shared row adjoints, summed over the lanes in a fixed order; then
  // the stash back, the shared rows with their sums added
  sh.n = lanes_sum3(mask, sh.n);
  sh.t1 = lanes_sum3(mask, sh.t1);
  sh.t2 = lanes_sum3(mask, sh.t2);
  sh.mu = lanes_sum(mask, sh.mu);
  shared_words(l, [&](int k, int row) {
    const float x = row == kRowMu ? sh.mu
                                  : get(row < kRowT1 ? sh.n : (row < kRowT2 ? sh.t1 : sh.t2),
                                        (row - kRowN) % 3);
    AR[row * fm] = *word(k) + x;
  });
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int p = l * Q + j;
    for (int w = 0; w < kPointWords; ++w) AR[row_word(w, p) * fm] = *word(kPointWords * j + w);
#pragma unroll
    for (int f = 0; f < 4; ++f) AA[(4 * f + p) * fm] = *word(kStashAcc + 4 * j + f);
  }
  if (l != 0) return;

  // lane 0: the adjoints of the reads
  float ra_[kVelRow], rb_[kVelRow];
  row_of(G.va, G.wa, G.pva, G.pwa, ra_);
  row_of(G.vb, G.wb, G.pvb, G.pwb, rb_);
  const bool dyn[2] = {dyn_a, dyn_b};
  const int body[2] = {a, b};
  for (int side = 0; side < 2; ++side) {
    const float* r = side ? rb_ : ra_;
    if (!dyn[side]) {
      for (int c = 0; c < kVelRow; ++c)
        SA[(side * kVelRow + c) * fm] = *word(kStashStatic + side * kVelRow + c) + r[c];
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

__global__ void __launch_bounds__(kBwdThreads, 1) solve_bwd_kernel(SolveBwdArgs A) {
  extern __shared__ float stash_cols[];  // kStashWords x kBwdThreads
  float* stash = stash_cols + threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) * nb + (int)cluster.block_rank();
  // the forward's thread map (the spill color's per-body sums) ...
  const int g = warp * 32 + lane;
  const int stride = nb * kBwdThreads;
  // ... and the manifolds' lane groups: a warp's groups take neighbouring
  // slots
  const int group = warp * kGroupsPerWarp + lane / kLanes;
  const int groups = nb * (kBwdThreads / kLanes);
  const int l = lane & (kLanes - 1);
  const unsigned mask = ((1u << kLanes) - 1) << (lane & ~(kLanes - 1));
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
        for (int s = lo + group; s < hi; s += groups)
          reverse_visit(A, s, it, true, l, mask, stash);
        cluster.sync();
        spill_side_reads(A, A.keys_a, A.perm_a, 0, lo, hi, g, stride);
        cluster.sync();
        spill_side_reads(A, A.keys_b, A.perm_b, 1, lo, hi, g, stride);
        cluster.sync();
      } else {
        for (int s = lo + group; s < hi; s += groups)
          reverse_visit(A, s, it, false, l, mask, stash);
        cluster.sync();
      }
    }
  }
}

int g_cluster = 0;  // the cluster size, chosen at the first launch

cudaError_t choose_bwd_cluster() {
  return choose_cluster(solve_bwd_kernel, kBwdThreads, kStashBytes, &g_cluster);
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
      cluster_config(g_cluster, kBwdThreads, kStashBytes, (cudaStream_t)stream_, &attr);
  err = cudaLaunchKernelEx(&cfg, solve_bwd_kernel, A);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
