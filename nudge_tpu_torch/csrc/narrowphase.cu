// Box-box narrowphase: one thread per live candidate pair, every value in
// registers.
//
// Replaces nudge_tpu/ops/narrowphase_kernel.py: box_box_pallas
// (_make_np_kernel, math in _box_box_rows). The TPU kernel gathered collider
// rows through one-hot matmuls over a resident table and carried ids as
// f32; here each thread reads both boxes' half extents, world quaternion,
// world position, friction and body by int32 index and runs the math of
// nudge_tpu_torch/ops/narrowphase.py: box_box: SAT over 15 axes with the
// face-edge bias, the closed-form 24-candidate clip, the reduction to <= 4
// points with frame-stable feature ids, the edge-edge case, and friction
// sqrt(fa*fb).
//
// What bounds it on an H100: the dependent chain of a pair (~1,770 float
// operations in the face case, most of them in the clip and its four
// reduction passes), not bytes (two 44-byte collider records in, 116 bytes
// out per pair). An earlier version held the 24 candidates in arrays
// indexed at run time, which ptxas put on an 832-byte local-memory stack,
// and ran the whole chain for every pair slot, dead or not. The design here:
//   - a dead slot (pair_valid false) writes point_valid = false for its
//     four points and nothing else; contacts.compact_manifolds reads no
//     other field of a dead slot (a CPU test holds it to that), so the work
//     follows the live pairs and needs no count on the host; a live slot
//     writes its whole row, the collider ids (ga, gb: the boxes' indices)
//     too, so the kernel owns the rows it is given;
//   - every run-time index (reference axis, incident axis, edge pair, the
//     chosen candidate) is a select, never an address, and every loop over
//     candidates is unrolled at compile-time register slots, so nothing
//     goes to local memory (ptxas: 0 bytes of stack frame);
//   - a pair's outputs go out as 16-byte and 4-byte words.
// Measured and slower at the pile's shapes (PERF.md): a warp's stores
// staged through shared memory and written word by word, and groups of 4
// or 8 lanes a pair with the candidates spread over the group and the
// reductions as shuffle butterflies (every lane repeats the SAT and the
// face frame).
//
// The per-pair math, collide_pair, is built from parts that its reverse
// (pair_adjoint, for box_box_bwd_kernel below) calls again: pair_frame (the
// boxes' frames, R = Raᵀ Rb, t = Raᵀ (pb - pa)), face_frame (the reference
// face and the incident quad), candidate (one clip candidate at a run-time
// or compile-time index) and edge_frame (the edge-edge closest points). The
// same parts on the same inputs give the same bits, so the reverse sees
// every value, and replays every choice, of the forward.
//
// Bitwise equality with the twin: every candidate's own arithmetic is the
// twin's, in its order, built without FMA contraction. The reductions keep
// the twin's first-max rule (torch.argmax): a scan starts at the lowest
// candidate and takes a later one only if strictly greater
// (ops/narrowphase_kernel.py: first_max_model). For values that are
// ordered (finite, +-inf, the -1e30 of invalid candidates) that is the
// first maximum. A NaN input makes NaN values: the scan never takes a NaN
// after the first candidate, and keeps candidate 0 if it is NaN, while
// torch.argmax takes the first NaN, so kernel and twin may then pick
// different candidates.

#include "adjoint.cuh"

namespace {

constexpr float kFaceEdgeBias = 0.95f;
constexpr float kAbsEps = 1e-5f;
constexpr float kBigNeg = -1e30f;
// clip candidates: 0-3 incident vertices in the rectangle (type A), 4-7
// rectangle corners in the incident quad (B), 8-23 incident edge e against
// rectangle border l at 8 + 4e + l (C)
constexpr int kCandidates = 24;

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// a[i] for a run-time i in [0, 3) / [0, 4) / [0, 24), M[r][c], and the
// adds a[i] += x, M[r][c] += x, as selects
__device__ __forceinline__ float sel3(const float (&a)[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}
__device__ __forceinline__ float sel4(const float (&a)[4], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : (i == 2 ? a[2] : a[3]));
}
__device__ __forceinline__ float pick(const float (&x)[kCandidates], int k) {
  float v = x[0];
#pragma unroll
  for (int s = 1; s < kCandidates; ++s)
    if (s == k) v = x[s];
  return v;
}
__device__ __forceinline__ float selm(const float (&M)[3][3], int r, int c) {
  float v = M[0][0];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i == r && j == c) v = M[i][j];
  return v;
}
__device__ __forceinline__ void add3(float (&a)[3], int i, float x) {
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (s == i) a[s] = a[s] + x;
}
__device__ __forceinline__ void add4(float (&a)[4], int i, float x) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s == i) a[s] = a[s] + x;
}
__device__ __forceinline__ void addm(float (&M)[3][3], int r, int c, float x) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i == r && j == c) M[i][j] = M[i][j] + x;
}

// The pose inputs of a pair, in the order of the backward kernel's adjoint
// rows: box a's world position (0-2) and quaternion (3-6), then box b's
// (7-13).
constexpr int kPoseInputs = 14;
// The shape inputs of a pair, in the order of the shape adjoint rows: side
// a's half extents (0-2), friction (3) and radius (4, always 0 for a box),
// then side b's (5-9); ops/narrowphase_kernel.py SHAPE_INPUTS.
constexpr int kShapeInputs = 10;

// One pair's outputs.
struct PairOut {
  float pos[4][3];
  float depth[4];
  int feat[4];
  unsigned valid;  // point k's bool in byte k
  float normal[3];
};

// What the reverse replays of a pair's forward: the case, the winning
// face or edge axis, and the four candidates the reduction chose.
struct PairChoice {
  bool edge_case;
  int best_face, best_edge;
  int idx[4];
};

// Both boxes, and B's axes and centre in A's frame: R = Raᵀ Rb, t = Raᵀ
// (pb - pa), tB = Rᵀ t.
struct PairFrame {
  float ha[3], hb[3], pa[3], pb[3];
  M3 Ra, Rb;
  float R[3][3], t[3], tB[3];
};

__device__ __forceinline__ PairFrame pair_frame(int ia, int ib, const float* __restrict__ half,
                                                const float* __restrict__ quat,
                                                const float* __restrict__ wpos) {
  PairFrame f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.ha[i] = half[3 * ia + i];
    f.hb[i] = half[3 * ib + i];
    f.pa[i] = wpos[3 * ia + i];
    f.pb[i] = wpos[3 * ib + i];
  }
  f.Ra = quat_to_mat(load4(quat + 4 * ia));
  f.Rb = quat_to_mat(load4(quat + 4 * ib));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f.R[i][j] = f.Ra.m[0][i] * f.Rb.m[0][j] + f.Ra.m[1][i] * f.Rb.m[1][j] +
                  f.Ra.m[2][i] * f.Rb.m[2][j];
  {
    const float d0 = f.pb[0] - f.pa[0], d1 = f.pb[1] - f.pa[1], d2 = f.pb[2] - f.pa[2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      f.t[i] = f.Ra.m[0][i] * d0 + f.Ra.m[1][i] * d1 + f.Ra.m[2][i] * d2;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) f.tB[j] = f.R[0][j] * f.t[0] + f.R[1][j] * f.t[1] + f.R[2][j] * f.t[2];
  return f;
}

// The face case's frame: the reference box (the winning face axis's) and
// its axes w (the normal), u, v; the incident axis b_axis of the other box
// and the incident quad in the reference frame (qu, qv, qw: corner k's u,
// v, w coordinates), built from the corners' incident-frame components
// (s_inc hi_b, ±hi_1, ±hi_2); the incident face's plane n_inc · x = d_pl.
struct FaceFrame {
  bool ref_is_b;
  int axis, u, v, w, b_axis, b1;
  float nsign, s_inc, hi_b, hi_1, hi_2, h_u, h_v, h_w, sgn;
  float pts00[3], qu[4], qv[4], qw[4], n_inc[3], d_pl, n_w_safe;
};

// the incident quad's corner signs along b1 and b2
__device__ __forceinline__ float corner_su(int k) { return k < 2 ? 1.0f : -1.0f; }
__device__ __forceinline__ float corner_sv(int k) { return k == 0 || k == 3 ? 1.0f : -1.0f; }

__device__ __forceinline__ FaceFrame face_frame(const PairFrame& f, int best_face) {
  FaceFrame F;
  F.ref_is_b = best_face >= 3;
  F.axis = best_face % 3;
  float R_ri[3][3], t_ri[3], h_ref[3], h_inc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R_ri[r][c] = F.ref_is_b ? f.R[c][r] : f.R[r][c];
    t_ri[r] = F.ref_is_b ? -f.tB[r] : f.t[r];
    h_ref[r] = F.ref_is_b ? f.hb[r] : f.ha[r];
    h_inc[r] = F.ref_is_b ? f.ha[r] : f.hb[r];
  }
  F.nsign = sel3(t_ri, F.axis) >= 0.0f ? 1.0f : -1.0f;
  F.w = F.axis;
  F.u = (F.axis + 1) % 3;
  F.v = (F.axis + 2) % 3;

  // incident face: the incident axis most anti-parallel to the normal
  float nd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    nd[c] = (F.w == 0 ? R_ri[0][c] : (F.w == 1 ? R_ri[1][c] : R_ri[2][c])) * F.nsign;
  int b_axis = 0;
  float nd_best = nd[0];
#pragma unroll
  for (int c = 1; c < 3; ++c)
    if (fabsf(nd[c]) > fabsf(nd_best)) {
      b_axis = c;
      nd_best = nd[c];
    }
  F.b_axis = b_axis;
  F.s_inc = -signf(nd_best);
  F.b1 = (b_axis + 1) % 3;
  const int b2 = (b_axis + 2) % 3;
  F.hi_b = sel3(h_inc, b_axis);
  F.hi_1 = sel3(h_inc, F.b1);
  F.hi_2 = sel3(h_inc, b2);

  // the incident quad in the reference frame, as (u, v, w) coordinates
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cb = F.s_inc * F.hi_b, c1 = corner_su(k) * F.hi_1, c2 = corner_sv(k) * F.hi_2;
    float cmp[3], pt[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cmp[c] = b_axis == c ? cb : (F.b1 == c ? c1 : c2);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      pt[r] = (cmp[0] * R_ri[r][0] + cmp[1] * R_ri[r][1] + cmp[2] * R_ri[r][2]) + t_ri[r];
    if (k == 0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) F.pts00[r] = pt[r];
    }
    F.qu[k] = sel3(pt, F.u);
    F.qv[k] = sel3(pt, F.v);
    F.qw[k] = sel3(pt, F.w);
  }
  F.h_u = sel3(h_ref, F.u);
  F.h_v = sel3(h_ref, F.v);
  F.h_w = sel3(h_ref, F.w);
  float area2;  // only its sign is read
  {
    float ar2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ar2[k] = F.qu[k] * F.qv[(k + 1) % 4] - F.qu[(k + 1) % 4] * F.qv[k];
    area2 = ((ar2[0] + ar2[1]) + ar2[2]) + ar2[3];
  }
  F.sgn = area2 >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) F.n_inc[r] = sel3(R_ri[r], b_axis) * F.s_inc;
  F.d_pl = F.n_inc[0] * F.pts00[0] + F.n_inc[1] * F.pts00[1] + F.n_inc[2] * F.pts00[2];
  const float n_w = sel3(F.n_inc, F.w);
  F.n_w_safe = absv(n_w) > 1e-3f ? n_w : 1e-3f;
  return F;
}

// Clip candidate k in (u, v, w); ok: inside the rectangle (A), inside the
// quad (B), on its edge within the border (C), the depth test being the
// caller's. Type C's tt (the crossing's parameter along the edge), den and
// whether den took the twin's |den| > 1e-9 branch are kept for the reverse.
struct Cand {
  float u, v, w, tt, den;
  bool ok, den_ok;
};

__device__ __forceinline__ Cand candidate(const FaceFrame& F, int k) {
  const float eps = 1e-6f;
  const float one_eps = (float)(1.0 + 1e-6);
  Cand c;
  c.tt = 0.0f;
  c.den = 1.0f;
  c.den_ok = true;
  if (k < 4) {
    // type A: incident verts inside the rect
    c.u = sel4(F.qu, k);
    c.v = sel4(F.qv, k);
    c.w = sel4(F.qw, k);
    c.ok = (fabsf(c.u) <= F.h_u + eps) && (fabsf(c.v) <= F.h_v + eps);
  } else if (k < 8) {
    // type B: rect corners inside the incident quad
    const int q = k & 3;
    const float ru = (q < 2 ? 1.0f : -1.0f) * F.h_u;
    const float rv = (q == 0 || q == 3 ? 1.0f : -1.0f) * F.h_v;
    c.ok = true;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float eu = F.qu[(e + 1) % 4] - F.qu[e];
      const float ev = F.qv[(e + 1) % 4] - F.qv[e];
      const float crossc = eu * (rv - F.qv[e]) - ev * (ru - F.qu[e]);
      c.ok = c.ok && (F.sgn * crossc >= -eps);
    }
    const float n_u = sel3(F.n_inc, F.u), n_v = sel3(F.n_inc, F.v), n_w = sel3(F.n_inc, F.w);
    c.u = ru;
    c.v = rv;
    c.w = ((F.d_pl - n_u * ru) - n_v * rv) / F.n_w_safe;
    c.ok = c.ok && (fabsf(n_w) > 1e-3f);
  } else {
    // type C: incident edge e against rect border line l
    const int q = k - 8, e = q >> 2, l = q & 3, en = (e + 1) & 3;
    const bool is_u = l < 2;
    const float qu_e = sel4(F.qu, e), qv_e = sel4(F.qv, e), qw_e = sel4(F.qw, e);
    const float qu_f = sel4(F.qu, en), qv_f = sel4(F.qv, en), qw_f = sel4(F.qw, en);
    const float line = is_u ? (l == 0 ? F.h_u : -F.h_u) : (l == 2 ? F.h_v : -F.h_v);
    const float src = is_u ? qu_e : qv_e;
    const float dst = is_u ? qu_f : qv_f;
    const float den = dst - src;
    c.den_ok = absv(den) > 1e-9f;
    c.den = c.den_ok ? den : 1e-9f;
    c.tt = (line - src) / c.den;
    const float other = is_u ? qv_e : qu_e;
    const float other_n = is_u ? qv_f : qu_f;
    const float oth = other + c.tt * (other_n - other);
    const float oth_h = is_u ? F.h_v : F.h_u;
    c.ok = (c.tt >= -eps) && (c.tt <= one_eps) && (fabsf(oth) <= oth_h + eps);
    c.u = qu_e + c.tt * (qu_f - qu_e);
    c.v = qv_e + c.tt * (qv_f - qv_e);
    c.w = qw_e + c.tt * (qw_f - qw_e);
  }
  return c;
}

// The edge case's closest points of A's edge along e_i (through c1) and
// B's edge along Rj (through c2), in A's frame: axr = e_i × Rj, ax = axr /
// nn, axf = ax · flip (the contact normal in A's frame); the parameters
// s_par, u_par are xs, xu clamped to the edges' half lengths; mid is the
// contact point.
struct EdgeFrame {
  int ei, ej;
  float e_i[3], Rj[3], axr[3], nn, ax[3], flip, axf[3], sa[3], sb[3];
  float c1[3], c2l[3], c2[3], r12[3];
  float b_dd, denom, d1r, d2r, ha_i, hb_j, xs, xu, s_par, u_par, mid[3];
};

__device__ __forceinline__ EdgeFrame edge_frame(const PairFrame& f, int best_edge) {
  EdgeFrame E;
  E.ei = best_edge / 3;
  E.ej = best_edge % 3;
  float e_j[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    E.e_i[r] = r == E.ei ? 1.0f : 0.0f;
    e_j[r] = r == E.ej ? 1.0f : 0.0f;
    E.Rj[r] = sel3(f.R[r], E.ej);
  }
  E.axr[0] = E.e_i[1] * E.Rj[2] - E.e_i[2] * E.Rj[1];
  E.axr[1] = E.e_i[2] * E.Rj[0] - E.e_i[0] * E.Rj[2];
  E.axr[2] = E.e_i[0] * E.Rj[1] - E.e_i[1] * E.Rj[0];
  E.nn = sqrtv(clamp_min(E.axr[0] * E.axr[0] + E.axr[1] * E.axr[1] + E.axr[2] * E.axr[2], 1e-24f));
#pragma unroll
  for (int r = 0; r < 3; ++r) E.ax[r] = E.axr[r] / E.nn;
  const float dat = E.ax[0] * f.t[0] + E.ax[1] * f.t[1] + E.ax[2] * f.t[2];
  E.flip = dat >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) E.axf[r] = E.ax[r] * E.flip;

  float axb[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    E.sa[r] = signf(E.axf[r]) + (E.axf[r] == 0.0f ? 1.0f : 0.0f);
    E.c1[r] = E.sa[r] * f.ha[r] * (1.0f - E.e_i[r]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    axb[j] = -(f.R[0][j] * E.axf[0] + f.R[1][j] * E.axf[1] + f.R[2][j] * E.axf[2]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    E.sb[j] = signf(axb[j]) + (axb[j] == 0.0f ? 1.0f : 0.0f);
    E.c2l[j] = E.sb[j] * f.hb[j] * (1.0f - e_j[j]);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    E.c2[r] = (f.R[r][0] * E.c2l[0] + f.R[r][1] * E.c2l[1] + f.R[r][2] * E.c2l[2]) + f.t[r];
#pragma unroll
  for (int r = 0; r < 3; ++r) E.r12[r] = E.c2[r] - E.c1[r];
  E.b_dd = E.e_i[0] * E.Rj[0] + E.e_i[1] * E.Rj[1] + E.e_i[2] * E.Rj[2];
  E.denom = clamp_min(1.0f - E.b_dd * E.b_dd, 1e-9f);
  E.d1r = E.e_i[0] * E.r12[0] + E.e_i[1] * E.r12[1] + E.e_i[2] * E.r12[2];
  E.d2r = E.Rj[0] * E.r12[0] + E.Rj[1] * E.r12[1] + E.Rj[2] * E.r12[2];
  E.ha_i = sel3(f.ha, E.ei);
  E.hb_j = sel3(f.hb, E.ej);
  E.xs = (E.d1r - E.b_dd * E.d2r) / E.denom;
  E.xu = (E.b_dd * E.d1r - E.d2r) / E.denom;
  E.s_par = minimum(maximum(E.xs, -E.ha_i), E.ha_i);
  E.u_par = minimum(maximum(E.xu, -E.hb_j), E.hb_j);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    E.mid[r] = 0.5f * ((E.c1[r] + E.s_par * E.e_i[r]) + (E.c2[r] + E.u_par * E.Rj[r]));
  return E;
}

// The contact of boxes ia and ib into o (the twin's math), and into ch
// what the reverse replays (the forward kernel drops it).
__device__ __forceinline__ void collide_pair(int ia, int ib, const float* __restrict__ half,
                                             const float* __restrict__ quat,
                                             const float* __restrict__ wpos, PairOut& o,
                                             PairChoice& ch) {
  const PairFrame f = pair_frame(ia, ib, half, quat, wpos);
  const float(&ha)[3] = f.ha;
  const float(&hb)[3] = f.hb;
  const float(&R)[3][3] = f.R;
  const float(&t)[3] = f.t;
  float absR[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) absR[i][j] = absv(R[i][j]) + kAbsEps;

  // --- 6 face axes, first maximum ---
  int best_face = 0;
  float s_face_best = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float s;
    if (k < 3) {
      const float ab = absR[k][0] * hb[0] + absR[k][1] * hb[1] + absR[k][2] * hb[2];
      s = absv(t[k]) - (ha[k] + ab);
    } else {
      const int j = k - 3;
      const float aa = absR[0][j] * ha[0] + absR[1][j] * ha[1] + absR[2][j] * ha[2];
      s = absv(f.tB[j]) - (aa + hb[j]);
    }
    if (k == 0 || s > s_face_best) {
      s_face_best = s;
      best_face = k;
    }
  }

  // --- 9 edge axes, first maximum ---
  float s_edge_best = 0.0f;
  int best_edge = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int a1 = (i + 1) % 3, a2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const float bt = hb[j1] * absR[i][j2] + hb[j2] * absR[i][j1];
      const float num = absv(t[a2] * R[a1][j] - t[a1] * R[a2][j]) - ha[a1] * absR[a2][j] -
                        ha[a2] * absR[a1][j] - bt;
      const float L2 = R[a1][j] * R[a1][j] + R[a2][j] * R[a2][j];
      const float L = sqrtv(clamp_min(L2, 1e-12f));
      const float s = L2 > 1e-6f ? num / L : -INFINITY;
      const int k = i * 3 + j;
      if (k == 0 || s > s_edge_best) {
        s_edge_best = s;
        best_edge = k;
      }
    }
  }

  const bool separated = fmaxf(s_face_best, s_edge_best) > 0.0f;
  const float pen_face = -s_face_best;
  const float pen_edge = -s_edge_best;
  const bool edge_case = (pen_edge < pen_face * kFaceEdgeBias) && finite(pen_edge);
  ch.edge_case = edge_case;
  ch.best_face = best_face;
  ch.best_edge = best_edge;

  float(&out_p)[4][3] = o.pos;
  float(&out_d)[4] = o.depth;
  int(&out_f)[4] = o.feat;
  bool out_v[4];
  float(&nrm)[3] = o.normal;

  if (!edge_case) {
    // ---------------- FACE CASE ----------------
    const FaceFrame F = face_frame(f, best_face);

    // --- the candidates, (u, v, w) and validity ---
    float cu[kCandidates], cv[kCandidates], cw[kCandidates];
    unsigned vmask = 0;  // bit k: candidate k valid and below the reference face
#pragma unroll
    for (int k = 0; k < kCandidates; ++k) {
      const Cand c = candidate(F, k);
      cu[k] = c.u;
      cv[k] = c.v;
      cw[k] = c.w;
      const float depth = F.h_w - F.nsign * cw[k];
      if (c.ok && depth > 0.0f) vmask |= 1u << k;
    }

    // --- reduce to <= 4: deepest, farthest, max |area|, opposite side ---
    int idx[4];
    unsigned rem = vmask;
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float x = (vmask >> k) & 1u ? F.h_w - F.nsign * cw[k] : kBigNeg;
        if (k == 0 || x > best) {
          best = x;
          bi = k;
        }
      }
      idx[0] = bi;
    }
    rem &= ~(1u << idx[0]);
    const float u0 = pick(cu, idx[0]), w0 = pick(cv, idx[0]);
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float du = cu[k] - u0, dv = cv[k] - w0;
        const float x = (rem >> k) & 1u ? du * du + dv * dv : kBigNeg;
        if (k == 0 || x > best) {
          best = x;
          bi = k;
        }
      }
      idx[1] = bi;
    }
    const unsigned rem1 = rem;
    rem &= ~(1u << idx[1]);
    const float e0 = pick(cu, idx[1]) - u0, e1 = pick(cv, idx[1]) - w0;
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float du = cu[k] - u0, dv = cv[k] - w0;
        const float area = e0 * dv - e1 * du;
        const float x = (rem >> k) & 1u ? fabsf(area) : kBigNeg;
        if (k == 0 || x > best) {
          best = x;
          bi = k;
        }
      }
      idx[2] = bi;
    }
    const unsigned rem2 = rem;
    float a2;
    {
      const float du = pick(cu, idx[2]) - u0, dv = pick(cv, idx[2]) - w0;
      a2 = e0 * dv - e1 * du;
    }
    rem &= ~(1u << idx[2]);
    const float ms = -signf(a2);
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float du = cu[k] - u0, dv = cv[k] - w0;
        const float area = e0 * dv - e1 * du;
        const float x = (rem >> k) & 1u ? ms * area : kBigNeg;
        if (k == 0 || x > best) {
          best = x;
          bi = k;
        }
      }
      idx[3] = bi;
    }
    const bool kv[4] = {vmask != 0u, rem1 != 0u, rem2 != 0u, rem != 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) ch.idx[k] = idx[k];

    const int fbits =
        ((F.ref_is_b ? 1 : 0) << 5) + (F.axis << 6) + ((F.nsign > 0.0f ? 1 : 0) << 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = idx[k];
      const float pu = pick(cu, ci), pv = pick(cv, ci), pw = pick(cw, ci);
      float c[3];  // the candidate in the reference box's x, y, z
#pragma unroll
      for (int r = 0; r < 3; ++r) c[r] = F.w == r ? pw : (F.u == r ? pu : pv);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float Rr[3];
#pragma unroll
        for (int c2 = 0; c2 < 3; ++c2) Rr[c2] = F.ref_is_b ? f.Rb.m[r][c2] : f.Ra.m[r][c2];
        out_p[k][r] = (c[0] * Rr[0] + c[1] * Rr[1] + c[2] * Rr[2]) + (F.ref_is_b ? f.pb[r] : f.pa[r]);
      }
      out_d[k] = F.h_w - F.nsign * pw;
      out_v[k] = kv[k] && ((vmask >> ci) & 1u);
      out_f[k] = ci + fbits;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float nw = (F.ref_is_b ? sel3(f.Rb.m[r], F.axis) : sel3(f.Ra.m[r], F.axis)) * F.nsign;
      nrm[r] = F.ref_is_b ? -nw : nw;
    }
  } else {
    // ---------------- EDGE CASE ----------------
    const EdgeFrame E = edge_frame(f, best_edge);
    const V3 pe = mv(f.Ra, v3(E.mid[0], E.mid[1], E.mid[2]));
    const V3 ne = mv(f.Ra, v3(E.axf[0], E.axf[1], E.axf[2]));
    const int sign_bits = (sel3(E.sa, (E.ei + 1) % 3) > 0.0f ? 1 : 0) +
                          2 * (sel3(E.sa, (E.ei + 2) % 3) > 0.0f ? 1 : 0) +
                          4 * (sel3(E.sb, (E.ej + 1) % 3) > 0.0f ? 1 : 0) +
                          8 * (sel3(E.sb, (E.ej + 2) % 3) > 0.0f ? 1 : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r) out_p[k][r] = 0.0f;
      out_d[k] = 0.0f;
      out_f[k] = 0;
      out_v[k] = false;
    }
    out_p[0][0] = pe.x + f.pa[0];
    out_p[0][1] = pe.y + f.pa[1];
    out_p[0][2] = pe.z + f.pa[2];
    out_d[0] = pen_edge;
    out_f[0] = 1024 + (E.ei * 3 + E.ej) * 16 + sign_bits;
    out_v[0] = pen_edge > 0.0f;
    nrm[0] = ne.x;
    nrm[1] = ne.y;
    nrm[2] = ne.z;
  }

  o.valid = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) o.valid |= (out_v[k] && !separated ? 1u : 0u) << (8 * k);
}

// The adjoints one pair's outputs hand back, accumulated per box: of Ra,
// Rb, pa, pb, and of R = Raᵀ Rb and t = Raᵀ (pb - pa) (which
// pair_adjoint takes back into the four).
struct PairAdj {
  M3 Ra, Rb;
  float pa[3], pb[3], R[3][3], t[3];
  float ha[3], hb[3];  // of the half extents: the shape instance only
};

// The reverse of candidate k (face_frame's F, the forward's c): the
// adjoints (g_u, g_v, g_w) of its coordinates into those of the quad's
// corners (g_qu, g_qv, g_qw), the plane's normal g_n and offset *g_dpl;
// with kShape also into those of the rectangle's half extents h_u, h_v
// (g_huv), which type B's corners and type C's border lines are.
template <bool kShape>
__device__ __forceinline__ void candidate_adjoint(const FaceFrame& F, int k, const Cand& c,
                                                  float g_u, float g_v, float g_w,
                                                  float (&g_qu)[4], float (&g_qv)[4],
                                                  float (&g_qw)[4], float (&g_n)[3],
                                                  float* g_dpl, float (&g_huv)[2]) {
  if (k < 4) {
    // type A: the corner itself
    add4(g_qu, k, g_u);
    add4(g_qv, k, g_v);
    add4(g_qw, k, g_w);
  } else if (k < 8) {
    // type B: u, v constants; w = ((d_pl - n_u ru) - n_v rv) / n_w_safe
    const int q = k & 3;
    const float ru = (q < 2 ? 1.0f : -1.0f) * F.h_u;
    const float rv = (q == 0 || q == 3 ? 1.0f : -1.0f) * F.h_v;
    const float g_num = g_w / F.n_w_safe;
    *g_dpl = *g_dpl + g_num;
    add3(g_n, F.u, -(g_num * ru));
    add3(g_n, F.v, -(g_num * rv));
    if (fabsf(sel3(F.n_inc, F.w)) > 1e-3f) add3(g_n, F.w, -(g_w * (c.w / F.n_w_safe)));
    if constexpr (kShape) {
      // ru = ±h_u and rv = ±h_v are the candidate's u, v and enter its w
      g_huv[0] = g_huv[0] + (g_u - g_num * sel3(F.n_inc, F.u)) * (q < 2 ? 1.0f : -1.0f);
      g_huv[1] = g_huv[1] + (g_v - g_num * sel3(F.n_inc, F.v)) * (q == 0 || q == 3 ? 1.0f : -1.0f);
    }
  } else {
    // type C: q_e + tt (q_f - q_e), tt = (line - src) / den
    const int q = k - 8, e = q >> 2, l = q & 3, en = (e + 1) & 3;
    const bool is_u = l < 2;
    const float g_tt = g_u * (sel4(F.qu, en) - sel4(F.qu, e)) +
                       g_v * (sel4(F.qv, en) - sel4(F.qv, e)) +
                       g_w * (sel4(F.qw, en) - sel4(F.qw, e));
    add4(g_qu, e, g_u - g_u * c.tt);
    add4(g_qu, en, g_u * c.tt);
    add4(g_qv, e, g_v - g_v * c.tt);
    add4(g_qv, en, g_v * c.tt);
    add4(g_qw, e, g_w - g_w * c.tt);
    add4(g_qw, en, g_w * c.tt);
    const float g_den = c.den_ok ? -(g_tt * (c.tt / c.den)) : 0.0f;
    const float g_src = -(g_tt / c.den) - g_den;
    if (is_u) {
      add4(g_qu, e, g_src);
      add4(g_qu, en, g_den);
    } else {
      add4(g_qv, e, g_src);
      add4(g_qv, en, g_den);
    }
    if constexpr (kShape) {
      // the border line: ±h_u (l = 0, 1) or ±h_v (l = 2, 3)
      const float g_line = g_tt / c.den;
      if (is_u)
        g_huv[0] = g_huv[0] + (l == 0 ? g_line : -g_line);
      else
        g_huv[1] = g_huv[1] + (l == 2 ? g_line : -g_line);
    }
  }
}

// The face case's reverse: from the adjoints of the four points' pos (gp)
// and depth (gd) and of the normal (gn) into A; with kShape also into the
// half extents: the reference box's through the depth (h_w) and the
// candidates (h_u, h_v), the incident box's through the quad's corners.
template <bool kShape>
__device__ __forceinline__ void face_adjoint(const PairFrame& f, const PairChoice& ch,
                                             const float (&gp)[4][3], const float (&gd)[4],
                                             const float (&gn)[3], PairAdj& A) {
  const FaceFrame F = face_frame(f, ch.best_face);
  const bool rb = F.ref_is_b;
  float g_Rref[3][3] = {}, g_pref[3] = {};
  float g_qu[4] = {}, g_qv[4] = {}, g_qw[4] = {}, g_n[3] = {}, g_dpl = 0.0f;
  float g_huv[2] = {}, g_hw = 0.0f;  // of h_u, h_v, h_w (kShape)
  // every point, valid or not: pos[k] = Rref c + pref, depth[k] = h_w -
  // nsign c_w, c the chosen candidate in the reference box's x, y, z (a
  // candidate chosen twice takes both adjoints)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ci = ch.idx[k];
    const Cand c = candidate(F, ci);
    float cx[3], g_c[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) cx[r] = F.w == r ? c.w : (F.u == r ? c.u : c.v);
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float r0 = rb ? f.Rb.m[0][cc] : f.Ra.m[0][cc];
      const float r1 = rb ? f.Rb.m[1][cc] : f.Ra.m[1][cc];
      const float r2 = rb ? f.Rb.m[2][cc] : f.Ra.m[2][cc];
      g_c[cc] = (r0 * gp[k][0] + r1 * gp[k][1]) + r2 * gp[k][2];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      g_pref[r] = g_pref[r] + gp[k][r];
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) g_Rref[r][cc] = g_Rref[r][cc] + gp[k][r] * cx[cc];
    }
    candidate_adjoint<kShape>(F, ci, c, sel3(g_c, F.u), sel3(g_c, F.v),
                              sel3(g_c, F.w) - F.nsign * gd[k], g_qu, g_qv, g_qw, g_n, &g_dpl,
                              g_huv);
    if constexpr (kShape) g_hw = g_hw + gd[k];
  }
  // normal = ±Rref[:, axis] nsign
#pragma unroll
  for (int r = 0; r < 3; ++r) addm(g_Rref, r, F.axis, (rb ? -gn[r] : gn[r]) * F.nsign);

  // the quad: corner k = R_ri cmp_k + t_ri, (qu, qv, qw) its (u, v, w);
  // d_pl = n_inc · corner 0, n_inc = R_ri[:, b_axis] s_inc
  float g_Rri[3][3] = {}, g_tri[3] = {};
  float g_hi[3] = {};  // of hi_b, hi_1, hi_2 (kShape)
  const int b2 = (F.b_axis + 2) % 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cb = F.s_inc * F.hi_b, c1 = corner_su(k) * F.hi_1, c2 = corner_sv(k) * F.hi_2;
    float cmp[3], g_pt[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cmp[c] = F.b_axis == c ? cb : (F.b1 == c ? c1 : c2);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      g_pt[r] = F.w == r ? g_qw[k] : (F.u == r ? g_qu[k] : g_qv[k]);
      if (k == 0) g_pt[r] = g_pt[r] + g_dpl * F.n_inc[r];
      g_tri[r] = g_tri[r] + g_pt[r];
#pragma unroll
      for (int c = 0; c < 3; ++c) g_Rri[r][c] = g_Rri[r][c] + g_pt[r] * cmp[c];
    }
    if constexpr (kShape) {
      // corner k = R_ri cmp + t_ri: cmp's adjoint R_riᵀ g_pt, into the
      // incident half extents it scales
      float g_cmp[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        g_cmp[c] = ((rb ? f.R[c][0] : f.R[0][c]) * g_pt[0] +
                    (rb ? f.R[c][1] : f.R[1][c]) * g_pt[1]) +
                   (rb ? f.R[c][2] : f.R[2][c]) * g_pt[2];
      g_hi[0] = g_hi[0] + sel3(g_cmp, F.b_axis) * F.s_inc;
      g_hi[1] = g_hi[1] + sel3(g_cmp, F.b1) * corner_su(k);
      g_hi[2] = g_hi[2] + sel3(g_cmp, b2) * corner_sv(k);
    }
  }
  if constexpr (kShape) {
    // h_ref = rb ? hb : ha, h_inc the other box's
    float g_href[3] = {}, g_hinc[3] = {};
    add3(g_href, F.u, g_huv[0]);
    add3(g_href, F.v, g_huv[1]);
    add3(g_href, F.w, g_hw);
    add3(g_hinc, F.b_axis, g_hi[0]);
    add3(g_hinc, F.b1, g_hi[1]);
    add3(g_hinc, b2, g_hi[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      A.ha[r] = A.ha[r] + (rb ? g_hinc[r] : g_href[r]);
      A.hb[r] = A.hb[r] + (rb ? g_href[r] : g_hinc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    addm(g_Rri, r, F.b_axis, (g_n[r] + g_dpl * F.pts00[r]) * F.s_inc);

  // R_ri = rb ? Rᵀ : R, t_ri = rb ? -tB : t with tB = Rᵀ t
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) A.R[r][c] = A.R[r][c] + (rb ? g_Rri[c][r] : g_Rri[r][c]);
  if (rb) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) A.R[i][j] = A.R[i][j] - g_tri[j] * f.t[i];
      A.t[i] = A.t[i] - ((f.R[i][0] * g_tri[0] + f.R[i][1] * g_tri[1]) + f.R[i][2] * g_tri[2]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) A.t[i] = A.t[i] + g_tri[i];
  }
  // Rref, pref: the reference box's
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A.Ra.m[r][c] = A.Ra.m[r][c] + (rb ? 0.0f : g_Rref[r][c]);
      A.Rb.m[r][c] = A.Rb.m[r][c] + (rb ? g_Rref[r][c] : 0.0f);
    }
    A.pa[r] = A.pa[r] + (rb ? 0.0f : g_pref[r]);
    A.pb[r] = A.pb[r] + (rb ? g_pref[r] : 0.0f);
  }
}

// The edge case's reverse: from the adjoints of point 0's pos (gp0) and
// depth (gd0) and of the normal (gn) into A (points 1-3 are constants);
// with kShape also into the half extents, which place the two edges (c1,
// c2), bound their parameters and enter the edge axis's separation.
template <bool kShape>
__device__ __forceinline__ void edge_adjoint(const PairFrame& f, int best_edge,
                                             const float (&gp0)[3], float gd0,
                                             const float (&gn)[3], PairAdj& A) {
  const EdgeFrame E = edge_frame(f, best_edge);
  // pos[0] = Ra mid + pa, normal = Ra axf
  float g_mid[3], g_ax[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_mid[c] = (f.Ra.m[0][c] * gp0[0] + f.Ra.m[1][c] * gp0[1]) + f.Ra.m[2][c] * gp0[2];
    g_ax[c] = (f.Ra.m[0][c] * gn[0] + f.Ra.m[1][c] * gn[1]) + f.Ra.m[2][c] * gn[2];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    A.pa[r] = A.pa[r] + gp0[r];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      A.Ra.m[r][c] = A.Ra.m[r][c] + (gp0[r] * E.mid[c] + gn[r] * E.axf[c]);
  }
  // mid = 0.5 ((c1 + s_par e_i) + (c2 + u_par Rj)); c1 = sa ha (1 - e_i)
  // depends on ha only
  float g_c2[3], g_c1[3], g_Rj[3], g_s = 0.0f, g_u = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float h = 0.5f * g_mid[r];
    g_c2[r] = h;
    g_c1[r] = h;
    g_s = g_s + h * E.e_i[r];
    g_u = g_u + h * E.Rj[r];
    g_Rj[r] = h * E.u_par;
  }
  // s_par, u_par: xs, xu clamped to ±ha_i, ±hb_j
  float g_hai = 0.0f, g_hbj = 0.0f;
  const float g_xs = clamp2_adjoint(g_s, E.xs, E.ha_i, &g_hai);
  const float g_xu = clamp2_adjoint(g_u, E.xu, E.hb_j, &g_hbj);
  // xs = (d1r - b_dd d2r) / denom, xu = (b_dd d1r - d2r) / denom
  const float g_ns = g_xs / E.denom, g_nu = g_xu / E.denom;
  const float g_denom = -(g_xs * (E.xs / E.denom)) - g_xu * (E.xu / E.denom);
  const float g_d1r = g_ns + g_nu * E.b_dd;
  const float g_d2r = -(g_ns * E.b_dd) - g_nu;
  // and denom = clamp_min(1 - b_dd², 1e-9)
  const float g_bdd = (-(g_ns * E.d2r) + g_nu * E.d1r) -
                      2.0f * E.b_dd *
                          clamp_min_adjoint(g_denom, 1.0f - E.b_dd * E.b_dd, 1e-9f);
  // d1r = e_i · r12, d2r = Rj · r12, b_dd = e_i · Rj, r12 = c2 - c1
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    g_c2[r] = g_c2[r] + (g_d1r * E.e_i[r] + g_d2r * E.Rj[r]);
    g_c1[r] = g_c1[r] - (g_d1r * E.e_i[r] + g_d2r * E.Rj[r]);
    g_Rj[r] = g_Rj[r] + (g_d2r * E.r12[r] + g_bdd * E.e_i[r]);
  }
  // c2 = R c2l + t
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    A.t[r] = A.t[r] + g_c2[r];
#pragma unroll
    for (int j = 0; j < 3; ++j) A.R[r][j] = A.R[r][j] + g_c2[r] * E.c2l[j];
  }
  if constexpr (kShape) {
    // c1 = sa ha (1 - e_i), c2l = sb hb (1 - e_j), and the clamps' bounds
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float g_c2l = (f.R[0][r] * g_c2[0] + f.R[1][r] * g_c2[1]) + f.R[2][r] * g_c2[2];
      A.ha[r] = A.ha[r] + g_c1[r] * E.sa[r] * (1.0f - E.e_i[r]);
      A.hb[r] = A.hb[r] + g_c2l * E.sb[r] * (r == E.ej ? 0.0f : 1.0f);
    }
    add3(A.ha, E.ei, g_hai);
    add3(A.hb, E.ej, g_hbj);
  }
  // axf = ax flip, ax = axr / nn, nn = sqrt(clamp_min(|axr|², 1e-24))
  float g_axr[3], g_nn = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float g = g_ax[r] * E.flip;
    g_axr[r] = g / E.nn;
    g_nn = g_nn - g * (E.ax[r] / E.nn);
  }
  const float s2 = E.axr[0] * E.axr[0] + E.axr[1] * E.axr[1] + E.axr[2] * E.axr[2];
  const float g_s2 = clamp_min_adjoint(g_nn / (2.0f * E.nn), s2, 1e-24f);
#pragma unroll
  for (int r = 0; r < 3; ++r) g_axr[r] = g_axr[r] + 2.0f * E.axr[r] * g_s2;
  // axr = e_i × Rj: Rj's adjoint is g_axr × e_i
  g_Rj[0] = g_Rj[0] + (g_axr[1] * E.e_i[2] - g_axr[2] * E.e_i[1]);
  g_Rj[1] = g_Rj[1] + (g_axr[2] * E.e_i[0] - g_axr[0] * E.e_i[2]);
  g_Rj[2] = g_Rj[2] + (g_axr[0] * E.e_i[1] - g_axr[1] * E.e_i[0]);
  // Rj = R[:, ej]
#pragma unroll
  for (int r = 0; r < 3; ++r) addm(A.R, r, E.ej, g_Rj[r]);

  // depth[0] = pen_edge = -(num / L) of edge axis (i, j): num = |t[a2]
  // R[a1][j] - t[a1] R[a2][j]| - ha[a1] absR[a2][j] - ha[a2] absR[a1][j] -
  // (hb[j1] absR[i][j2] + hb[j2] absR[i][j1]), absR = |R| + eps, L =
  // sqrt(clamp_min(R[a1][j]² + R[a2][j]², 1e-12))
  const int i = E.ei, j = E.ej, a1 = (i + 1) % 3, a2 = (i + 2) % 3;
  const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
  const float r1 = selm(f.R, a1, j), r2 = selm(f.R, a2, j);
  const float rj2 = selm(f.R, i, j2), rj1 = selm(f.R, i, j1);
  const float t1 = sel3(f.t, a1), t2 = sel3(f.t, a2);
  const float ha1 = sel3(f.ha, a1), ha2 = sel3(f.ha, a2);
  const float hb1 = sel3(f.hb, j1), hb2 = sel3(f.hb, j2);
  const float X = t2 * r1 - t1 * r2;
  const float num = absv(X) - ha1 * (absv(r2) + kAbsEps) - ha2 * (absv(r1) + kAbsEps) -
                    (hb1 * (absv(rj2) + kAbsEps) + hb2 * (absv(rj1) + kAbsEps));
  const float L2 = r1 * r1 + r2 * r2;
  const float L = sqrtv(clamp_min(L2, 1e-12f));
  const float s = num / L;
  const float g_sv = -gd0;
  const float g_num = g_sv / L;
  const float g_L2 = clamp_min_adjoint(-(g_sv * (s / L)) / (2.0f * L), L2, 1e-12f);
  const float g_X = abs_adjoint(g_num, X);
  add3(A.t, a2, g_X * r1);
  add3(A.t, a1, -(g_X * r2));
  addm(A.R, a1, j, (g_X * t2 + 2.0f * r1 * g_L2) + abs_adjoint(-(ha2 * g_num), r1));
  addm(A.R, a2, j, (-(g_X * t1) + 2.0f * r2 * g_L2) + abs_adjoint(-(ha1 * g_num), r2));
  addm(A.R, i, j2, abs_adjoint(-(hb1 * g_num), rj2));
  addm(A.R, i, j1, abs_adjoint(-(hb2 * g_num), rj1));
  if constexpr (kShape) {
    add3(A.ha, a1, -(g_num * (absv(r2) + kAbsEps)));
    add3(A.ha, a2, -(g_num * (absv(r1) + kAbsEps)));
    add3(A.hb, j1, -(g_num * (absv(rj2) + kAbsEps)));
    add3(A.hb, j2, -(g_num * (absv(rj1) + kAbsEps)));
  }
}

// The reverse of collide_pair for pair (ia, ib), replaying its forward's
// choices ch: the adjoints of the pose inputs (kPoseInputs order) from
// those of the outputs pos (gp), depth (gd) and normal (gn); with kShape
// also those of both boxes' half extents (g_ha, g_hb).
template <bool kShape>
__device__ __forceinline__ void pair_adjoint(int ia, int ib, const float* __restrict__ half,
                                             const float* __restrict__ quat,
                                             const float* __restrict__ wpos,
                                             const PairChoice& ch, const float (&gp)[4][3],
                                             const float (&gd)[4], const float (&gn)[3],
                                             float (&adj)[kPoseInputs], float (&g_ha)[3],
                                             float (&g_hb)[3]) {
  const PairFrame f = pair_frame(ia, ib, half, quat, wpos);
  PairAdj A = {};
  if (!ch.edge_case)
    face_adjoint<kShape>(f, ch, gp, gd, gn, A);
  else
    edge_adjoint<kShape>(f, ch.best_edge, gp[0], gd[0], gn, A);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    g_ha[r] = A.ha[r];
    g_hb[r] = A.hb[r];
  }
  // R = Raᵀ Rb, t = Raᵀ d, d = pb - pa
  const float d[3] = {f.pb[0] - f.pa[0], f.pb[1] - f.pa[1], f.pb[2] - f.pa[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      A.Ra.m[k][i] = A.Ra.m[k][i] + (((A.R[i][0] * f.Rb.m[k][0] + A.R[i][1] * f.Rb.m[k][1]) +
                                      A.R[i][2] * f.Rb.m[k][2]) +
                                     A.t[i] * d[k]);
      A.Rb.m[k][i] = A.Rb.m[k][i] + ((A.R[0][i] * f.Ra.m[k][0] + A.R[1][i] * f.Ra.m[k][1]) +
                                     A.R[2][i] * f.Ra.m[k][2]);
    }
    const float g_d = (A.t[0] * f.Ra.m[k][0] + A.t[1] * f.Ra.m[k][1]) + A.t[2] * f.Ra.m[k][2];
    adj[k] = A.pa[k] - g_d;
    adj[7 + k] = A.pb[k] + g_d;
  }
  const Q4 qa = quat_to_mat_adjoint(load4(quat + 4 * ia), A.Ra);
  const Q4 qb = quat_to_mat_adjoint(load4(quat + 4 * ib), A.Rb);
  adj[3] = qa.x;
  adj[4] = qa.y;
  adj[5] = qa.z;
  adj[6] = qa.w;
  adj[10] = qb.x;
  adj[11] = qb.y;
  adj[12] = qb.z;
  adj[13] = qb.w;
}

struct Outputs {
  float* normal;
  float* fric;
  int* ba;
  int* bb;
  float* pos;
  float* depth;
  int* feat;
  bool* valid;
  int* ga;
  int* gb;
};

__global__ void __launch_bounds__(kThreads)
    box_box_kernel(const float* __restrict__ half, const float* __restrict__ quat,
                   const float* __restrict__ wpos, const float* __restrict__ fric,
                   const int* __restrict__ body, const int* __restrict__ pa_idx,
                   const int* __restrict__ pb_idx, const bool* __restrict__ pair_valid,
                   int n_pairs, Outputs out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  if (!pair_valid[p]) {
    reinterpret_cast<unsigned*>(out.valid)[p] = 0u;
    return;
  }
  const int ia = pa_idx[p], ib = pb_idx[p];
  PairOut o;
  PairChoice ch;
  collide_pair(ia, ib, half, quat, wpos, o, ch);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int e = 4 * j;
    reinterpret_cast<float4*>(out.pos)[3 * p + j] =
        make_float4(o.pos[e / 3][e % 3], o.pos[(e + 1) / 3][(e + 1) % 3],
                    o.pos[(e + 2) / 3][(e + 2) % 3], o.pos[(e + 3) / 3][(e + 3) % 3]);
  }
  reinterpret_cast<float4*>(out.depth)[p] =
      make_float4(o.depth[0], o.depth[1], o.depth[2], o.depth[3]);
  reinterpret_cast<int4*>(out.feat)[p] = make_int4(o.feat[0], o.feat[1], o.feat[2], o.feat[3]);
  reinterpret_cast<unsigned*>(out.valid)[p] = o.valid;
#pragma unroll
  for (int r = 0; r < 3; ++r) out.normal[3 * p + r] = o.normal[r];
  out.fric[p] = sqrtf(fmaxf(fric[ia] * fric[ib], 0.0f));
  out.ba[p] = body[ia];
  out.bb[p] = body[ib];
  out.ga[p] = ia;
  out.gb[p] = ib;
}

// The backward: one thread a pair slot. A live pair runs collide_pair once
// (the forward's bits and choices) and its reverse, pair_adjoint, and
// writes adj[p][0..13] = d loss / d (pos a, quat a, pos b, quat b) through
// pos, depth and normal (feature ids, validity and ids have no gradient)
// as seven 8-byte words (row p starts at byte 56 p). A dead slot writes
// nothing: contacts.collider_entries gives its rows the key that the
// segment sum (csrc/segment.cu, the per-box sums in a fixed order) skips.
// A null output adjoint is zero.
//
// The shape instance (kShape, launched only when the caller passes
// adj_shape: a collider's half extents or friction carry a gradient) also
// writes adj_shape[p][0..9] = d loss / d (half a, friction a, radius a,
// half b, friction b, radius b) as five 8-byte words (radius: 0 for a
// box), through pos, depth and normal and through the pair's friction
// sqrt(max(fa fb, 0)), whose adjoint g_fric may be null (zero). Its
// reverse is autograd's for the twin's sqrt(clamp_min(fa * fb, 0)):
// sqrt's g / (2 r), passed where fa fb >= 0, then times fb and fa. At fa
// fb == 0, r is 0, so it gives ±inf (g != 0) or NaN (g == 0), and the
// product with a zero factor NaN, as autograd does. The pose-only
// instance does none of this work: its code is the pose reverse alone.
//
// What bounds it on an H100: the chain of one live pair, the forward's
// (~1,770 float operations in the face case) and then its reverse, which
// walks back only through what reaches pos, depth and normal: the four
// chosen candidates (of the 24), the quad, the frames and the quaternions;
// most of the clip is selection and carries no gradient. Reads: the
// forward's inputs and 76 B of output adjoint a live pair (80 B and the
// frictions with kShape); writes 56 B a live pair (96 B with kShape).
template <bool kShape>
__global__ void __launch_bounds__(kThreads)
    box_box_bwd_kernel(const float* __restrict__ half, const float* __restrict__ quat,
                       const float* __restrict__ wpos, const float* __restrict__ fric,
                       const int* __restrict__ pa_idx, const int* __restrict__ pb_idx,
                       const bool* __restrict__ pair_valid, int n_pairs,
                       const float* __restrict__ g_pos, const float* __restrict__ g_depth,
                       const float* __restrict__ g_normal, const float* __restrict__ g_fric,
                       float* __restrict__ adj, float* __restrict__ adj_shape) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs || !pair_valid[p]) return;
  const int ia = pa_idx[p], ib = pb_idx[p];
  PairOut o;
  PairChoice ch;
  collide_pair(ia, ib, half, quat, wpos, o, ch);
  float gp[4][3], gd[4], gn[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) gp[k][r] = g_pos ? g_pos[12LL * p + 3 * k + r] : 0.0f;
    gd[k] = g_depth ? g_depth[4LL * p + k] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) gn[r] = g_normal ? g_normal[3LL * p + r] : 0.0f;
  float a[kPoseInputs], g_ha[3], g_hb[3];
  pair_adjoint<kShape>(ia, ib, half, quat, wpos, ch, gp, gd, gn, a, g_ha, g_hb);
  float2* row = reinterpret_cast<float2*>(adj + (long long)kPoseInputs * p);
#pragma unroll
  for (int w = 0; w < kPoseInputs / 2; ++w) row[w] = make_float2(a[2 * w], a[2 * w + 1]);
  if constexpr (kShape) {
    float g_fa = 0.0f, g_fb = 0.0f;
    if (g_fric) {
      const float fa = fric[ia], fb = fric[ib];
      const float x = fa * fb;
      const float gx = x >= 0.0f ? g_fric[p] / (2.0f * sqrtf(fmaxf(x, 0.0f))) : 0.0f;
      g_fa = gx * fb;
      g_fb = gx * fa;
    }
    float2* srow = reinterpret_cast<float2*>(adj_shape + (long long)kShapeInputs * p);
    srow[0] = make_float2(g_ha[0], g_ha[1]);
    srow[1] = make_float2(g_ha[2], g_fa);
    srow[2] = make_float2(0.0f, g_hb[0]);
    srow[3] = make_float2(g_hb[1], g_hb[2]);
    srow[4] = make_float2(g_fb, 0.0f);
  }
}

}  // namespace

extern "C" int nudge_box_box(const float* half, const float* quat, const float* wpos,
                             const float* fric, const int* body, const int* pa, const int* pb,
                             const bool* pair_valid, int n_pairs, float* out_normal,
                             float* out_fric, int* out_ba, int* out_bb, float* out_pos,
                             float* out_depth, int* out_feat, bool* out_valid, int* out_ga,
                             int* out_gb, void* stream) {
  if (n_pairs > 0) {
    const Outputs out{out_normal, out_fric, out_ba,    out_bb, out_pos,
                      out_depth,  out_feat, out_valid, out_ga, out_gb};
    box_box_kernel<<<blocks_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
        half, quat, wpos, fric, body, pa, pb, pair_valid, n_pairs, out);
  }
  return (int)cudaGetLastError();
}

// The adjoint rows of the box poses, one per live pair slot: adj[p][0..13]
// = d loss / d (pos a, quat a, pos b, quat b) through pair p's pos, depth
// and normal, given their adjoints g_pos[P,4,3], g_depth[P,4],
// g_normal[P,3] (each may be null: zero). With adj_shape (else null) also
// adj_shape[p][0..9] = d loss / d (half a, friction a, 0, half b, friction
// b, 0), the frictions through the pair friction's adjoint g_fric[P] (may
// be null: zero) and fric[nb]. A dead slot's rows are not written. adj and
// adj_shape must be 8-byte aligned.
extern "C" int nudge_box_box_bwd(const float* half, const float* quat, const float* wpos,
                                 const float* fric, const int* pa, const int* pb,
                                 const bool* pair_valid, int n_pairs, const float* g_pos,
                                 const float* g_depth, const float* g_normal,
                                 const float* g_fric, float* adj, float* adj_shape,
                                 void* stream) {
  if (n_pairs > 0) {
    if (adj_shape)
      box_box_bwd_kernel<true><<<blocks_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
          half, quat, wpos, fric, pa, pb, pair_valid, n_pairs, g_pos, g_depth, g_normal, g_fric,
          adj, adj_shape);
    else
      box_box_bwd_kernel<false><<<blocks_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
          half, quat, wpos, fric, pa, pb, pair_valid, n_pairs, g_pos, g_depth, g_normal, g_fric,
          adj, adj_shape);
  }
  return (int)cudaGetLastError();
}
