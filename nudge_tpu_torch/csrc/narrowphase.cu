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
// The per-pair math, collide_pair, is a template over its scalar type: the
// forward kernel runs it on floats, box_box_bwd_kernel (below) on the dual
// numbers of dual.cuh, one pose input's tangent at a time, for the
// differentiable mode's backward. Values that only choose (the SAT's
// scores, the clip's validity tests, the reduction's scores) are taken as
// floats (val()) in both, so the dual run chooses as the forward did.
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

#include "dual.cuh"

namespace {

constexpr float kFaceEdgeBias = 0.95f;
constexpr float kAbsEps = 1e-5f;
constexpr float kBigNeg = -1e30f;
// clip candidates: 0-3 incident vertices in the rectangle (type A), 4-7
// rectangle corners in the incident quad (B), 8-23 incident edge e against
// rectangle border l at 8 + 4e + l (C)
constexpr int kCandidates = 24;

template <typename T>
__device__ __forceinline__ float signf(T x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// a[i] for a run-time i in [0, 3) / [0, 4) / [0, 24), as selects
template <typename T>
__device__ __forceinline__ T sel3(const T (&a)[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}
template <typename T>
__device__ __forceinline__ T sel4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : (i == 2 ? a[2] : a[3]));
}
template <typename T>
__device__ __forceinline__ T pick(const T (&x)[kCandidates], int k) {
  T v = x[0];
#pragma unroll
  for (int s = 1; s < kCandidates; ++s)
    if (s == k) v = x[s];
  return v;
}

// One pair's outputs.
// The pose inputs of a pair, in the order of the backward kernel's tangents
// and of its adjoint rows: box a's world position (0-2) and quaternion
// (3-6), then box b's (7-13).
constexpr int kPoseTangents = 14;

template <typename T>
struct PairOut {
  T pos[4][3];
  T depth[4];
  int feat[4];
  unsigned valid;  // point k's bool in byte k
  T normal[3];
};

// The contact of boxes ia and ib into o. The math is the twin's, over
// scalars of type T (float, or Dual with one pose input seeded: `seed`
// indexes the kPoseTangents inputs, -1 for none).
template <typename T>
__device__ __forceinline__ void collide_pair(int ia, int ib, const float* __restrict__ half,
                                             const float* __restrict__ quat,
                                             const float* __restrict__ wpos, int seed,
                                             PairOut<T>& o) {
  float ha[3], hb[3];
  T pa[3], pb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ha[i] = half[3 * ia + i];
    hb[i] = half[3 * ib + i];
    pa[i] = seeded<T>(wpos[3 * ia + i], i, seed);
    pb[i] = seeded<T>(wpos[3 * ib + i], 7 + i, seed);
  }
  const Mat3<T> Ra = quat_to_mat(seeded4<T>(quat + 4 * ia, 3, seed));
  const Mat3<T> Rb = quat_to_mat(seeded4<T>(quat + 4 * ib, 10, seed));

  // R = Raᵀ Rb (B axes in A frame), t = Raᵀ (pb - pa)
  T R[3][3], absR[3][3], t[3], tB[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = Ra.m[0][i] * Rb.m[0][j] + Ra.m[1][i] * Rb.m[1][j] + Ra.m[2][i] * Rb.m[2][j];
  {
    const T d0 = pb[0] - pa[0], d1 = pb[1] - pa[1], d2 = pb[2] - pa[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = Ra.m[0][i] * d0 + Ra.m[1][i] * d1 + Ra.m[2][i] * d2;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) absR[i][j] = absv(R[i][j]) + kAbsEps;
#pragma unroll
  for (int j = 0; j < 3; ++j) tB[j] = R[0][j] * t[0] + R[1][j] * t[1] + R[2][j] * t[2];

  // --- 6 face axes, first maximum ---
  int best_face = 0;
  T s_face_best = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    T s;
    if (k < 3) {
      const T ab = absR[k][0] * hb[0] + absR[k][1] * hb[1] + absR[k][2] * hb[2];
      s = absv(t[k]) - (ha[k] + ab);
    } else {
      const int j = k - 3;
      const T aa = absR[0][j] * ha[0] + absR[1][j] * ha[1] + absR[2][j] * ha[2];
      s = absv(tB[j]) - (aa + hb[j]);
    }
    if (k == 0 || s > s_face_best) {
      s_face_best = s;
      best_face = k;
    }
  }

  // --- 9 edge axes, first maximum ---
  T s_edge_best = 0.0f;
  int best_edge = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int a1 = (i + 1) % 3, a2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const T bt = hb[j1] * absR[i][j2] + hb[j2] * absR[i][j1];
      const T num = absv(t[a2] * R[a1][j] - t[a1] * R[a2][j]) - ha[a1] * absR[a2][j] -
                    ha[a2] * absR[a1][j] - bt;
      const T L2 = R[a1][j] * R[a1][j] + R[a2][j] * R[a2][j];
      const T L = sqrtv(clamp_min(L2, 1e-12f));
      const T s = L2 > 1e-6f ? num / L : T(-INFINITY);
      const int k = i * 3 + j;
      if (k == 0 || s > s_edge_best) {
        s_edge_best = s;
        best_edge = k;
      }
    }
  }

  const bool separated = fmaxf(val(s_face_best), val(s_edge_best)) > 0.0f;
  const T pen_face = -s_face_best;
  const T pen_edge = -s_edge_best;
  const bool edge_case = (pen_edge < pen_face * kFaceEdgeBias) && finite(pen_edge);

  T(&out_p)[4][3] = o.pos;
  T(&out_d)[4] = o.depth;
  int(&out_f)[4] = o.feat;
  bool out_v[4];
  T(&nrm)[3] = o.normal;

  if (!edge_case) {
    // ---------------- FACE CASE ----------------
    const bool ref_is_b = best_face >= 3;
    const int axis = best_face % 3;
    T R_ri[3][3], t_ri[3];
    float h_ref[3], h_inc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) R_ri[r][c] = ref_is_b ? R[c][r] : R[r][c];
      t_ri[r] = ref_is_b ? -tB[r] : t[r];
      h_ref[r] = ref_is_b ? hb[r] : ha[r];
      h_inc[r] = ref_is_b ? ha[r] : hb[r];
    }
    const float nsign = sel3(t_ri, axis) >= 0.0f ? 1.0f : -1.0f;
    const int w = axis, u = (axis + 1) % 3, v = (axis + 2) % 3;

    // incident face: the incident axis most anti-parallel to the normal
    float nd[3];  // only its order and signs are read: values
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nd[c] = val(w == 0 ? R_ri[0][c] : (w == 1 ? R_ri[1][c] : R_ri[2][c])) * nsign;
    int b_axis = 0;
    float nd_best = nd[0];
#pragma unroll
    for (int c = 1; c < 3; ++c)
      if (fabsf(nd[c]) > fabsf(nd_best)) {
        b_axis = c;
        nd_best = nd[c];
      }
    const float s_inc = -signf(nd_best);
    const int b1 = (b_axis + 1) % 3, b2 = (b_axis + 2) % 3;
    const float hi_b = sel3(h_inc, b_axis), hi_1 = sel3(h_inc, b1), hi_2 = sel3(h_inc, b2);

    // the incident quad in the reference frame, as (u, v, w) coordinates
    const float su[4] = {1.0f, 1.0f, -1.0f, -1.0f};
    const float sv[4] = {1.0f, -1.0f, -1.0f, 1.0f};
    T pts00[3];  // corner 0 in x, y, z (the plane offset below)
    T qu[4], qv[4], qw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cb = s_inc * hi_b, c1 = su[k] * hi_1, c2 = sv[k] * hi_2;
      float cmp[3];
      T pt[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) cmp[c] = b_axis == c ? cb : (b1 == c ? c1 : c2);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        pt[r] = (cmp[0] * R_ri[r][0] + cmp[1] * R_ri[r][1] + cmp[2] * R_ri[r][2]) + t_ri[r];
      if (k == 0) {
#pragma unroll
        for (int r = 0; r < 3; ++r) pts00[r] = pt[r];
      }
      qu[k] = sel3(pt, u);
      qv[k] = sel3(pt, v);
      qw[k] = sel3(pt, w);
    }

    const float eps = 1e-6f;
    const float one_eps = (float)(1.0 + 1e-6);
    const float h_u = sel3(h_ref, u), h_v = sel3(h_ref, v), h_w = sel3(h_ref, w);
    T qu_n[4], qv_n[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qu_n[k] = qu[(k + 1) % 4];
      qv_n[k] = qv[(k + 1) % 4];
    }
    float area2;  // only its sign is read: values
    {
      float ar2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ar2[k] = val(qu[k] * qv_n[k] - qu_n[k] * qv[k]);
      area2 = ((ar2[0] + ar2[1]) + ar2[2]) + ar2[3];
    }
    const float sgn = area2 >= 0.0f ? 1.0f : -1.0f;
    T n_inc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) n_inc[r] = sel3(R_ri[r], b_axis) * s_inc;
    const T d_pl = n_inc[0] * pts00[0] + n_inc[1] * pts00[1] + n_inc[2] * pts00[2];
    const T n_u = sel3(n_inc, u), n_v = sel3(n_inc, v), n_w = sel3(n_inc, w);
    const T n_w_safe = absv(n_w) > 1e-3f ? n_w : T(1e-3f);

    // --- the candidates, (u, v, w) and validity ---
    T cu[kCandidates], cv[kCandidates], cw[kCandidates];
    unsigned vmask = 0;  // bit k: candidate k valid and below the reference face
#pragma unroll
    for (int k = 0; k < kCandidates; ++k) {
      bool ok;
      if (k < 8) {
        const int c = k & 3;
        if (k < 4) {
          // type A: incident verts inside the rect
          cu[k] = qu[c];
          cv[k] = qv[c];
          cw[k] = qw[c];
          ok = (fabsf(val(cu[k])) <= h_u + eps) && (fabsf(val(cv[k])) <= h_v + eps);
        } else {
          // type B: rect corners inside the incident quad
          const float ru = (c < 2 ? 1.0f : -1.0f) * h_u;
          const float rv = (c == 0 || c == 3 ? 1.0f : -1.0f) * h_v;
          ok = true;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float eu = val(qu_n[e] - qu[e]);
            const float ev = val(qv_n[e] - qv[e]);
            const float crossc = eu * (rv - val(qv[e])) - ev * (ru - val(qu[e]));
            ok = ok && (sgn * crossc >= -eps);
          }
          cu[k] = ru;
          cv[k] = rv;
          cw[k] = ((d_pl - n_u * ru) - n_v * rv) / n_w_safe;
          ok = ok && (fabsf(val(n_w)) > 1e-3f);
        }
      } else {
        // type C: incident edge e against rect border line l
        const int c = k - 8, e = c >> 2, l = c & 3, en = (e + 1) & 3;
        const bool is_u = l < 2;
        const T qu_e = qu[e], qv_e = qv[e], qw_e = qw[e];
        const T qu_f = qu[en], qv_f = qv[en], qw_f = qw[en];
        const float line = is_u ? (l == 0 ? h_u : -h_u) : (l == 2 ? h_v : -h_v);
        const T src = is_u ? qu_e : qv_e;
        const T dst = is_u ? qu_f : qv_f;
        T den = dst - src;
        den = absv(den) > 1e-9f ? den : T(1e-9f);
        const T tt = (line - src) / den;
        const T other = is_u ? qv_e : qu_e;
        const T other_n = is_u ? qv_f : qu_f;
        const float oth = val(other + tt * (other_n - other));
        const float oth_h = is_u ? h_v : h_u;
        ok = (tt >= -eps) && (tt <= one_eps) && (fabsf(oth) <= oth_h + eps);
        cu[k] = qu_e + tt * (qu_f - qu_e);
        cv[k] = qv_e + tt * (qv_f - qv_e);
        cw[k] = qw_e + tt * (qw_f - qw_e);
      }
      const float depth = val(h_w - nsign * cw[k]);
      if (ok && depth > 0.0f) vmask |= 1u << k;
    }

    // --- reduce to <= 4: deepest, farthest, max |area|, opposite side ---
    int idx[4];
    unsigned rem = vmask;
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float x = (vmask >> k) & 1u ? val(h_w - nsign * cw[k]) : kBigNeg;
        if (k == 0 || x > best) {
          best = x;
          bi = k;
        }
      }
      idx[0] = bi;
    }
    rem &= ~(1u << idx[0]);
    const float u0 = val(pick(cu, idx[0])), w0 = val(pick(cv, idx[0]));
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float du = val(cu[k]) - u0, dv = val(cv[k]) - w0;
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
    const float e0 = val(pick(cu, idx[1])) - u0, e1 = val(pick(cv, idx[1])) - w0;
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float du = val(cu[k]) - u0, dv = val(cv[k]) - w0;
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
      const float du = val(pick(cu, idx[2])) - u0, dv = val(pick(cv, idx[2])) - w0;
      a2 = e0 * dv - e1 * du;
    }
    rem &= ~(1u << idx[2]);
    const float ms = -signf(a2);
    {
      float best = 0.0f;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float du = val(cu[k]) - u0, dv = val(cv[k]) - w0;
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

    const int fbits = ((ref_is_b ? 1 : 0) << 5) + (axis << 6) + ((nsign > 0.0f ? 1 : 0) << 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = idx[k];
      const T pu = pick(cu, ci), pv = pick(cv, ci), pw = pick(cw, ci);
      T c[3];  // the candidate in the reference box's x, y, z
#pragma unroll
      for (int r = 0; r < 3; ++r) c[r] = w == r ? pw : (u == r ? pu : pv);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        T Rr[3];
#pragma unroll
        for (int c2 = 0; c2 < 3; ++c2) Rr[c2] = ref_is_b ? Rb.m[r][c2] : Ra.m[r][c2];
        out_p[k][r] = (c[0] * Rr[0] + c[1] * Rr[1] + c[2] * Rr[2]) + (ref_is_b ? pb[r] : pa[r]);
      }
      out_d[k] = h_w - nsign * pw;
      out_v[k] = kv[k] && ((vmask >> ci) & 1u);
      out_f[k] = ci + fbits;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T nw = (ref_is_b ? sel3(Rb.m[r], axis) : sel3(Ra.m[r], axis)) * nsign;
      nrm[r] = ref_is_b ? -nw : nw;
    }
  } else {
    // ---------------- EDGE CASE ----------------
    const int ei = best_edge / 3, ej = best_edge % 3;
    float e_i[3], e_j[3];
    T Rj[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e_i[r] = r == ei ? 1.0f : 0.0f;
      e_j[r] = r == ej ? 1.0f : 0.0f;
      Rj[r] = sel3(R[r], ej);
    }
    T ax[3];
    ax[0] = e_i[1] * Rj[2] - e_i[2] * Rj[1];
    ax[1] = e_i[2] * Rj[0] - e_i[0] * Rj[2];
    ax[2] = e_i[0] * Rj[1] - e_i[1] * Rj[0];
    const T nn = sqrtv(clamp_min(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2], 1e-24f));
#pragma unroll
    for (int r = 0; r < 3; ++r) ax[r] = ax[r] / nn;
    const T dat = ax[0] * t[0] + ax[1] * t[1] + ax[2] * t[2];
    const float flip = dat >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) ax[r] = ax[r] * flip;

    float sa[3], sb[3], c1[3], c2l[3];
    T axb[3], c2[3], r12[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      sa[r] = signf(ax[r]) + (ax[r] == 0.0f ? 1.0f : 0.0f);
      c1[r] = sa[r] * ha[r] * (1.0f - e_i[r]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) axb[j] = -(R[0][j] * ax[0] + R[1][j] * ax[1] + R[2][j] * ax[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sb[j] = signf(axb[j]) + (axb[j] == 0.0f ? 1.0f : 0.0f);
      c2l[j] = sb[j] * hb[j] * (1.0f - e_j[j]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
      c2[r] = (R[r][0] * c2l[0] + R[r][1] * c2l[1] + R[r][2] * c2l[2]) + t[r];
#pragma unroll
    for (int r = 0; r < 3; ++r) r12[r] = c2[r] - c1[r];
    const T b_dd = e_i[0] * Rj[0] + e_i[1] * Rj[1] + e_i[2] * Rj[2];
    const T denom = clamp_min(1.0f - b_dd * b_dd, 1e-9f);
    const T d1r = e_i[0] * r12[0] + e_i[1] * r12[1] + e_i[2] * r12[2];
    const T d2r = Rj[0] * r12[0] + Rj[1] * r12[1] + Rj[2] * r12[2];
    const float ha_i = sel3(ha, ei), hb_j = sel3(hb, ej);
    const T s_par = minimum(maximum((d1r - b_dd * d2r) / denom, T(-ha_i)), T(ha_i));
    const T u_par = minimum(maximum((b_dd * d1r - d2r) / denom, T(-hb_j)), T(hb_j));
    T mid[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      mid[r] = 0.5f * ((c1[r] + s_par * e_i[r]) + (c2[r] + u_par * Rj[r]));
    const Vec3<T> pe = mv(Ra, v3(mid[0], mid[1], mid[2]));
    const Vec3<T> ne = mv(Ra, v3(ax[0], ax[1], ax[2]));
    const int sign_bits = (sel3(sa, (ei + 1) % 3) > 0.0f ? 1 : 0) +
                          2 * (sel3(sa, (ei + 2) % 3) > 0.0f ? 1 : 0) +
                          4 * (sel3(sb, (ej + 1) % 3) > 0.0f ? 1 : 0) +
                          8 * (sel3(sb, (ej + 2) % 3) > 0.0f ? 1 : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r) out_p[k][r] = T(0.0f);
      out_d[k] = T(0.0f);
      out_f[k] = 0;
      out_v[k] = false;
    }
    out_p[0][0] = pe.x + pa[0];
    out_p[0][1] = pe.y + pa[1];
    out_p[0][2] = pe.z + pa[2];
    out_d[0] = pen_edge;
    out_f[0] = 1024 + (ei * 3 + ej) * 16 + sign_bits;
    out_v[0] = pen_edge > 0.0f;
    nrm[0] = ne.x;
    nrm[1] = ne.y;
    nrm[2] = ne.z;
  }

  o.valid = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) o.valid |= (out_v[k] && !separated ? 1u : 0u) << (8 * k);
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
  PairOut<float> o;
  collide_pair(ia, ib, half, quat, wpos, -1, o);
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

// The backward: thread (p, j) runs pair p's math once more with pose input
// j seeded (collide_pair<Dual>, kPoseTangents threads a pair), so that the
// outputs' tangents are column j of the pair's Jacobian, and writes
// adj[p][j] = Σ tangent · output adjoint over pos, depth and normal (the
// outputs with a gradient; feature ids, validity, friction and ids have
// none). A dead pair slot writes zeros. One thread a (pair, input) and no
// sum across threads: the per-box sums of these rows are the segment sum
// of csrc/segment.cu, in a fixed order.
//
// What bounds it on an H100: the same dependent chain as the forward, with
// a tangent beside each value (about 3x the operations), 14 times a live
// pair; the 24 candidates as duals do not fit in registers, so the stack
// frame holds them (the forward keeps its 0 B frame). Reads: the forward's
// inputs and 76 B of output adjoint a pair; writes 56 B a pair.
__global__ void __launch_bounds__(kThreads)
    box_box_bwd_kernel(const float* __restrict__ half, const float* __restrict__ quat,
                       const float* __restrict__ wpos, const int* __restrict__ pa_idx,
                       const int* __restrict__ pb_idx, const bool* __restrict__ pair_valid,
                       int n_pairs, const float* __restrict__ g_pos,
                       const float* __restrict__ g_depth, const float* __restrict__ g_normal,
                       float* __restrict__ adj) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_pairs * kPoseTangents) return;
  const int p = (int)(t / kPoseTangents), j = (int)(t % kPoseTangents);
  if (!pair_valid[p]) {
    adj[t] = 0.0f;
    return;
  }
  PairOut<Dual> o;
  collide_pair(pa_idx[p], pb_idx[p], half, quat, wpos, j, o);
  float g = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) g = g + o.pos[k][r].d * g_pos[(4 * p + k) * 3 + r];
    g = g + o.depth[k].d * g_depth[4 * p + k];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) g = g + o.normal[r].d * g_normal[3 * p + r];
  adj[t] = g;
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

// The adjoint rows of the box poses, one per pair slot: adj[p][0..13] =
// d loss / d (pos a, quat a, pos b, quat b) through pair p's pos, depth and
// normal, given their adjoints g_pos[P,4,3], g_depth[P,4], g_normal[P,3].
extern "C" int nudge_box_box_bwd(const float* half, const float* quat, const float* wpos,
                                 const int* pa, const int* pb, const bool* pair_valid,
                                 int n_pairs, const float* g_pos, const float* g_depth,
                                 const float* g_normal, float* adj, void* stream) {
  const long long threads = (long long)n_pairs * kPoseTangents;
  if (threads > 0) {
    box_box_bwd_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(half, quat, wpos, pa, pb, pair_valid, n_pairs,
                                                 g_pos, g_depth, g_normal, adj);
  }
  return (int)cudaGetLastError();
}
