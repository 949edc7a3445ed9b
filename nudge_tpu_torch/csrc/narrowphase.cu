// Box-box narrowphase, one thread per candidate pair.
//
// Replaces nudge_tpu/ops/narrowphase_kernel.py: box_box_pallas
// (_make_np_kernel, math in _box_box_rows). The TPU kernel gathered collider
// rows through one-hot matmuls over a resident table and carried ids as
// f32; here each thread reads both boxes' half extents, world quaternion,
// world position, friction and body by int32 index and runs the math of
// nudge_tpu_torch/ops/narrowphase.py: box_box in registers: SAT over 15
// axes with the face-edge bias, the closed-form 24-candidate clip, the
// reduction to <= 4 points with frame-stable feature ids, the edge-edge
// case, and friction sqrt(fa*fb).
//
// What bounds it on an H100: registers. The 24 clip candidates (position,
// validity, depth) are held per thread and indexed dynamically by the
// reduction, so they spill to local memory (L1-resident). Memory traffic is
// small (two 44-byte collider records in, 132 bytes out per pair) and the
// arithmetic is a few thousand flops per pair, so at 163,840 pairs the
// kernel is latency-bound on those local-memory accesses. The design keeps
// one pair per thread with no shared memory and no synchronisation so that
// occupancy, not coordination, hides that latency; splitting the clip and
// the reduction across a warp is the obvious next step if it ever matters.

#include "common.cuh"

namespace {

constexpr float kFaceEdgeBias = 0.95f;
constexpr float kAbsEps = 1e-5f;
constexpr float kBigNeg = -1e30f;
__device__ __constant__ int kI1[3] = {1, 2, 0};
__device__ __constant__ int kI2[3] = {2, 0, 1};

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__global__ void box_box_kernel(const float* __restrict__ half, const float* __restrict__ quat,
                               const float* __restrict__ wpos, const float* __restrict__ fric,
                               const int* __restrict__ body, const int* __restrict__ pa_idx,
                               const int* __restrict__ pb_idx,
                               const bool* __restrict__ pair_valid, int n_pairs,
                               float* __restrict__ out_normal, float* __restrict__ out_fric,
                               int* __restrict__ out_ba, int* __restrict__ out_bb,
                               float* __restrict__ out_pos, float* __restrict__ out_depth,
                               int* __restrict__ out_feat, bool* __restrict__ out_valid) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int ia = pa_idx[p];
  const int ib = pb_idx[p];

  float ha[3], hb[3], pa[3], pb[3];
  for (int i = 0; i < 3; ++i) {
    ha[i] = half[3 * ia + i];
    hb[i] = half[3 * ib + i];
    pa[i] = wpos[3 * ia + i];
    pb[i] = wpos[3 * ib + i];
  }
  M3 Ra = quat_to_mat(load4(quat + 4 * ia));
  M3 Rb = quat_to_mat(load4(quat + 4 * ib));

  // R = Raᵀ Rb (B axes in A frame), t = Raᵀ (pb - pa)
  float R[3][3], absR[3][3], t[3], tB[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[i][j] = Ra.m[0][i] * Rb.m[0][j] + Ra.m[1][i] * Rb.m[1][j] + Ra.m[2][i] * Rb.m[2][j];
  {
    float d0 = pb[0] - pa[0], d1 = pb[1] - pa[1], d2 = pb[2] - pa[2];
    for (int i = 0; i < 3; ++i) t[i] = Ra.m[0][i] * d0 + Ra.m[1][i] * d1 + Ra.m[2][i] * d2;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) absR[i][j] = fabsf(R[i][j]) + kAbsEps;
  for (int j = 0; j < 3; ++j) tB[j] = R[0][j] * t[0] + R[1][j] * t[1] + R[2][j] * t[2];

  // --- 6 face axes ---
  float s_face[6];
  for (int i = 0; i < 3; ++i) {
    float ab = absR[i][0] * hb[0] + absR[i][1] * hb[1] + absR[i][2] * hb[2];
    s_face[i] = fabsf(t[i]) - (ha[i] + ab);
  }
  for (int j = 0; j < 3; ++j) {
    float aa = absR[0][j] * ha[0] + absR[1][j] * ha[1] + absR[2][j] * ha[2];
    s_face[3 + j] = fabsf(tB[j]) - (aa + hb[j]);
  }
  int best_face = 0;
  for (int k = 1; k < 6; ++k)
    if (s_face[k] > s_face[best_face]) best_face = k;
  const float s_face_best = s_face[best_face];

  // --- 9 edge axes ---
  float s_edge_best = 0.0f;
  int best_edge = 0;
  for (int i = 0; i < 3; ++i) {
    const int a1 = kI1[i], a2 = kI2[i];
    for (int j = 0; j < 3; ++j) {
      const int j1 = kI1[j], j2 = kI2[j];
      float bt = hb[j1] * absR[i][j2] + hb[j2] * absR[i][j1];
      float num = fabsf(t[a2] * R[a1][j] - t[a1] * R[a2][j]) - ha[a1] * absR[a2][j] -
                  ha[a2] * absR[a1][j] - bt;
      float L2 = R[a1][j] * R[a1][j] + R[a2][j] * R[a2][j];
      float L = sqrtf(fmaxf(L2, 1e-12f));
      float s = L2 > 1e-6f ? num / L : -INFINITY;
      int k = i * 3 + j;
      if (k == 0 || s > s_edge_best) {
        s_edge_best = s;
        best_edge = k;
      }
    }
  }

  const bool separated = fmaxf(s_face_best, s_edge_best) > 0.0f;
  const float pen_face = -s_face_best;
  const float pen_edge = -s_edge_best;
  const bool edge_case = (pen_edge < pen_face * kFaceEdgeBias) && isfinite(pen_edge);

  float out_p[4][3];
  float out_d[4];
  int out_f[4];
  bool out_v[4];
  float nrm[3];

  if (!edge_case) {
    // ---------------- FACE CASE ----------------
    const bool ref_is_b = best_face >= 3;
    const int axis = best_face % 3;
    float R_ri[3][3], t_ri[3], h_ref[3], h_inc[3];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) R_ri[r][c] = ref_is_b ? R[c][r] : R[r][c];
      t_ri[r] = ref_is_b ? -tB[r] : t[r];
      h_ref[r] = ref_is_b ? hb[r] : ha[r];
      h_inc[r] = ref_is_b ? ha[r] : hb[r];
    }
    const float nsign = t_ri[axis] >= 0.0f ? 1.0f : -1.0f;
    const int w = axis, u = (axis + 1) % 3, v = (axis + 2) % 3;

    float nd[3];
    for (int c = 0; c < 3; ++c) nd[c] = R_ri[w][c] * nsign;
    int b_axis = 0;
    for (int c = 1; c < 3; ++c)
      if (fabsf(nd[c]) > fabsf(nd[b_axis])) b_axis = c;
    const float s_inc = -signf(nd[b_axis]);
    const int b1 = (b_axis + 1) % 3, b2 = (b_axis + 2) % 3;

    const float su[4] = {1.0f, 1.0f, -1.0f, -1.0f};
    const float sv[4] = {1.0f, -1.0f, -1.0f, 1.0f};
    float pts0[4][3];
    for (int k = 0; k < 4; ++k) {
      float cmp[3];
      cmp[b_axis] = s_inc * h_inc[b_axis];
      cmp[b1] = su[k] * h_inc[b1];
      cmp[b2] = sv[k] * h_inc[b2];
      for (int r = 0; r < 3; ++r)
        pts0[k][r] =
            (cmp[0] * R_ri[r][0] + cmp[1] * R_ri[r][1] + cmp[2] * R_ri[r][2]) + t_ri[r];
    }

    const float eps = 1e-6f;
    const float one_eps = (float)(1.0 + 1e-6);
    const float h_u = h_ref[u], h_v = h_ref[v], h_w = h_ref[w];
    float qu[4], qv[4], qu_n[4], qv_n[4];
    for (int k = 0; k < 4; ++k) {
      qu[k] = pts0[k][u];
      qv[k] = pts0[k][v];
    }
    for (int k = 0; k < 4; ++k) {
      qu_n[k] = qu[(k + 1) % 4];
      qv_n[k] = qv[(k + 1) % 4];
    }

    float cand[24][3];
    bool cvalid[24];
    // type A: incident verts inside the rect
    for (int k = 0; k < 4; ++k) {
      for (int r = 0; r < 3; ++r) cand[k][r] = pts0[k][r];
      cvalid[k] = (fabsf(qu[k]) <= h_u + eps) && (fabsf(qv[k]) <= h_v + eps);
    }
    // type B: rect corners inside the incident quad
    float cu[4], cv[4];
    for (int k = 0; k < 4; ++k) {
      cu[k] = su[k] * h_u;
      cv[k] = sv[k] * h_v;
    }
    float area2 = 0.0f;
    {
      float ar2[4];
      for (int k = 0; k < 4; ++k) ar2[k] = qu[k] * qv_n[k] - qu_n[k] * qv[k];
      area2 = ((ar2[0] + ar2[1]) + ar2[2]) + ar2[3];
    }
    const float sgn = area2 >= 0.0f ? 1.0f : -1.0f;
    float n_inc[3];
    for (int r = 0; r < 3; ++r) n_inc[r] = R_ri[r][b_axis] * s_inc;
    const float d_pl = n_inc[0] * pts0[0][0] + n_inc[1] * pts0[0][1] + n_inc[2] * pts0[0][2];
    const float n_w = n_inc[w];
    const float n_w_safe = fabsf(n_w) > 1e-3f ? n_w : 1e-3f;
    for (int c = 0; c < 4; ++c) {
      bool ok = true;
      for (int e = 0; e < 4; ++e) {
        float eu = qu_n[e] - qu[e];
        float ev = qv_n[e] - qv[e];
        float crossc = eu * (cv[c] - qv[e]) - ev * (cu[c] - qu[e]);
        ok = ok && (sgn * crossc >= -eps);
      }
      float cw = ((d_pl - n_inc[u] * cu[c]) - n_inc[v] * cv[c]) / n_w_safe;
      cand[4 + c][u] = cu[c];
      cand[4 + c][v] = cv[c];
      cand[4 + c][w] = cw;
      cvalid[4 + c] = ok && (fabsf(n_w) > 1e-3f);
    }
    // type C: 4 incident edges x 4 rect border lines
    const float line_val[4] = {h_u, -h_u, h_v, -h_v};
    for (int e = 0; e < 4; ++e) {
      const int en = (e + 1) % 4;
      for (int l = 0; l < 4; ++l) {
        const bool is_u = l < 2;
        float src = is_u ? qu[e] : qv[e];
        float dst = is_u ? qu_n[e] : qv_n[e];
        float den = dst - src;
        den = fabsf(den) > 1e-9f ? den : 1e-9f;
        float tt = (line_val[l] - src) / den;
        float other = is_u ? qv[e] : qu[e];
        float other_n = is_u ? qv_n[e] : qu_n[e];
        float oth = other + tt * (other_n - other);
        float oth_h = is_u ? h_v : h_u;
        const int k = 8 + e * 4 + l;
        cvalid[k] = (tt >= -eps) && (tt <= one_eps) && (fabsf(oth) <= oth_h + eps);
        for (int r = 0; r < 3; ++r) cand[k][r] = pts0[e][r] + tt * (pts0[en][r] - pts0[e][r]);
      }
    }

    float depth_all[24], cu_all[24], cv_all[24];
    bool valid_all[24];
    for (int k = 0; k < 24; ++k) {
      depth_all[k] = h_w - nsign * cand[k][w];
      valid_all[k] = cvalid[k] && (depth_all[k] > 0.0f);
      cu_all[k] = cand[k][u];
      cv_all[k] = cand[k][v];
    }

    // --- reduce to <= 4: deepest, farthest, max |area|, opposite side ---
    int idx[4];
    bool kv[4];
    bool rem[24];
    {
      int i0 = 0;
      float best = valid_all[0] ? depth_all[0] : kBigNeg;
      bool any = valid_all[0];
      for (int k = 1; k < 24; ++k) {
        float s = valid_all[k] ? depth_all[k] : kBigNeg;
        any = any || valid_all[k];
        if (s > best) {
          best = s;
          i0 = k;
        }
      }
      idx[0] = i0;
      kv[0] = any;
      for (int k = 0; k < 24; ++k) rem[k] = valid_all[k] && (k != i0);

      const float u0 = cu_all[i0], w0 = cv_all[i0];
      int i1 = 0;
      any = false;
      for (int k = 0; k < 24; ++k) {
        float du = cu_all[k] - u0, dv = cv_all[k] - w0;
        float s = rem[k] ? du * du + dv * dv : kBigNeg;
        any = any || rem[k];
        if (k == 0 || s > best) {
          best = s;
          i1 = k;
        }
      }
      idx[1] = i1;
      kv[1] = any;
      rem[i1] = false;

      const float e0 = cu_all[i1] - u0, e1 = cv_all[i1] - w0;
      int i2 = 0;
      any = false;
      for (int k = 0; k < 24; ++k) {
        float du = cu_all[k] - u0, dv = cv_all[k] - w0;
        float area = e0 * dv - e1 * du;
        float s = rem[k] ? fabsf(area) : kBigNeg;
        any = any || rem[k];
        if (k == 0 || s > best) {
          best = s;
          i2 = k;
        }
      }
      idx[2] = i2;
      kv[2] = any;
      float a2;
      {
        float du = cu_all[i2] - u0, dv = cv_all[i2] - w0;
        a2 = e0 * dv - e1 * du;
      }
      rem[i2] = false;

      const float ms = -signf(a2);
      int i3 = 0;
      any = false;
      for (int k = 0; k < 24; ++k) {
        float du = cu_all[k] - u0, dv = cv_all[k] - w0;
        float area = e0 * dv - e1 * du;
        float s = rem[k] ? ms * area : kBigNeg;
        any = any || rem[k];
        if (k == 0 || s > best) {
          best = s;
          i3 = k;
        }
      }
      idx[3] = i3;
      kv[3] = any;
    }

    const M3& Rref = ref_is_b ? Rb : Ra;
    const float* pref = ref_is_b ? pb : pa;
    for (int k = 0; k < 4; ++k) {
      const int ci = idx[k];
      for (int r = 0; r < 3; ++r)
        out_p[k][r] = (cand[ci][0] * Rref.m[r][0] + cand[ci][1] * Rref.m[r][1] +
                       cand[ci][2] * Rref.m[r][2]) +
                      pref[r];
      out_d[k] = depth_all[ci];
      out_v[k] = kv[k] && valid_all[ci];
      out_f[k] = ci + ((ref_is_b ? 1 : 0) << 5) + (axis << 6) + ((nsign > 0.0f ? 1 : 0) << 8);
    }
    for (int r = 0; r < 3; ++r) {
      float nw = Rref.m[r][axis] * nsign;
      nrm[r] = ref_is_b ? -nw : nw;
    }
  } else {
    // ---------------- EDGE CASE ----------------
    const int ei = best_edge / 3, ej = best_edge % 3;
    float e_i[3] = {0.0f, 0.0f, 0.0f}, e_j[3] = {0.0f, 0.0f, 0.0f};
    e_i[ei] = 1.0f;
    e_j[ej] = 1.0f;
    float Rj[3];
    for (int r = 0; r < 3; ++r) Rj[r] = R[r][ej];
    float ax[3];
    ax[0] = e_i[1] * Rj[2] - e_i[2] * Rj[1];
    ax[1] = e_i[2] * Rj[0] - e_i[0] * Rj[2];
    ax[2] = e_i[0] * Rj[1] - e_i[1] * Rj[0];
    const float nn = sqrtf(fmaxf(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2], 1e-24f));
    for (int r = 0; r < 3; ++r) ax[r] = ax[r] / nn;
    const float dat = ax[0] * t[0] + ax[1] * t[1] + ax[2] * t[2];
    const float flip = dat >= 0.0f ? 1.0f : -1.0f;
    for (int r = 0; r < 3; ++r) ax[r] = ax[r] * flip;

    float sa[3], sb[3], c1[3], axb[3], c2l[3], c2[3], r12[3];
    for (int r = 0; r < 3; ++r) {
      sa[r] = signf(ax[r]) + (ax[r] == 0.0f ? 1.0f : 0.0f);
      c1[r] = sa[r] * ha[r] * (1.0f - e_i[r]);
    }
    for (int j = 0; j < 3; ++j) axb[j] = -(R[0][j] * ax[0] + R[1][j] * ax[1] + R[2][j] * ax[2]);
    for (int j = 0; j < 3; ++j) {
      sb[j] = signf(axb[j]) + (axb[j] == 0.0f ? 1.0f : 0.0f);
      c2l[j] = sb[j] * hb[j] * (1.0f - e_j[j]);
    }
    for (int r = 0; r < 3; ++r)
      c2[r] = (R[r][0] * c2l[0] + R[r][1] * c2l[1] + R[r][2] * c2l[2]) + t[r];
    for (int r = 0; r < 3; ++r) r12[r] = c2[r] - c1[r];
    const float b_dd = e_i[0] * Rj[0] + e_i[1] * Rj[1] + e_i[2] * Rj[2];
    const float denom = fmaxf(1.0f - b_dd * b_dd, 1e-9f);
    const float d1r = e_i[0] * r12[0] + e_i[1] * r12[1] + e_i[2] * r12[2];
    const float d2r = Rj[0] * r12[0] + Rj[1] * r12[1] + Rj[2] * r12[2];
    const float s_par = fminf(fmaxf((d1r - b_dd * d2r) / denom, -ha[ei]), ha[ei]);
    const float u_par = fminf(fmaxf((b_dd * d1r - d2r) / denom, -hb[ej]), hb[ej]);
    float mid[3];
    for (int r = 0; r < 3; ++r)
      mid[r] = 0.5f * ((c1[r] + s_par * e_i[r]) + (c2[r] + u_par * Rj[r]));
    V3 pe = mv(Ra, v3(mid[0], mid[1], mid[2]));
    V3 ne = mv(Ra, v3(ax[0], ax[1], ax[2]));
    const int sign_bits = (sa[kI1[ei]] > 0.0f ? 1 : 0) + 2 * (sa[kI2[ei]] > 0.0f ? 1 : 0) +
                          4 * (sb[kI1[ej]] > 0.0f ? 1 : 0) + 8 * (sb[kI2[ej]] > 0.0f ? 1 : 0);
    for (int k = 0; k < 4; ++k) {
      for (int r = 0; r < 3; ++r) out_p[k][r] = 0.0f;
      out_d[k] = 0.0f;
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

  const bool live = pair_valid[p];
  for (int r = 0; r < 3; ++r) out_normal[3 * p + r] = nrm[r];
  for (int k = 0; k < 4; ++k) {
    for (int r = 0; r < 3; ++r) out_pos[12 * p + 3 * k + r] = out_p[k][r];
    out_depth[4 * p + k] = out_d[k];
    out_feat[4 * p + k] = out_f[k];
    out_valid[4 * p + k] = out_v[k] && !separated && live;
  }
  out_fric[p] = sqrtf(fmaxf(fric[ia] * fric[ib], 0.0f));
  out_ba[p] = body[ia];
  out_bb[p] = body[ib];
}

}  // namespace

extern "C" int nudge_box_box(const float* half, const float* quat, const float* wpos,
                             const float* fric, const int* body, const int* pa, const int* pb,
                             const bool* pair_valid, int n_pairs, float* out_normal,
                             float* out_fric, int* out_ba, int* out_bb, float* out_pos,
                             float* out_depth, int* out_feat, bool* out_valid, void* stream) {
  if (n_pairs > 0) {
    box_box_kernel<<<blocks_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
        half, quat, wpos, fric, body, pa, pb, pair_valid, n_pairs, out_normal, out_fric, out_ba,
        out_bb, out_pos, out_depth, out_feat, out_valid);
  }
  return (int)cudaGetLastError();
}
