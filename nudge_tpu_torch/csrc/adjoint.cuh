// Reverse-mode helpers of the backward kernels (the narrowphases, setup, the
// solve): each takes the forward's values and an output's adjoint and gives
// the adjoints of the operation's inputs.
//
// The corners are the derivatives PyTorch's autograd takes for the twins'
// operations at the same inputs, so a kernel's gradient is the one autograd
// differentiates through its twin: torch.abs has gradient sign(x), 0 at 0;
// torch.clamp_min / clamp_max pass the gradient where x >= c / x <= c;
// torch.maximum / minimum give half to each side at a tie (against a
// constant, half to x); torch.where passes it to the branch it took.
#pragma once

#include "common.cuh"

// torch.abs's derivative: sign(x), 0 at 0
__device__ __forceinline__ float abs_adjoint(float g, float x) {
  return x > 0.0f ? g : (x < 0.0f ? -g : 0.0f);
}

// torch.clamp_min(x, c)'s adjoint of x from g
__device__ __forceinline__ float clamp_min_adjoint(float g, float x, float c) {
  return x >= c ? g : 0.0f;
}

// torch.maximum(a, b)'s adjoints from g: (of a, of b), halves at a tie;
// torch.minimum's are maximum's with the arguments swapped.
__device__ __forceinline__ float2 max_adjoint(float g, float a, float b) {
  if (a > b) return make_float2(g, 0.0f);
  if (a < b) return make_float2(0.0f, g);
  return make_float2(0.5f * g, 0.5f * g);
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

// The same clamp against a constant bound: the adjoint of y alone
__device__ __forceinline__ float clamp2_adjoint(float g, float y, float bound) {
  float unused = 0.0f;
  return clamp2_adjoint(g, y, bound, &unused);
}

// y = M v: the adjoint of M (g ⊗ v, added into *gM); the adjoint of v is
// mtv(M, g)
__device__ __forceinline__ void mv_adjoint_m(M3* gM, V3 g, V3 v) {
  const float gr[3] = {g.x, g.y, g.z}, vc[3] = {v.x, v.y, v.z};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) gM->m[r][c] = gM->m[r][c] + gr[r] * vc[c];
}

// y = Mᵀ v: the adjoint of M (v ⊗ g, added into *gM); the adjoint of v is
// mv(M, g)
__device__ __forceinline__ void mtv_adjoint_m(M3* gM, V3 g, V3 v) {
  const float gc[3] = {g.x, g.y, g.z}, vr[3] = {v.x, v.y, v.z};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) gM->m[r][c] = gM->m[r][c] + vr[r] * gc[c];
}

// The adjoint of q from g, the adjoint of quat_to_mat(q) (mathx.quat_to_mat:
// 1 - 2 (yy + zz), 2 (xy - wz), ...): first of the nine products, then of
// the components.
__device__ __forceinline__ Q4 quat_to_mat_adjoint(Q4 q, const M3& g) {
  const float g_xx = -2.0f * (g.m[1][1] + g.m[2][2]);
  const float g_yy = -2.0f * (g.m[0][0] + g.m[2][2]);
  const float g_zz = -2.0f * (g.m[0][0] + g.m[1][1]);
  const float g_xy = 2.0f * (g.m[0][1] + g.m[1][0]);
  const float g_xz = 2.0f * (g.m[0][2] + g.m[2][0]);
  const float g_yz = 2.0f * (g.m[1][2] + g.m[2][1]);
  const float g_wx = 2.0f * (g.m[2][1] - g.m[1][2]);
  const float g_wy = 2.0f * (g.m[0][2] - g.m[2][0]);
  const float g_wz = 2.0f * (g.m[1][0] - g.m[0][1]);
  Q4 r;
  r.x = ((2.0f * q.x * g_xx + q.y * g_xy) + q.z * g_xz) + q.w * g_wx;
  r.y = ((2.0f * q.y * g_yy + q.x * g_xy) + q.z * g_yz) + q.w * g_wy;
  r.z = ((2.0f * q.z * g_zz + q.x * g_xz) + q.y * g_yz) + q.w * g_wz;
  r.w = (q.x * g_wx + q.y * g_wy) + q.z * g_wz;
  return r;
}
