// Shared device helpers for the nudge_tpu_torch kernels: 3-vectors,
// quaternions (x, y, z, w), rotation matrices and the contact basis.
//
// Every expression is written in the operation order of the plain PyTorch
// twins (nudge_tpu_torch/mathx.py and ops/*.py): sums left to right, no
// reassociation. With -fmad=false the kernels then round exactly as the
// twins do, so the on-card comparison is close to bitwise.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float get(V3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }

struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ Q4 load4(const float* p) {
  Q4 q;
  q.x = p[0];
  q.y = p[1];
  q.z = p[2];
  q.w = p[3];
  return q;
}

// v + 2 (w (u×v) + u×(u×v)), u = q.xyz  (mathx.quat_rotate)
__device__ __forceinline__ V3 quat_rotate(Q4 q, V3 v) {
  V3 u = v3(q.x, q.y, q.z);
  V3 uv = cross(u, v);
  V3 uuv = cross(u, uv);
  return v3(v.x + 2.0f * (q.w * uv.x + uuv.x), v.y + 2.0f * (q.w * uv.y + uuv.y),
            v.z + 2.0f * (q.w * uv.z + uuv.z));
}

// rotation by the conjugate: u -> -u, w -> w·1 (mathx.quat_rotate_inv)
__device__ __forceinline__ V3 quat_rotate_inv(Q4 q, V3 v) {
  Q4 c;
  c.x = -q.x;
  c.y = -q.y;
  c.z = -q.z;
  c.w = q.w;
  return quat_rotate(c, v);
}

// R · (I⁻¹_diag ⊙ (Rᵀ v))  (solver._inv_inertia_apply)
__device__ __forceinline__ V3 inv_inertia_apply(Q4 q, V3 ii, V3 v) {
  V3 l = quat_rotate_inv(q, v);
  return quat_rotate(q, v3(ii.x * l.x, ii.y * l.y, ii.z * l.z));
}

struct M3 {
  float m[3][3];
};

// mathx.quat_to_mat: columns are the body axes in world
__device__ __forceinline__ M3 quat_to_mat(Q4 q) {
  float x = q.x, y = q.y, z = q.z, w = q.w;
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  M3 r;
  r.m[0][0] = 1.0f - 2.0f * (yy + zz);
  r.m[0][1] = 2.0f * (xy - wz);
  r.m[0][2] = 2.0f * (xz + wy);
  r.m[1][0] = 2.0f * (xy + wz);
  r.m[1][1] = 1.0f - 2.0f * (xx + zz);
  r.m[1][2] = 2.0f * (yz - wx);
  r.m[2][0] = 2.0f * (xz - wy);
  r.m[2][1] = 2.0f * (yz + wx);
  r.m[2][2] = 1.0f - 2.0f * (xx + yy);
  return r;
}

// M @ v, terms in index order
__device__ __forceinline__ V3 mv(const M3& M, V3 v) {
  return v3(M.m[0][0] * v.x + M.m[0][1] * v.y + M.m[0][2] * v.z,
            M.m[1][0] * v.x + M.m[1][1] * v.y + M.m[1][2] * v.z,
            M.m[2][0] * v.x + M.m[2][1] * v.y + M.m[2][2] * v.z);
}

// Mᵀ @ v
__device__ __forceinline__ V3 mtv(const M3& M, V3 v) {
  return v3(M.m[0][0] * v.x + M.m[1][0] * v.y + M.m[2][0] * v.z,
            M.m[0][1] * v.x + M.m[1][1] * v.y + M.m[2][1] * v.z,
            M.m[0][2] * v.x + M.m[1][2] * v.y + M.m[2][2] * v.z);
}

// Duff et al. branch-free tangent basis (mathx.orthonormal_basis)
__device__ __forceinline__ void orthonormal_basis(V3 n, V3* t1, V3* t2) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float b = n.x * n.y * a;
  *t1 = v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
  *t2 = v3(b, sign + n.y * n.y * a, -n.y);
}

// Body velocity state of the kernel path: one row of 12 floats per body,
// v(3) | w(3) | pseudo v(3) | pseudo w(3).
constexpr int kVelRow = 12;

constexpr int kThreads = 128;

__host__ __forceinline__ int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }
