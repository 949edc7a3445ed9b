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

// The helpers are templates over the scalar type: float in the forward
// kernels, the forward-mode dual number of dual.cuh in the narrowphases'
// backward kernels, which run the forward's own math with a tangent beside
// each value. V3, Q4 and M3 are the float instances.

template <typename T>
struct Vec3 {
  T x, y, z;
};
template <typename T>
struct Quat {
  T x, y, z, w;
};
template <typename T>
struct Mat3 {
  T m[3][3];
};
using V3 = Vec3<float>;
using Q4 = Quat<float>;
using M3 = Mat3<float>;

template <typename T>
__device__ __forceinline__ Vec3<T> v3(T x, T y, T z) {
  Vec3<T> r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
template <typename T>
__device__ __forceinline__ void store3(float* p, Vec3<T> a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
template <typename T>
__device__ __forceinline__ Vec3<T> add(Vec3<T> a, Vec3<T> b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
template <typename T>
__device__ __forceinline__ Vec3<T> sub(Vec3<T> a, Vec3<T> b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
template <typename T, typename S>
__device__ __forceinline__ Vec3<T> scale(Vec3<T> a, S s) {
  return v3<T>(a.x * s, a.y * s, a.z * s);
}
template <typename T>
__device__ __forceinline__ Vec3<T> neg(Vec3<T> a) {
  return v3(-a.x, -a.y, -a.z);
}
template <typename T>
__device__ __forceinline__ T dot(Vec3<T> a, Vec3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ Vec3<T> cross(Vec3<T> a, Vec3<T> b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
template <typename T>
__device__ __forceinline__ T get(Vec3<T> a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : a.z);
}

__device__ __forceinline__ Q4 load4(const float* p) {
  Q4 q;
  q.x = p[0];
  q.y = p[1];
  q.z = p[2];
  q.w = p[3];
  return q;
}

// The twins' clamps and selections, as float operations. Their dual
// versions (dual.cuh) carry the derivative autograd gives the twin's op at
// the same inputs: clamp_min/clamp_max (torch.clamp_min/clamp_max with a
// scalar bound) pass the gradient where x >= c / x <= c; maximum/minimum
// (torch.maximum/minimum) split it in halves at a tie; absv (torch.abs)
// takes sign(x), 0 at 0.
__device__ __forceinline__ float clamp_min(float x, float c) { return fmaxf(x, c); }
__device__ __forceinline__ float clamp_max(float x, float c) { return fminf(x, c); }
__device__ __forceinline__ float maximum(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float minimum(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ float sqrtv(float x) { return sqrtf(x); }
__device__ __forceinline__ bool finite(float x) { return isfinite(x); }
// the value of a scalar (the dual's primal)
__device__ __forceinline__ float val(float x) { return x; }

// v + 2 (w (u×v) + u×(u×v)), u = q.xyz  (mathx.quat_rotate)
template <typename T>
__device__ __forceinline__ Vec3<T> quat_rotate(Quat<T> q, Vec3<T> v) {
  Vec3<T> u = v3(q.x, q.y, q.z);
  Vec3<T> uv = cross(u, v);
  Vec3<T> uuv = cross(u, uv);
  return v3<T>(v.x + 2.0f * (q.w * uv.x + uuv.x), v.y + 2.0f * (q.w * uv.y + uuv.y),
               v.z + 2.0f * (q.w * uv.z + uuv.z));
}

// rotation by the conjugate: u -> -u, w -> w·1 (mathx.quat_rotate_inv)
template <typename T>
__device__ __forceinline__ Vec3<T> quat_rotate_inv(Quat<T> q, Vec3<T> v) {
  Quat<T> c;
  c.x = -q.x;
  c.y = -q.y;
  c.z = -q.z;
  c.w = q.w;
  return quat_rotate(c, v);
}

// R · (I⁻¹_diag ⊙ (Rᵀ v))  (solver._inv_inertia_apply)
template <typename T>
__device__ __forceinline__ Vec3<T> inv_inertia_apply(Quat<T> q, Vec3<T> ii, Vec3<T> v) {
  Vec3<T> l = quat_rotate_inv(q, v);
  return quat_rotate(q, v3(ii.x * l.x, ii.y * l.y, ii.z * l.z));
}

// mathx.quat_to_mat: columns are the body axes in world
template <typename T>
__device__ __forceinline__ Mat3<T> quat_to_mat(Quat<T> q) {
  T x = q.x, y = q.y, z = q.z, w = q.w;
  T xx = x * x, yy = y * y, zz = z * z;
  T xy = x * y, xz = x * z, yz = y * z;
  T wx = w * x, wy = w * y, wz = w * z;
  Mat3<T> r;
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
template <typename T>
__device__ __forceinline__ Vec3<T> mv(const Mat3<T>& M, Vec3<T> v) {
  return v3<T>(M.m[0][0] * v.x + M.m[0][1] * v.y + M.m[0][2] * v.z,
               M.m[1][0] * v.x + M.m[1][1] * v.y + M.m[1][2] * v.z,
               M.m[2][0] * v.x + M.m[2][1] * v.y + M.m[2][2] * v.z);
}

// Mᵀ @ v
template <typename T>
__device__ __forceinline__ Vec3<T> mtv(const Mat3<T>& M, Vec3<T> v) {
  return v3<T>(M.m[0][0] * v.x + M.m[1][0] * v.y + M.m[2][0] * v.z,
               M.m[0][1] * v.x + M.m[1][1] * v.y + M.m[2][1] * v.z,
               M.m[0][2] * v.x + M.m[1][2] * v.y + M.m[2][2] * v.z);
}

// Duff et al. branch-free tangent basis (mathx.orthonormal_basis); the sign
// is a constant of the twin's torch.where, with no gradient
template <typename T>
__device__ __forceinline__ void orthonormal_basis(Vec3<T> n, Vec3<T>* t1, Vec3<T>* t2) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  T a = -1.0f / (sign + n.z);
  T b = n.x * n.y * a;
  *t1 = v3<T>(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
  *t2 = v3<T>(b, sign + n.y * n.y * a, -n.y);
}

// Body velocity state of the kernel path: one row of 12 floats per body,
// v(3) | w(3) | pseudo v(3) | pseudo w(3).
constexpr int kVelRow = 12;

// The solve's constraint rows, field-major in color-sorted slot order: field
// f of the manifold at slot s is rows[f * M + s], so neighbouring threads of
// a color segment read neighbouring words. Vector fields are point-major
// (ra of point p, component k at kRowRa + 3p + k). Body ids are int32 bits.
// The same layout as ops/setup_kernel.py ROW_FIELDS (a CPU test holds the
// two against each other).
constexpr int kRowN = 0;
constexpr int kRowT1 = 3;
constexpr int kRowT2 = 6;
constexpr int kRowRa = 9;
constexpr int kRowRb = 21;
constexpr int kRowJna = 33;
constexpr int kRowJnb = 45;
constexpr int kRowJt1a = 57;
constexpr int kRowJt1b = 69;
constexpr int kRowJt2a = 81;
constexpr int kRowJt2b = 93;
constexpr int kRowMn = 105;
constexpr int kRowMt1 = 109;
constexpr int kRowMt2 = 113;
constexpr int kRowBias = 117;
constexpr int kRowPosBias = 121;
constexpr int kRowPwarm = 125;
constexpr int kRowMu = 129;
constexpr int kRowImA = 130;
constexpr int kRowImB = 131;
constexpr int kRowRelax = 132;
constexpr int kRowPv = 133;
constexpr int kRowBodyA = 137;
constexpr int kRowBodyB = 138;
constexpr int kRows = 139;

// The solve's work rows, field-major in slot order: the accumulators
// (λn, λt1, λt2, pseudo λ; 4 points each), then 24 scratch rows (setup's
// warm-start velocity change of side a | side b, later the spill color's
// post-pass velocities of side a | side b).
constexpr int kWorkAccN = 0;
constexpr int kWorkAccT1 = 4;
constexpr int kWorkAccT2 = 8;
constexpr int kWorkAccP = 12;
constexpr int kWorkScratch = 16;
constexpr int kWorkRows = 40;

// The solve's tape (differentiable mode only): at each visit of a live slot,
// the state the visit starts from, field-major per sweep: tape[(it *
// kTapeRows + f) * M + s], f = side a's velw row (0-11), side b's (12-23),
// the slot's accumulators (24-39). A slot is visited once a sweep.
constexpr int kTapeRows = 2 * kVelRow + 16;

constexpr int kThreads = 128;

__host__ __forceinline__ int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// One thread-block cluster for a whole kernel (the solve, the coloring):
// kMaxCluster CTAs, the largest the hardware places, with the non-portable
// size allowed; kPortableCluster where cudaOccupancyMaxActiveClusters says
// the larger one cannot be placed.
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;

inline cudaLaunchConfig_t cluster_config(int cluster, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size `kernel` launches with at `threads` a CTA and `smem`
// bytes of dynamic shared memory, chosen once into *size (0 = not yet).
template <typename Kernel>
cudaError_t choose_cluster(Kernel kernel, int threads, size_t smem, int* size) {
  if (*size) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(kMaxCluster, threads, smem, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  *size = clusters >= 1 ? kMaxCluster : kPortableCluster;
  return cudaSuccess;
}
