// A forward-mode dual number for the backward kernels: a float value and
// one tangent. The backward kernels of the narrowphases run the forward
// kernels' own templated math (common.cuh, narrowphase.cu, ...) on
// Dual inputs, with the tangent of one input component set to 1, and read
// one column of the Jacobian from the outputs' tangents: its dot with the
// output adjoint is that input's adjoint.
//
// The value of every operation is the float operation the forward kernel
// runs (built with -fmad=false, so a tangent never changes how the value
// rounds): a dual run takes every branch the forward took, the SAT axis,
// the clip candidates and the 4-point pick included. The tangent of each
// operation is the derivative PyTorch's autograd takes for the twin's
// operation at the same inputs, down to the corners: clamp_min/clamp_max
// pass the tangent where x >= c / x <= c (torch.clamp_min/clamp_max),
// maximum/minimum take half of each at a tie (torch.maximum/minimum), absv
// takes sign(x), 0 at 0 (torch.abs), and a select takes its branch's
// tangent (torch.where). So the Jacobian is the one autograd differentiates
// through the twin, and kernel and twin gradients agree to rounding.
#pragma once

#include "common.cuh"

struct Dual {
  float v, d;
  Dual() = default;
  __host__ __device__ __forceinline__ Dual(float x) : v(x), d(0.0f) {}
  __host__ __device__ __forceinline__ Dual(float x, float dx) : v(x), d(dx) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return Dual(a.v + b, a.d); }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return Dual(a + b.v, b.d); }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return Dual(a.v - b, a.d); }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return Dual(a - b.v, -b.d); }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.d * b); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ __forceinline__ Dual operator/(Dual a, float b) { return Dual(a.v / b, a.d / b); }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return Dual(q, -(q * b.d) / b.v);
}

#define DUAL_COMPARE(op)                                                                   \
  __device__ __forceinline__ bool operator op(Dual a, Dual b) { return a.v op b.v; }       \
  __device__ __forceinline__ bool operator op(Dual a, float b) { return a.v op b; }        \
  __device__ __forceinline__ bool operator op(float a, Dual b) { return a op b.v; }
DUAL_COMPARE(<)
DUAL_COMPARE(>)
DUAL_COMPARE(<=)
DUAL_COMPARE(>=)
DUAL_COMPARE(==)
#undef DUAL_COMPARE

__device__ __forceinline__ Dual clamp_min(Dual x, float c) {
  return x.v >= c ? Dual(fmaxf(x.v, c), x.d) : Dual(fmaxf(x.v, c), 0.0f);
}
__device__ __forceinline__ Dual clamp_max(Dual x, float c) {
  return x.v <= c ? Dual(fminf(x.v, c), x.d) : Dual(fminf(x.v, c), 0.0f);
}
__device__ __forceinline__ Dual maximum(Dual a, Dual b) {
  const float d = a.v > b.v ? a.d : (a.v < b.v ? b.d : 0.5f * a.d + 0.5f * b.d);
  return Dual(fmaxf(a.v, b.v), d);
}
__device__ __forceinline__ Dual minimum(Dual a, Dual b) {
  const float d = a.v < b.v ? a.d : (a.v > b.v ? b.d : 0.5f * a.d + 0.5f * b.d);
  return Dual(fminf(a.v, b.v), d);
}
__device__ __forceinline__ Dual absv(Dual x) {
  return Dual(fabsf(x.v), x.v > 0.0f ? x.d : (x.v < 0.0f ? -x.d : 0.0f));
}
__device__ __forceinline__ Dual sqrtv(Dual x) {
  const float r = sqrtf(x.v);
  return Dual(r, x.d / (2.0f * r));
}
__device__ __forceinline__ bool finite(Dual x) { return isfinite(x.v); }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float tangent(Dual x) { return x.d; }

// An input component as a scalar of type T: its float value, and for a
// Dual the tangent 1 when it is the seeded input (index == seed), else 0.
template <typename T>
__device__ __forceinline__ T seeded(float x, int index, int seed);
template <>
__device__ __forceinline__ float seeded<float>(float x, int, int) {
  return x;
}
template <>
__device__ __forceinline__ Dual seeded<Dual>(float x, int index, int seed) {
  return Dual(x, index == seed ? 1.0f : 0.0f);
}

// p[0..2] as a Vec3<T> whose components are inputs index .. index + 2
template <typename T>
__device__ __forceinline__ Vec3<T> seeded3(const float* p, int index, int seed) {
  return v3(seeded<T>(p[0], index, seed), seeded<T>(p[1], index + 1, seed),
            seeded<T>(p[2], index + 2, seed));
}

// p[0..3] as a Quat<T> whose components are inputs index .. index + 3
template <typename T>
__device__ __forceinline__ Quat<T> seeded4(const float* p, int index, int seed) {
  Quat<T> q;
  q.x = seeded<T>(p[0], index, seed);
  q.y = seeded<T>(p[1], index + 1, seed);
  q.z = seeded<T>(p[2], index + 2, seed);
  q.w = seeded<T>(p[3], index + 3, seed);
  return q;
}
