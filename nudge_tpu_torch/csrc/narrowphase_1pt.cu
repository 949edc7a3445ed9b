// Box-sphere and sphere-sphere narrowphase, one thread per candidate pair.
//
// Replaces nudge_tpu/ops/narrowphase_kernel.py: pairs_1pt_pallas
// (_make_1pt_kernel, math in _box_sphere_rows and _sphere_sphere_rows). The
// TPU kernel gathered both colliders' rows from a unified box+sphere table
// through one-hot matmuls restricted to membership-bitmask windows, because
// Mosaic has no dynamic gather; here each thread reads its two colliders by
// int32 index from the box arrays (half extents, world quaternion, world
// position, friction, body) and the sphere arrays (radius, world position,
// friction, body), branches on the pair's class, and runs the math of
// nudge_tpu_torch/ops/narrowphase.py: box_sphere / sphere_sphere in
// registers, operation for operation (-fmad=false), so kernel and twin
// agree bitwise.
//
// Pairs come as one stream of global collider ids: box i is i, sphere j is
// nb + j. Side B is always a sphere; side A is a box (box-sphere) or a
// sphere (sphere-sphere). Each pair writes a one-point manifold: slot 0
// holds the contact, slots 1-3 are zero and invalid, feature ids are 0.
//
// What bounds it on an H100: memory latency. A pair reads two collider
// records (at most 44 + 20 bytes) by scattered index and writes 92 bytes;
// the arithmetic is ~100 flops. The design keeps one pair per thread with
// no shared memory, coalesced writes of the output rows, and enough threads
// in flight to hide the gathers.

#include "common.cuh"

namespace {

__global__ void pairs_1pt_kernel(const float* __restrict__ half, const float* __restrict__ box_quat,
                                 const float* __restrict__ box_pos,
                                 const float* __restrict__ box_fric,
                                 const int* __restrict__ box_body,
                                 const float* __restrict__ radius,
                                 const float* __restrict__ sph_pos,
                                 const float* __restrict__ sph_fric,
                                 const int* __restrict__ sph_body, const int* __restrict__ ga_idx,
                                 const int* __restrict__ gb_idx, const bool* __restrict__ live,
                                 int nb, int n_pairs, float* __restrict__ out_normal,
                                 float* __restrict__ out_fric, int* __restrict__ out_ba,
                                 int* __restrict__ out_bb, float* __restrict__ out_pos,
                                 float* __restrict__ out_depth, int* __restrict__ out_feat,
                                 bool* __restrict__ out_valid) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int ga = ga_idx[p];
  const int ib = gb_idx[p] - nb;
  const float rb = radius[ib];
  const V3 pb = load3(sph_pos + 3 * ib);

  V3 nrm, pos;
  float depth, fa;
  int body_a;
  if (ga >= nb) {
    // sphere-sphere (narrowphase.sphere_sphere)
    const int ia = ga - nb;
    const float ra = radius[ia];
    const V3 pa = load3(sph_pos + 3 * ia);
    const V3 d = sub(pb, pa);
    const float d2 = d.x * d.x + d.y * d.y + d.z * d.z;
    const float dist = sqrtf(fmaxf(d2, 1e-12f));
    nrm = d2 > 1e-12f ? v3(d.x / dist, d.y / dist, d.z / dist) : v3(0.0f, 1.0f, 0.0f);
    depth = (ra + rb) - dist;
    const float s = ra - 0.5f * depth;
    pos = v3(pa.x + nrm.x * s, pa.y + nrm.y * s, pa.z + nrm.z * s);
    fa = sph_fric[ia];
    body_a = sph_body[ia];
  } else {
    // box-sphere (narrowphase.box_sphere)
    const int ia = ga;
    const float h[3] = {half[3 * ia], half[3 * ia + 1], half[3 * ia + 2]};
    const V3 pa = load3(box_pos + 3 * ia);
    const M3 Ra = quat_to_mat(load4(box_quat + 4 * ia));
    const V3 cc = mtv(Ra, sub(pb, pa));  // sphere centre in the box frame
    const float c[3] = {cc.x, cc.y, cc.z};
    float cl[3], dl[3], fp[3];
    for (int i = 0; i < 3; ++i) {
      cl[i] = fminf(fmaxf(c[i], -h[i]), h[i]);
      dl[i] = c[i] - cl[i];
      fp[i] = h[i] - fabsf(c[i]);
    }
    const float d2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2];
    const bool outside = d2 > 1e-12f;
    const float dist = sqrtf(fmaxf(d2, 1e-12f));
    // least-penetrated face, first minimum
    int k = 0;
    if (fp[1] < fp[k]) k = 1;
    if (fp[2] < fp[k]) k = 2;
    const float sgn = c[k] >= 0.0f ? 1.0f : -1.0f;
    float nl[3], pl[3];
    for (int i = 0; i < 3; ++i) {
      if (outside) {
        nl[i] = dl[i] / dist;
        pl[i] = cl[i];
      } else {
        nl[i] = i == k ? sgn : 0.0f;
        pl[i] = i == k ? sgn * h[i] : c[i];
      }
    }
    depth = outside ? rb - dist : rb + fp[k];
    pos = add(mv(Ra, v3(pl[0], pl[1], pl[2])), pa);
    nrm = mv(Ra, v3(nl[0], nl[1], nl[2]));
    fa = box_fric[ia];
    body_a = box_body[ia];
  }

  store3(out_normal + 3 * p, nrm);
  out_fric[p] = sqrtf(fmaxf(fa * sph_fric[ib], 0.0f));
  out_ba[p] = body_a;
  out_bb[p] = sph_body[ib];
  store3(out_pos + 12 * p, pos);
  for (int r = 3; r < 12; ++r) out_pos[12 * p + r] = 0.0f;
  out_depth[4 * p] = depth;
  out_valid[4 * p] = depth > 0.0f && live[p];
  for (int k = 1; k < 4; ++k) {
    out_depth[4 * p + k] = 0.0f;
    out_valid[4 * p + k] = false;
  }
  for (int k = 0; k < 4; ++k) out_feat[4 * p + k] = 0;
}

}  // namespace

extern "C" int nudge_pairs_1pt(const float* half, const float* box_quat, const float* box_pos,
                               const float* box_fric, const int* box_body, const float* radius,
                               const float* sph_pos, const float* sph_fric, const int* sph_body,
                               const int* ga, const int* gb, const bool* live, int nb,
                               int n_pairs, float* out_normal, float* out_fric, int* out_ba,
                               int* out_bb, float* out_pos, float* out_depth, int* out_feat,
                               bool* out_valid, void* stream) {
  if (n_pairs > 0) {
    pairs_1pt_kernel<<<blocks_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
        half, box_quat, box_pos, box_fric, box_body, radius, sph_pos, sph_fric, sph_body, ga, gb,
        live, nb, n_pairs, out_normal, out_fric, out_ba, out_bb, out_pos, out_depth, out_feat,
        out_valid);
  }
  return (int)cudaGetLastError();
}
