// Box-sphere and sphere-sphere narrowphase: one launch over both pair
// classes, one thread per pair slot, work for the live pairs only.
//
// Replaces nudge_tpu/ops/narrowphase_kernel.py: pairs_1pt_pallas
// (_make_1pt_kernel, math in _box_sphere_rows and _sphere_sphere_rows). The
// TPU kernel gathered both colliders' rows from a unified box+sphere table
// through one-hot matmuls restricted to membership-bitmask windows, because
// Mosaic has no dynamic gather; here each thread reads its two colliders by
// int32 index from the box arrays (half extents, world quaternion, world
// position, friction, body) and the sphere arrays (radius, world position,
// friction, body), and runs the math of nudge_tpu_torch/ops/narrowphase.py:
// box_sphere / sphere_sphere in registers, operation for operation
// (-fmad=false), so kernel and twin agree bitwise.
//
// The grid covers two ranges of output rows, in order: the n_bs box-sphere
// pairs, read in place from their candidate list (box a keeps its index,
// sphere b is nb + b), then the n_ss sphere-sphere pairs (spheres a and b
// are nb + a, nb + b). Side B is always a sphere. A live pair writes its
// collider ids (ga, gb) and a one-point manifold: slot 0 holds the contact,
// slots 1-3 are zero and invalid, feature ids are 0. A dead pair slot (its
// candidate's valid flag false; the broadphases keep the live pairs a prefix
// of each list) writes point_valid false for its four points, one 32-bit
// word, and nothing else, as the box-box kernel's: contacts.compact_manifolds
// reads no other field of a slot without a valid point
// (tests/test_torch_live_pairs.py holds it to that). The output pointers are
// row 0 of this launch's rows: contacts.narrowphase_all passes the rows
// after box-box's of its joined buffers.
//
// What bounds it on an H100: latency, not bytes or operations. A live pair
// reads two collider records (at most 48 + 24 bytes) by scattered index,
// does ~200 float operations and writes 116 bytes; a dead slot reads 1 byte
// and writes 4. The design: one launch for both ranges with no
// concatenation or cast around it (the wrapper enqueues this kernel and
// nothing else), no work for dead slots, and a live slot's point rows out
// as 16-byte words (pos three float4, depth one float4, feat one int4,
// point_valid one 32-bit word; a slot's rows are 48, 16, 16 and 4 bytes, so
// every row is aligned where row 0 is: the wrapper checks each base).

#include "common.cuh"

namespace {

struct Colliders {
  const float* half;      // [nb, 3]
  const float* box_quat;  // [nb, 4]
  const float* box_pos;   // [nb, 3]
  const float* box_fric;  // [nb]
  const int* box_body;    // [nb]
  const float* radius;    // [ns]
  const float* sph_pos;   // [ns, 3]
  const float* sph_fric;  // [ns]
  const int* sph_body;    // [ns]
};

struct Pairs {
  const int* bs_a;  // [n_bs] box a, sphere b
  const int* bs_b;
  const bool* bs_valid;
  const int* ss_a;  // [n_ss] sphere a, sphere b
  const int* ss_b;
  const bool* ss_valid;
};

struct Slots {
  float* normal;  // [P, 3]
  float* fric;    // [P]
  int* ba;        // [P]
  int* bb;        // [P]
  float* pos;     // [P, 4, 3]
  float* depth;   // [P, 4]
  int* feat;      // [P, 4]
  bool* valid;    // [P, 4]
  int* ga;        // [P]
  int* gb;        // [P]
};

__global__ void __launch_bounds__(kThreads)
    pairs_1pt_kernel(Colliders c, Pairs in, int nb, int n_bs, int n_ss, Slots out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_bs + n_ss) return;
  const bool sphere_a = r >= n_bs;
  const int q = sphere_a ? r - n_bs : r;
  if (!(sphere_a ? in.ss_valid[q] : in.bs_valid[q])) {
    reinterpret_cast<unsigned*>(out.valid)[r] = 0u;
    return;
  }
  const int a = sphere_a ? in.ss_a[q] : in.bs_a[q];
  const int b = sphere_a ? in.ss_b[q] : in.bs_b[q];

  const float rb = c.radius[b];
  const V3 pb = load3(c.sph_pos + 3 * b);
  V3 nrm, pos;
  float depth, fa;
  int body_a;
  if (sphere_a) {
    // sphere-sphere (narrowphase.sphere_sphere)
    const float ra = c.radius[a];
    const V3 pa = load3(c.sph_pos + 3 * a);
    const V3 d = sub(pb, pa);
    const float d2 = d.x * d.x + d.y * d.y + d.z * d.z;
    const float dist = sqrtf(fmaxf(d2, 1e-12f));
    nrm = d2 > 1e-12f ? v3(d.x / dist, d.y / dist, d.z / dist) : v3(0.0f, 1.0f, 0.0f);
    depth = (ra + rb) - dist;
    const float s = ra - 0.5f * depth;
    pos = v3(pa.x + nrm.x * s, pa.y + nrm.y * s, pa.z + nrm.z * s);
    fa = c.sph_fric[a];
    body_a = c.sph_body[a];
  } else {
    // box-sphere (narrowphase.box_sphere)
    const float h[3] = {c.half[3 * a], c.half[3 * a + 1], c.half[3 * a + 2]};
    const V3 pa = load3(c.box_pos + 3 * a);
    const M3 Ra = quat_to_mat(load4(c.box_quat + 4 * a));
    const V3 cc = mtv(Ra, sub(pb, pa));  // sphere centre in the box frame
    const float ctr[3] = {cc.x, cc.y, cc.z};
    float cl[3], dl[3], fp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cl[i] = fminf(fmaxf(ctr[i], -h[i]), h[i]);
      dl[i] = ctr[i] - cl[i];
      fp[i] = h[i] - fabsf(ctr[i]);
    }
    const float d2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2];
    const bool outside = d2 > 1e-12f;
    const float dist = sqrtf(fmaxf(d2, 1e-12f));
    // least-penetrated face, first minimum
    int k = 0;
    if (fp[1] < fp[k]) k = 1;
    if (fp[2] < fp[k]) k = 2;
    const float fk = k == 0 ? fp[0] : (k == 1 ? fp[1] : fp[2]);
    const float sgn = (k == 0 ? ctr[0] : (k == 1 ? ctr[1] : ctr[2])) >= 0.0f ? 1.0f : -1.0f;
    float nl[3], pl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (outside) {
        nl[i] = dl[i] / dist;
        pl[i] = cl[i];
      } else {
        nl[i] = i == k ? sgn : 0.0f;
        pl[i] = i == k ? sgn * h[i] : ctr[i];
      }
    }
    depth = outside ? rb - dist : rb + fk;
    pos = add(mv(Ra, v3(pl[0], pl[1], pl[2])), pa);
    nrm = mv(Ra, v3(nl[0], nl[1], nl[2]));
    fa = c.box_fric[a];
    body_a = c.box_body[a];
  }

  float4* prow = reinterpret_cast<float4*>(out.pos) + 3 * r;
  prow[0] = make_float4(pos.x, pos.y, pos.z, 0.0f);
  prow[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  prow[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  reinterpret_cast<float4*>(out.depth)[r] = make_float4(depth, 0.0f, 0.0f, 0.0f);
  reinterpret_cast<int4*>(out.feat)[r] = make_int4(0, 0, 0, 0);
  reinterpret_cast<unsigned*>(out.valid)[r] = depth > 0.0f ? 1u : 0u;
  store3(out.normal + 3 * r, nrm);
  out.fric[r] = sqrtf(fmaxf(fa * c.sph_fric[b], 0.0f));
  out.ba[r] = body_a;
  out.bb[r] = c.sph_body[b];
  out.ga[r] = sphere_a ? nb + a : a;
  out.gb[r] = nb + b;
}

}  // namespace

extern "C" int nudge_pairs_1pt(const float* half, const float* box_quat, const float* box_pos,
                               const float* box_fric, const int* box_body, const float* radius,
                               const float* sph_pos, const float* sph_fric, const int* sph_body,
                               const int* bs_a, const int* bs_b, const bool* bs_valid,
                               const int* ss_a, const int* ss_b, const bool* ss_valid, int nb,
                               int n_bs, int n_ss, float* out_normal, float* out_fric,
                               int* out_ba, int* out_bb, float* out_pos, float* out_depth,
                               int* out_feat, bool* out_valid, int* out_ga, int* out_gb,
                               void* stream) {
  const int rows = n_bs + n_ss;
  if (rows > 0) {
    const Colliders c{half, box_quat, box_pos, box_fric, box_body,
                      radius, sph_pos, sph_fric, sph_body};
    const Pairs in{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid};
    const Slots out{out_normal, out_fric, out_ba,    out_bb, out_pos,
                    out_depth,  out_feat, out_valid, out_ga, out_gb};
    pairs_1pt_kernel<<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(c, in, nb, n_bs,
                                                                            n_ss, out);
  }
  return (int)cudaGetLastError();
}
