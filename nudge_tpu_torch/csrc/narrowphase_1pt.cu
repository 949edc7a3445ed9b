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
// The per-pair math, one_point, is a template over its scalar type: floats
// in the forward, the dual numbers of dual.cuh in pairs_1pt_bwd_kernel
// (the differentiable mode's backward).
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

#include "dual.cuh"

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

// The pose inputs of a pair, in the order of the backward kernel's tangents
// and of its adjoint rows (the box-box kernel's): side a's world position
// (0-2) and, for a box, quaternion (3-6); side b's (a sphere) position
// (7-9); 10-13 are always zero.
constexpr int kPoseTangents = 14;

template <typename T>
struct OnePoint {
  Vec3<T> pos, nrm;
  T depth;
};

// The contact of pair (a, b) (sphere_a: sphere-sphere, else box-sphere),
// the twins' math over scalars of type T (float, or Dual with the pose
// input `seed` seeded; -1 for none).
template <typename T>
__device__ __forceinline__ OnePoint<T> one_point(const Colliders& c, bool sphere_a, int a, int b,
                                                 int seed) {
  const float rb = c.radius[b];
  const Vec3<T> pb = seeded3<T>(c.sph_pos + 3 * b, 7, seed);
  OnePoint<T> o;
  if (sphere_a) {
    // sphere-sphere (narrowphase.sphere_sphere)
    const float ra = c.radius[a];
    const Vec3<T> pa = seeded3<T>(c.sph_pos + 3 * a, 0, seed);
    const Vec3<T> d = sub(pb, pa);
    const T d2 = d.x * d.x + d.y * d.y + d.z * d.z;
    const T dist = sqrtv(clamp_min(d2, 1e-12f));
    o.nrm = d2 > 1e-12f ? v3(d.x / dist, d.y / dist, d.z / dist) : v3(T(0.0f), T(1.0f), T(0.0f));
    o.depth = (ra + rb) - dist;
    const T s = ra - 0.5f * o.depth;
    o.pos = v3(pa.x + o.nrm.x * s, pa.y + o.nrm.y * s, pa.z + o.nrm.z * s);
  } else {
    // box-sphere (narrowphase.box_sphere)
    const float h[3] = {c.half[3 * a], c.half[3 * a + 1], c.half[3 * a + 2]};
    const Vec3<T> pa = seeded3<T>(c.box_pos + 3 * a, 0, seed);
    const Mat3<T> Ra = quat_to_mat(seeded4<T>(c.box_quat + 4 * a, 3, seed));
    const Vec3<T> cc = mtv(Ra, sub(pb, pa));  // sphere centre in the box frame
    const T ctr[3] = {cc.x, cc.y, cc.z};
    T cl[3], dl[3], fp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cl[i] = minimum(maximum(ctr[i], T(-h[i])), T(h[i]));
      dl[i] = ctr[i] - cl[i];
      fp[i] = h[i] - absv(ctr[i]);
    }
    const T d2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2];
    const bool outside = d2 > 1e-12f;
    const T dist = sqrtv(clamp_min(d2, 1e-12f));
    // least-penetrated face, first minimum
    int k = 0;
    if (fp[1] < fp[k]) k = 1;
    if (fp[2] < fp[k]) k = 2;
    const T fk = k == 0 ? fp[0] : (k == 1 ? fp[1] : fp[2]);
    const float sgn = (k == 0 ? ctr[0] : (k == 1 ? ctr[1] : ctr[2])) >= 0.0f ? 1.0f : -1.0f;
    T nl[3], pl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (outside) {
        nl[i] = dl[i] / dist;
        pl[i] = cl[i];
      } else {
        nl[i] = T(i == k ? sgn : 0.0f);
        pl[i] = i == k ? T(sgn * h[i]) : ctr[i];
      }
    }
    o.depth = outside ? rb - dist : rb + fk;
    o.pos = add(mv(Ra, v3(pl[0], pl[1], pl[2])), pa);
    o.nrm = mv(Ra, v3(nl[0], nl[1], nl[2]));
  }
  return o;
}

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
  const OnePoint<float> o = one_point<float>(c, sphere_a, a, b, -1);
  const V3 pos = o.pos, nrm = o.nrm;
  const float depth = o.depth;
  const float fa = sphere_a ? c.sph_fric[a] : c.box_fric[a];
  const int body_a = sphere_a ? c.sph_body[a] : c.box_body[a];

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

// The backward: thread (r, j) runs pair r's math with pose input j seeded
// (one_point<Dual>) and writes adj[r][j] = Σ tangent · output adjoint over
// point 0's pos and depth and the normal (points 1-3 are constants). Inputs
// a pair does not have (a sphere's quaternion, side b's 10-13) and dead
// pair slots write zeros. The per-collider sums are csrc/segment.cu's.
//
// What bounds it on an H100: latency, as the forward: ~3x the forward's
// ~200 operations a live pair (the tangents), 14 threads a pair.
__global__ void __launch_bounds__(kThreads)
    pairs_1pt_bwd_kernel(Colliders c, Pairs in, int n_bs, int n_ss,
                         const float* __restrict__ g_pos, const float* __restrict__ g_depth,
                         const float* __restrict__ g_normal, float* __restrict__ adj) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)(n_bs + n_ss) * kPoseTangents) return;
  const int r = (int)(t / kPoseTangents), j = (int)(t % kPoseTangents);
  const bool sphere_a = r >= n_bs;
  const int q = sphere_a ? r - n_bs : r;
  const bool live = sphere_a ? in.ss_valid[q] : in.bs_valid[q];
  if (!live || j >= 10 || (sphere_a && j >= 3 && j < 7)) {
    adj[t] = 0.0f;
    return;
  }
  const int a = sphere_a ? in.ss_a[q] : in.bs_a[q];
  const int b = sphere_a ? in.ss_b[q] : in.bs_b[q];
  const OnePoint<Dual> o = one_point<Dual>(c, sphere_a, a, b, j);
  float g = o.pos.x.d * g_pos[12 * r] + o.pos.y.d * g_pos[12 * r + 1] +
            o.pos.z.d * g_pos[12 * r + 2];
  g = g + o.depth.d * g_depth[4 * r];
  g = g + (o.nrm.x.d * g_normal[3 * r] + o.nrm.y.d * g_normal[3 * r + 1] +
           o.nrm.z.d * g_normal[3 * r + 2]);
  adj[t] = g;
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

// The adjoint rows of the colliders' poses, one per pair row of this launch
// (the box-sphere rows, then the sphere-sphere rows): adj[r][0..13], from
// the rows' adjoints g_pos[P,4,3], g_depth[P,4], g_normal[P,3].
extern "C" int nudge_pairs_1pt_bwd(const float* half, const float* box_quat,
                                   const float* box_pos, const float* radius,
                                   const float* sph_pos, const int* bs_a, const int* bs_b,
                                   const bool* bs_valid, const int* ss_a, const int* ss_b,
                                   const bool* ss_valid, int n_bs, int n_ss, const float* g_pos,
                                   const float* g_depth, const float* g_normal, float* adj,
                                   void* stream) {
  const long long threads = (long long)(n_bs + n_ss) * kPoseTangents;
  if (threads > 0) {
    const Colliders c{half, box_quat, box_pos, nullptr, nullptr,
                      radius, sph_pos, nullptr, nullptr};
    const Pairs in{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid};
    pairs_1pt_bwd_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(c, in, n_bs, n_ss, g_pos, g_depth, g_normal,
                                                   adj);
  }
  return (int)cudaGetLastError();
}
