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
// The per-pair math, one_point, hands back its intermediate values beside
// the contact: the forward kernel stores the contact, and the backward
// kernel (pairs_1pt_bwd_kernel) runs the reverse, one_point_adjoint, from
// them, so it replays every branch of the forward on the forward's bits.
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

#include "adjoint.cuh"

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

// The pose inputs of a pair, in the order of the backward kernel's adjoint
// rows (the box-box kernel's): side a's world position (0-2) and, for a
// box, quaternion (3-6); side b's (a sphere) position (7-9); 10-13 are
// always zero.
constexpr int kPoseInputs = 14;
// The shape inputs of a pair, in the order of the shape adjoint rows (the
// box-box kernel's): side a's half extents (0-2, a box's), friction (3)
// and radius (4, a sphere's), then side b's (5-9).
constexpr int kShapeInputs = 10;

// A pair's contact (pos, nrm, depth) and the values its reverse reads:
// both centres, side a's rotation (a box), and the intermediates of the
// branch that ran.
struct OnePoint {
  V3 pos, nrm, pa, pb;
  float depth;
  M3 Ra;
  float h[3];
  float d[3];   // sphere-sphere pb - pa; box-sphere the centre in the box frame
  float cl[3];  // box-sphere: the centre clamped to the box, dl = d - cl
  float dl[3], nl[3], pl[3];  // and the normal and point in the box frame
  float d2, dist, s;          // |dl|² (sphere-sphere |d|²), its sqrt; s = ra - depth/2
  int k;                      // box-sphere: the least-penetrated face
  bool apart;                 // d2 > 1e-12: the centres apart, or outside the box
};

// The contact of pair (a, b) (sphere_a: sphere-sphere, else box-sphere),
// the twins' math.
__device__ __forceinline__ OnePoint one_point(const Colliders& c, bool sphere_a, int a, int b) {
  const float rb = c.radius[b];
  OnePoint o;
  o.pb = load3(c.sph_pos + 3 * b);
  if (sphere_a) {
    // sphere-sphere (narrowphase.sphere_sphere)
    const float ra = c.radius[a];
    o.pa = load3(c.sph_pos + 3 * a);
    const V3 d = sub(o.pb, o.pa);
    o.d[0] = d.x;
    o.d[1] = d.y;
    o.d[2] = d.z;
    o.d2 = d.x * d.x + d.y * d.y + d.z * d.z;
    o.dist = sqrtv(clamp_min(o.d2, 1e-12f));
    o.apart = o.d2 > 1e-12f;
    o.nrm = o.apart ? v3(d.x / o.dist, d.y / o.dist, d.z / o.dist) : v3(0.0f, 1.0f, 0.0f);
    o.depth = (ra + rb) - o.dist;
    o.s = ra - 0.5f * o.depth;
    o.pos = v3(o.pa.x + o.nrm.x * o.s, o.pa.y + o.nrm.y * o.s, o.pa.z + o.nrm.z * o.s);
  } else {
    // box-sphere (narrowphase.box_sphere)
#pragma unroll
    for (int i = 0; i < 3; ++i) o.h[i] = c.half[3 * a + i];
    o.pa = load3(c.box_pos + 3 * a);
    o.Ra = quat_to_mat(load4(c.box_quat + 4 * a));
    const V3 cc = mtv(o.Ra, sub(o.pb, o.pa));  // sphere centre in the box frame
    o.d[0] = cc.x;
    o.d[1] = cc.y;
    o.d[2] = cc.z;
    float fp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o.cl[i] = minimum(maximum(o.d[i], -o.h[i]), o.h[i]);
      o.dl[i] = o.d[i] - o.cl[i];
      fp[i] = o.h[i] - absv(o.d[i]);
    }
    o.d2 = o.dl[0] * o.dl[0] + o.dl[1] * o.dl[1] + o.dl[2] * o.dl[2];
    o.apart = o.d2 > 1e-12f;
    o.dist = sqrtv(clamp_min(o.d2, 1e-12f));
    // least-penetrated face, first minimum
    int k = 0;
    if (fp[1] < fp[k]) k = 1;
    if (fp[2] < fp[k]) k = 2;
    o.k = k;
    const float fk = k == 0 ? fp[0] : (k == 1 ? fp[1] : fp[2]);
    const float sgn = (k == 0 ? o.d[0] : (k == 1 ? o.d[1] : o.d[2])) >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (o.apart) {
        o.nl[i] = o.dl[i] / o.dist;
        o.pl[i] = o.cl[i];
      } else {
        o.nl[i] = i == k ? sgn : 0.0f;
        o.pl[i] = i == k ? sgn * o.h[i] : o.d[i];
      }
    }
    o.depth = o.apart ? rb - o.dist : rb + fk;
    o.pos = add(mv(o.Ra, v3(o.pl[0], o.pl[1], o.pl[2])), o.pa);
    o.nrm = mv(o.Ra, v3(o.nl[0], o.nl[1], o.nl[2]));
  }
  return o;
}

// The adjoints of a pair's shapes: box a's half extents, both radii (named
// scalars: an array here took a stack frame).
struct ShapeAdj {
  float h0, h1, h2, ra, rb;
};

// The reverse of one_point (its forward values o): the adjoints of the
// pose inputs (kPoseInputs order) from those of point 0's pos (gp) and
// depth (gd) and of the normal (gn); box a's quaternion is read again.
// With kShape also those of the shapes into S.
template <bool kShape>
__device__ __forceinline__ void one_point_adjoint(const Colliders& c, const OnePoint& o,
                                                  bool sphere_a, int a, V3 gp, float gd, V3 gn,
                                                  float (&adj)[kPoseInputs], ShapeAdj& S) {
#pragma unroll
  for (int i = 0; i < kPoseInputs; ++i) adj[i] = 0.0f;
  S = ShapeAdj{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float g_d[3];
  if (sphere_a) {
    // pos = pa + nrm s, s = ra - 0.5 depth, depth = (ra + rb) - dist,
    // nrm = d2 > 1e-12 ? d / dist : (0, 1, 0), dist = sqrt(clamp_min(d2, 1e-12))
    const float gn3[3] = {gn.x + gp.x * o.s, gn.y + gp.y * o.s, gn.z + gp.z * o.s};
    const float nrm[3] = {o.nrm.x, o.nrm.y, o.nrm.z};
    const float g_s = (gp.x * o.nrm.x + gp.y * o.nrm.y) + gp.z * o.nrm.z;
    float g_dist = -(gd - 0.5f * g_s);
    if constexpr (kShape) {
      // s = ra - 0.5 depth, depth = (ra + rb) - dist
      S.ra = g_s + (gd - 0.5f * g_s);
      S.rb = gd - 0.5f * g_s;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_d[i] = o.apart ? gn3[i] / o.dist : 0.0f;
      if (o.apart) g_dist = g_dist - gn3[i] * (nrm[i] / o.dist);
    }
    const float g_d2 = clamp_min_adjoint(g_dist / (2.0f * o.dist), o.d2, 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) g_d[i] = g_d[i] + 2.0f * o.d[i] * g_d2;
    adj[0] = gp.x - g_d[0];
    adj[1] = gp.y - g_d[1];
    adj[2] = gp.z - g_d[2];
  } else {
    // pos = Ra pl + pa, nrm = Ra nl
    M3 g_Ra = {};
    mv_adjoint_m(&g_Ra, gp, v3(o.pl[0], o.pl[1], o.pl[2]));
    mv_adjoint_m(&g_Ra, gn, v3(o.nl[0], o.nl[1], o.nl[2]));
    const V3 gpl = mtv(o.Ra, gp), gnl = mtv(o.Ra, gn);
    const float g_pl[3] = {gpl.x, gpl.y, gpl.z}, g_nl[3] = {gnl.x, gnl.y, gnl.z};
    float g_ctr[3];
    if (o.apart) {
      // outside: depth = rb - dist, nl = dl / dist, pl = cl, dl = ctr - cl,
      // cl = minimum(maximum(ctr, -h), h), whose derivative w is 1 inside,
      // 0 clamped, 1/2 at a tie: ctr's adjoint g_dl (1 - w) + g_pl w, so
      // that g_dl (~1 / dist near the surface) cancels exactly where w = 1
      float g_dl[3], g_dist = -gd;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g_dl[i] = g_nl[i] / o.dist;
        g_dist = g_dist - g_nl[i] * (o.nl[i] / o.dist);
      }
      const float g_d2 = clamp_min_adjoint(g_dist / (2.0f * o.dist), o.d2, 1e-12f);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g_dl[i] = g_dl[i] + 2.0f * o.dl[i] * g_d2;
        const float w = clamp2_adjoint(1.0f, o.d[i], o.h[i]);
        g_ctr[i] = g_dl[i] * (1.0f - w) + g_pl[i] * w;
        // the clamp's bound h: cl's adjoint is g_pl - g_dl
        if constexpr (kShape) {
          float gh = 0.0f;
          clamp2_adjoint(g_pl[i] - g_dl[i], o.d[i], o.h[i], &gh);
          if (i == 0) S.h0 = gh;
          if (i == 1) S.h1 = gh;
          if (i == 2) S.h2 = gh;
        }
      }
    } else {
      // inside: depth = rb + (h - |ctr|)[k]; pl = ctr off face k; nl a constant
#pragma unroll
      for (int i = 0; i < 3; ++i) g_ctr[i] = i == o.k ? -abs_adjoint(gd, o.d[i]) : g_pl[i];
      if constexpr (kShape) {
        // and pl[k] = sgn h[k]
        const float sgn = (o.k == 0 ? o.d[0] : (o.k == 1 ? o.d[1] : o.d[2])) >= 0.0f ? 1.0f : -1.0f;
        if (o.k == 0) S.h0 = gd + sgn * g_pl[0];
        if (o.k == 1) S.h1 = gd + sgn * g_pl[1];
        if (o.k == 2) S.h2 = gd + sgn * g_pl[2];
      }
    }
    if constexpr (kShape) S.rb = gd;  // depth = rb - dist or rb + fk
    // ctr = Raᵀ (pb - pa)
    const V3 gc = v3(g_ctr[0], g_ctr[1], g_ctr[2]);
    mtv_adjoint_m(&g_Ra, gc, sub(o.pb, o.pa));
    const V3 gdd = mv(o.Ra, gc);
    g_d[0] = gdd.x;
    g_d[1] = gdd.y;
    g_d[2] = gdd.z;
    adj[0] = gp.x - g_d[0];
    adj[1] = gp.y - g_d[1];
    adj[2] = gp.z - g_d[2];
    const Q4 gq = quat_to_mat_adjoint(load4(c.box_quat + 4 * a), g_Ra);
    adj[3] = gq.x;
    adj[4] = gq.y;
    adj[5] = gq.z;
    adj[6] = gq.w;
  }
  adj[7] = g_d[0];
  adj[8] = g_d[1];
  adj[9] = g_d[2];
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
  const OnePoint o = one_point(c, sphere_a, a, b);
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

// The backward: one thread a pair row, over both ranges as the forward. A
// live pair runs one_point (the forward's bits) and its reverse and writes
// adj[r][0..13] through point 0's pos and depth and the normal (points 1-3
// are constants) as seven 8-byte words: box-sphere rows columns 0-9 (box
// pos and quat, sphere pos), sphere-sphere rows 0-2 and 7-9, zeros in the
// rest, which the per-collider segment sum (csrc/segment.cu) reads as a
// live row's. A dead pair slot writes nothing (contacts.collider_entries
// gives its rows the key the sum skips). A null output adjoint is zero.
//
// The shape instance (kShape, launched only when the caller passes
// adj_shape) also writes adj_shape[r][0..9], the adjoints of side a's
// half extents (a box's), friction and radius (a sphere's), then side b's
// (always a sphere), as five 8-byte words: through the contact, and
// through the pair's friction sqrt(max(fa fb, 0)) from its adjoint g_fric
// (may be null: zero), whose reverse and its value at fa fb == 0 are the
// box-box kernel's (csrc/narrowphase.cu: autograd's for the twin).
//
// What bounds it on an H100: latency, as the forward: ~200 operations a
// live pair forward and about as many back, 36 B read and 56 B written
// (with kShape 12 B more read and 40 B more written).
template <bool kShape>
__global__ void __launch_bounds__(kThreads)
    pairs_1pt_bwd_kernel(Colliders c, Pairs in, int n_bs, int n_ss,
                         const float* __restrict__ g_pos, const float* __restrict__ g_depth,
                         const float* __restrict__ g_normal, const float* __restrict__ g_fric,
                         float* __restrict__ adj, float* __restrict__ adj_shape) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_bs + n_ss) return;
  const bool sphere_a = r >= n_bs;
  const int q = sphere_a ? r - n_bs : r;
  if (!(sphere_a ? in.ss_valid[q] : in.bs_valid[q])) return;
  const int a = sphere_a ? in.ss_a[q] : in.bs_a[q];
  const int b = sphere_a ? in.ss_b[q] : in.bs_b[q];
  const OnePoint o = one_point(c, sphere_a, a, b);
  const V3 gp = g_pos ? load3(g_pos + 12LL * r) : v3(0.0f, 0.0f, 0.0f);
  const float gd = g_depth ? g_depth[4LL * r] : 0.0f;
  const V3 gn = g_normal ? load3(g_normal + 3LL * r) : v3(0.0f, 0.0f, 0.0f);
  float g[kPoseInputs];
  ShapeAdj S;
  one_point_adjoint<kShape>(c, o, sphere_a, a, gp, gd, gn, g, S);
  float2* row = reinterpret_cast<float2*>(adj + (long long)kPoseInputs * r);
#pragma unroll
  for (int w = 0; w < kPoseInputs / 2; ++w) row[w] = make_float2(g[2 * w], g[2 * w + 1]);
  if constexpr (kShape) {
    float g_fa = 0.0f, g_fb = 0.0f;
    if (g_fric) {
      const float fa = sphere_a ? c.sph_fric[a] : c.box_fric[a], fb = c.sph_fric[b];
      const float x = fa * fb;
      const float gx = x >= 0.0f ? g_fric[r] / (2.0f * sqrtf(fmaxf(x, 0.0f))) : 0.0f;
      g_fa = gx * fb;
      g_fb = gx * fa;
    }
    // side a: half (a box's), friction, radius (a sphere's); side b: a
    // sphere's friction and radius
    float2* srow = reinterpret_cast<float2*>(adj_shape + (long long)kShapeInputs * r);
    srow[0] = make_float2(S.h0, S.h1);
    srow[1] = make_float2(S.h2, g_fa);
    srow[2] = make_float2(S.ra, 0.0f);
    srow[3] = make_float2(0.0f, 0.0f);
    srow[4] = make_float2(g_fb, S.rb);
  }
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

// The adjoint rows of the colliders' poses, one per live pair row of this
// launch (the box-sphere rows, then the sphere-sphere rows): adj[r][0..13],
// from the rows' adjoints g_pos[P,4,3], g_depth[P,4], g_normal[P,3] (each
// may be null: zero). With adj_shape (else null) also adj_shape[r][0..9]
// (the shapes' and frictions' adjoints; the frictions through g_fric[P],
// may be null: zero). A dead row is not written. adj and adj_shape must be
// 8-byte aligned.
extern "C" int nudge_pairs_1pt_bwd(const float* half, const float* box_quat,
                                   const float* box_pos, const float* box_fric,
                                   const float* radius, const float* sph_pos,
                                   const float* sph_fric, const int* bs_a, const int* bs_b,
                                   const bool* bs_valid, const int* ss_a, const int* ss_b,
                                   const bool* ss_valid, int n_bs, int n_ss, const float* g_pos,
                                   const float* g_depth, const float* g_normal,
                                   const float* g_fric, float* adj, float* adj_shape,
                                   void* stream) {
  const int rows = n_bs + n_ss;
  if (rows > 0) {
    const Colliders c{half, box_quat, box_pos, box_fric, nullptr,
                      radius, sph_pos, sph_fric, nullptr};
    const Pairs in{bs_a, bs_b, bs_valid, ss_a, ss_b, ss_valid};
    if (adj_shape)
      pairs_1pt_bwd_kernel<true><<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
          c, in, n_bs, n_ss, g_pos, g_depth, g_normal, g_fric, adj, adj_shape);
    else
      pairs_1pt_bwd_kernel<false><<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
          c, in, n_bs, n_ss, g_pos, g_depth, g_normal, g_fric, adj, adj_shape);
  }
  return (int)cudaGetLastError();
}
