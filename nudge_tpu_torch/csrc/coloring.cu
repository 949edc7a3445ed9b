// Greedy Luby manifold coloring: every claim round in one launch of one
// thread-block cluster, for the fresh coloring and for the cached one.
//
// Replaces nudge_tpu/ops/coloring_kernel.py: color_manifolds_pallas
// (_color_kernel). The TPU kernel ran its rounds in one pallas_call with a
// while loop, scattering claims and gathering them back through one-hot
// matmuls over membership-bitmask tile windows. Here one cluster of CTAs
// (the solve's: 16 where the occupancy query places a non-portable
// cluster, else 8; common.cuh choose_cluster) runs every round. In round r
// every uncolored valid manifold i claims each of its dynamic bodies with
// atomicMin of the key (~r) << 32 | (i ^ h[r]); after a cluster barrier a
// manifold whose key holds both claims takes color r, and one that lost
// claims round r + 1 at once. The high word makes a later round's key
// smaller than any earlier one, and rounds alternate between two claim
// tables, so round r + 1's claims overwrite round r - 1's without a reset
// and never touch the table that round r is still read from: one barrier
// a round. The loop stops when a round finds no manifold pending (each CTA
// stamps the last round it had one in its shared memory; after the
// barrier every warp reads all the stamps through distributed shared
// memory) or after n_rounds rounds, as the reference's loop does. int
// atomicMin does not depend on the order of the claims, and a round's keys
// order as its tokens do, so the colors equal the plain twin's
// (ops/coloring_kernel.py: color_rounds_plain) bit for bit. The round
// constants h[r] are computed on the host: the hash needs int32
// wraparound and an arithmetic shift.
//
// The cached instance (kCached; ops/solver.py color_manifolds_cached, twin
// ops/coloring_kernel.py color_rounds_cached_plain) starts from the colors
// joined from last step's cache: color[i] is a manifold's cached color or
// -1, and the kernel writes the raw colors over it in place. Before the
// rounds, one pass zeroes a forbidden-color mask per body (ceil(K / 32)
// 32-bit words, K = n_rounds + 1 colors) and, after a barrier, every live
// manifold with a cached color c sets bit min(c, K - 1) in the mask of each
// dynamic side with atomicOr; after the next barrier the masks are only
// read. A manifold is eligible in round r when no dynamic side has bit r
// set; only eligible manifolds claim, and the win check tests eligibility
// again from the same masks, so a manifold reads back only the bodies it
// claimed. The twin also sets bit r for each of round r's winners, but
// round r reads bit r before it writes it and later rounds read only
// higher bits, so those writes change no color and the kernel leaves them
// out. The twin's loop runs while any valid manifold is uncolored, not
// while any claims: one that no round has been free for yet keeps the loop
// going, since a later color may be. So a CTA stamps "pending" from its
// uncolored manifolds, eligible or not. The number of rounds run goes to
// `rounds`.
//
// Why one barrier a round is enough. Call B_r the barrier at the top of
// round r. Round r's claims all go into table r & 1 before B_r (round 0's
// before the loop, round r + 1's in round r's pass); between B_r and
// B_r+1 that table is only read, and the claims of round r + 1 go into the
// other one, which was last read before B_r. So no claim races a read of
// its table. A table's stale keys are of rounds <= r - 1, whose high word
// is larger, so each of round r + 1's claims replaces the stale key; the
// key read back for a body is then the least of the round's claims on it.
// A manifold reads back only bodies it claimed in the same round (an
// uncolored one claims every round it is eligible in until the last). The
// stop is uniform: the stamps one warp reads after B_r + 1 hold r + 2 from
// some CTA if and only if some manifold was pending in round r, since a
// stamp of r + 3 is written only by a CTA that did not stop.
//
// The manifolds are spread over every thread of the cluster, warps
// interleaved over the CTAs. Before the first round one pass sets every
// color to -1 (the fresh instance) and finds the end of the live manifolds
// (compact_manifolds packs them to a prefix); the rounds walk only that
// range. The claim tables (two of n_bodies 64-bit keys) and the masks live
// in global memory, so any body count fits; they stay L2-resident and are
// read back with __ldcg, past L1.
// Tables in the cluster's distributed shared memory do not work with these
// keys on an H100: a 64-bit atomicMin into another CTA's shared memory,
// through map_shared_rank or as atom.shared::cluster.min.u64, is not
// atomic there (ptxas emits a generic ATOM.E.MIN.64 and a CAS loop only for
// the CTA's own window), and about a fifth of the minima come out wrong
// and differ from launch to launch, while 32-bit atomicMin and 64-bit
// atomicCAS through map_shared_rank are right (scripts/dsm_atomic_probe.py,
// PERF.md). Such tables, tried with the broken atomicMin, were also slower.
//
// What bounds it on an H100: the rounds are dependent, so the time is the
// rounds used times a cluster barrier and one claim-and-check pass (an
// atomic and a read a dynamic body, each an L2 round trip); the bytes
// (~13 B a live manifold, 4 B of mask words a body) are nothing.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kColorThreads = 1024;
constexpr unsigned long long kNoClaim = ~0ull;

struct ColorArgs {
  const int* body_a;
  const int* body_b;
  const bool* valid;
  const bool* dyn;
  const int* hashes;
  int m, n_bodies, n_rounds;
  unsigned long long* claim;  // [2, n_bodies], the global tables
  int* color;                 // the cached instance reads the cached colors here
  unsigned* mask;             // the cached instance's [n_bodies, words] masks
  int words;
  int* rounds;                // the cached instance's rounds run
};

__device__ __forceinline__ unsigned long long claim_key(int r, int tok) {
  return ((unsigned long long)(~(unsigned)r) << 32) | (unsigned)tok;
}

// max over the cluster's CTAs of the int at `local` in each one's shared
// memory, in every lane of the warp
__device__ __forceinline__ int cluster_max(cg::cluster_group& cluster, int* local, int nb) {
  const int lane = threadIdx.x & 31;
  const int x = lane < nb ? *cluster.map_shared_rank(local, lane) : 0;
  return __reduce_max_sync(0xffffffffu, x);
}

template <bool kCached>
__global__ void __launch_bounds__(kColorThreads) color_kernel(ColorArgs A) {
  __shared__ int s_end;    // this CTA's last live manifold + 1
  __shared__ int s_stamp;  // r + 1 for the last round r in which this CTA had one pending
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int stride = nb * kColorThreads;
  const int g = ((threadIdx.x >> 5) * nb + (int)cluster.block_rank()) * 32 + (threadIdx.x & 31);
  const bool leader = (threadIdx.x & 31) == 0;
  const long long nbody = A.n_bodies;

  auto table = [&](int r, int body) { return A.claim + (r & 1) * nbody + body; };
  auto claim = [&](int i, int r, int a, int b) {
    const unsigned long long key = claim_key(r, i ^ A.hashes[r]);
    if (A.dyn[a]) atomicMin(table(r, a), key);
    if (A.dyn[b]) atomicMin(table(r, b), key);
  };
  auto holds = [&](int r, int body, unsigned long long key) {
    return __ldcg(table(r, body)) == key;
  };
  auto mask_word = [&](int body, int c) { return A.mask + (long long)body * A.words + (c >> 5); };
  // no dynamic side holds a cached color r (static bodies have no bits)
  auto eligible = [&](int r, int a, int b) {
    if constexpr (kCached) {
      const unsigned bit = 1u << (r & 31);
      return !(__ldcg(mask_word(a, r)) & bit) && !(__ldcg(mask_word(b, r)) & bit);
    } else {
      return true;
    }
  };

  if (threadIdx.x == 0) {
    s_end = 0;
    s_stamp = 0;
  }
  for (long long j = g; j < 2 * nbody; j += stride) __stcg(A.claim + j, kNoClaim);
  if constexpr (kCached)
    for (long long j = g; j < nbody * A.words; j += stride) __stcg(A.mask + j, 0u);
  __syncthreads();
  int end = 0;
  for (int i = g; i < A.m; i += stride) {
    if constexpr (!kCached) A.color[i] = -1;
    if (A.valid[i]) end = i + 1;
  }
  end = __reduce_max_sync(0xffffffffu, end);
  if (leader && end) atomicMax(&s_end, end);
  cluster.sync();  // tables, masks, colors and every CTA's s_end ready; every CTA running
  end = cluster_max(cluster, &s_end, nb);

  if constexpr (kCached) {
    for (int i = g; i < end; i += stride) {
      const int c = A.valid[i] ? A.color[i] : -1;
      if (c < 0) continue;
      const int k = min(c, A.n_rounds);
      const int a = A.body_a[i], b = A.body_b[i];
      if (A.dyn[a]) atomicOr(mask_word(a, k), 1u << (k & 31));
      if (A.dyn[b]) atomicOr(mask_word(b, k), 1u << (k & 31));
    }
    cluster.sync();  // the masks are whole; from here on they are only read
  }

  bool pending = false;
  if (A.n_rounds > 0)
    for (int i = g; i < end; i += stride) {
      if (!A.valid[i]) continue;
      const int a = A.body_a[i], b = A.body_b[i];
      if constexpr (kCached) {
        if (A.color[i] >= 0) continue;
        if (eligible(0, a, b)) claim(i, 0, a, b);
      } else {
        claim(i, 0, a, b);
      }
      pending = true;
    }
  if (__any_sync(0xffffffffu, pending) && leader) atomicMax(&s_stamp, 1);
  int run = 0;
  for (int r = 0; r < A.n_rounds; ++r) {
    cluster.sync();  // round r's claims are in
    // stamps only grow, and one >= r + 1 was written before this barrier if
    // any was, so every warp takes the same branch
    if (cluster_max(cluster, &s_stamp, nb) < r + 1) break;  // nothing was pending
    run = r + 1;
    const int h = A.hashes[r];
    const bool more = r + 1 < A.n_rounds;
    pending = false;
    for (int i = g; i < end; i += stride) {
      if (!A.valid[i] || A.color[i] >= 0) continue;
      const unsigned long long key = claim_key(r, i ^ h);
      const int a = A.body_a[i], b = A.body_b[i];
      const bool ok = eligible(r, a, b) && (!A.dyn[a] || holds(r, a, key)) &&
                      (!A.dyn[b] || holds(r, b, key));
      if (ok) {
        A.color[i] = r;
      } else if (more) {
        if (eligible(r + 1, a, b)) claim(i, r + 1, a, b);
        pending = true;
      }
    }
    if (__any_sync(0xffffffffu, pending) && leader) atomicMax(&s_stamp, r + 2);
  }
  if constexpr (kCached)
    if (threadIdx.x == 0 && cluster.block_rank() == 0) *A.rounds = run;
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// the cluster size of each instance, chosen at its first launch
int g_cluster[2] = {0, 0};

template <bool kCached>
int launch(const ColorArgs& A, void* stream) {
  cudaError_t err = choose_cluster(color_kernel<kCached>, kColorThreads, 0, &g_cluster[kCached]);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(g_cluster[kCached], kColorThreads, 0, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, color_kernel<kCached>, A);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nudge_color_rounds(const int* body_a, const int* body_b, const bool* valid,
                                  const bool* dyn, const int* hashes, int m, int n_bodies,
                                  int n_rounds, unsigned long long* claim, int* color,
                                  void* stream) {
  if (m <= 0) return 0;
  ColorArgs A{body_a, body_b, valid, dyn, hashes, m, n_bodies, n_rounds, claim, color,
              nullptr, 0, nullptr};
  return launch<false>(A, stream);
}

// The cached instance: `color` holds the cached colors (-1 where none, and
// wherever a manifold is not valid) and gets the raw colors; `mask` has
// room for n_bodies * words words, words = ceil((n_rounds + 1) / 32);
// `rounds` (one int) gets the number of rounds run.
extern "C" int nudge_color_rounds_cached(const int* body_a, const int* body_b,
                                         const bool* valid, const bool* dyn, const int* hashes,
                                         int m, int n_bodies, int n_rounds, int words,
                                         unsigned long long* claim, unsigned* mask, int* color,
                                         int* rounds, void* stream) {
  if (m <= 0) return 0;
  ColorArgs A{body_a, body_b, valid, dyn, hashes, m, n_bodies, n_rounds, claim, color,
              mask, words, rounds};
  return launch<true>(A, stream);
}
