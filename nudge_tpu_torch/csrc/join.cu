// The warm-start cache's joins as one hash join: for each current row, the
// payload of the cache row with the same key, or zeros.
//
// Replaces no TPU kernel: the reference joins with XLA's sort
// (nudge_tpu/ops/cache.py _join and join_i32, a 4-key lax.sort of both
// sides together), and the port's plain twins (ops/cache.py _join_plain,
// join_i32_plain) keep that sort-merge join as chained stable radix sorts,
// gathers, rolls and a scatter back. This kernel serves both joins:
// read_cached_impulses (key (ga, gb, feat), the impulse and pseudo
// payload) and the cached coloring's join of last step's colors (the same
// key with feat 0, or the one-word key ga * n_gids + gb).
//
// The contract is the twins' on any input. A row's key is its key where it
// is valid and a sentinel where not ((INT_MAX, INT_MAX, INT_MAX); 2^30 - 1
// for the one-word key, whose twin sorts key * 2 (+ 1 for a current row) in
// int32, so two words are one key where their low 31 bits agree). Current
// row r gets the payload of cache row c iff r is valid, c is the
// highest-indexed cache row with r's key and r is the lowest-indexed
// current row with that key, valid or not; else zeros. That is the stable
// sort's rule: a key's first current row follows the key's last cache row,
// every later current row follows a current row. The output is a pure
// gather of 32-bit words, so it is the twins' bit for bit.
//
// Design. One int32 open-addressing table a side, 2^k >= 2 x its rows
// slots (at most half full: a probe always ends), reset to -1 by a first
// launch inside the call. Insert launch: each row whose key is not the sentinel
// hashes it and probes linearly; it claims an empty slot by atomicCAS, and
// a slot that holds a row names its key (a slot only ever holds rows of
// one key), which the row compares by reading that row's key. On equal
// keys the cache table keeps the higher row (atomicMax), the current table
// the lower (atomicMin). Sentinel-keyed rows (the invalid ones, and any
// valid row that carries the sentinel's key) are not inserted: the highest
// such cache row and the lowest such current row are reduced over each
// block and then across blocks by one atomic a block into two ints. Probe
// launch: each valid current row finds its key's winner in the current
// table, and if it is the row itself, its key's row in the cache table,
// reading the key's run to its end;
// it writes the payload words (zeros on a miss or an invalid row) and,
// where a payload requires grad, the current row each matched cache row
// went to (`back`, -1 elsewhere: the reset sets it), through which the
// wrapper's backward gathers the output adjoints. With
// `counts` (tracing on) the probe launch adds the valid rows that found a
// cache row and the cache-table slots read into counts[0] and counts[1].
//
// What bounds it on an H100: the bytes of the live rows (a key of 12 B and
// a payload of 16 B a live cache row, a key a live current row, a payload
// written for every current row; at config 5's chunk ~27 MB, ~8 us at
// 3.35 TB/s) and the tables' reset (2 x 16 MB there); the atomics and the
// probes are random 4-byte accesses into tables that stay in L2.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kJoinThreads = 256;
constexpr int kJoinMaxBlocks = 2048;
constexpr int kWordSentinel = (1 << 30) - 1;
constexpr int kPayloads = 2;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) { return (x << r) | (x >> (32 - r)); }

// murmur3's block mix and finaliser
__device__ __forceinline__ unsigned mix_in(unsigned h, int word) {
  unsigned w = (unsigned)word * 0xcc9e2d51u;
  w = rotl(w, 15) * 0x1b873593u;
  h = rotl(h ^ w, 13);
  return h * 5u + 0xe6546b64u;
}
__device__ __forceinline__ unsigned fmix(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

// _join's key. A side's ga and gb are read once per `div` rows:
// read_cached_impulses hands a manifold's pair for each of its points.
struct Tri {
  int ga, gb, feat;
  __device__ bool operator==(const Tri& o) const {
    return ga == o.ga && gb == o.gb && feat == o.feat;
  }
  __device__ unsigned hash() const { return fmix(mix_in(mix_in(mix_in(0u, ga), gb), feat)); }
  static __device__ Tri sentinel() { return {INT_MAX, INT_MAX, INT_MAX}; }
};

struct TriRows {
  const int* ga;
  const int* gb;
  const int* feat;
  const bool* valid;
  int div;
  using Key = Tri;
  __device__ Tri raw(int i) const {
    const int m = div == 1 ? i : i / div;
    return {ga[m], gb[m], feat[i]};
  }
};

// join_i32's key: the word's low 31 bits, sign-extended
struct Word {
  int k;
  __device__ bool operator==(const Word& o) const { return k == o.k; }
  __device__ unsigned hash() const { return fmix(mix_in(0u, k)); }
  static __device__ Word sentinel() { return {kWordSentinel}; }
};

struct WordRows {
  const int* key;
  const bool* valid;
  using Key = Word;
  __device__ Word raw(int i) const { return {(int)((unsigned)key[i] << 1) >> 1}; }
};

template <class Rows>
__device__ __forceinline__ typename Rows::Key key_of(const Rows& R, int i) {
  return R.valid[i] ? R.raw(i) : Rows::Key::sentinel();
}

struct Table {
  int* slot;
  unsigned mask;
};

template <class Rows>
struct JoinArgs {
  Rows cache, cur;
  int n_cache, n_cur;
  Table ctab, ktab;
  int* sent_c;        // the highest sentinel-keyed cache row (-1: none)
  unsigned* sent_k;   // the lowest sentinel-keyed current row (UINT_MAX: none)
  const unsigned* src[kPayloads];  // [n_cache, width] words, or null
  unsigned* dst[kPayloads];        // [n_cur, width] words, or null
  int width[kPayloads];
  int* back;          // [n_cache] the current row a cache row went to, or null
  int* counts;        // [hits, probes], or null
};

// Row i of `R` with key k (not the sentinel) into T: a claimed slot keeps
// the higher row (kMax) or the lower.
template <bool kMax, class Rows>
__device__ void insert(const Rows& R, Table T, int i, typename Rows::Key k) {
  unsigned s = k.hash() & T.mask;
  for (;;) {
    int v = __ldcg(T.slot + s);
    if (v < 0) {
      v = atomicCAS(T.slot + s, -1, i);
      if (v < 0) return;
    }
    if (R.raw(v) == k) {
      if (kMax)
        atomicMax(T.slot + s, i);
      else
        atomicMin(T.slot + s, i);
      return;
    }
    s = (s + 1) & T.mask;
  }
}

template <class Rows>
__global__ void __launch_bounds__(kJoinThreads) join_insert_kernel(JoinArgs<Rows> A) {
  using Key = typename Rows::Key;
  __shared__ int s_cmax;
  __shared__ unsigned s_kmin;
  if (threadIdx.x == 0) {
    s_cmax = -1;
    s_kmin = UINT_MAX;
  }
  __syncthreads();
  int cmax = -1;
  unsigned kmin = UINT_MAX;
  const long long n = (long long)A.n_cache + A.n_cur;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    if (t < A.n_cache) {
      const int i = (int)t;
      const Key k = key_of(A.cache, i);
      if (k == Key::sentinel())
        cmax = i;  // a thread's rows only grow
      else
        insert<true>(A.cache, A.ctab, i, k);
    } else {
      const int i = (int)(t - A.n_cache);
      const Key k = key_of(A.cur, i);
      if (k == Key::sentinel())
        kmin = min(kmin, (unsigned)i);
      else
        insert<false>(A.cur, A.ktab, i, k);
    }
  }
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  if ((threadIdx.x & 31) == 0) {
    if (cmax >= 0) atomicMax(&s_cmax, cmax);
    if (kmin != UINT_MAX) atomicMin(&s_kmin, kmin);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_cmax >= 0) atomicMax(A.sent_c, s_cmax);
    if (s_kmin != UINT_MAX) atomicMin(A.sent_k, s_kmin);
  }
}

template <class Rows>
__global__ void __launch_bounds__(kJoinThreads) join_probe_kernel(JoinArgs<Rows> A) {
  using Key = typename Rows::Key;
  int hits = 0, probes = 0;
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < A.n_cur; r += stride) {
    int c = -1;
    if (A.cur.valid[r]) {
      const Key k = A.cur.raw(r);
      if (k == Key::sentinel()) {
        if (*A.sent_k == (unsigned)r) c = *A.sent_c;
      } else {
        // the key's winner among the current rows (r inserted it: found)
        unsigned s = k.hash() & A.ktab.mask;
        int w = A.ktab.slot[s];
        while (w != r && !(A.cur.raw(w) == k)) {
          s = (s + 1) & A.ktab.mask;
          w = A.ktab.slot[s];
        }
        if (w == r) {
          // the key's run, from its home slot to the first empty one: a
          // key's slot within its run depends on the order of the inserts,
          // the run's length does not (linear probing fills the same slots
          // in any order), so the slots read are the same in every launch
          s = k.hash() & A.ctab.mask;
          for (;;) {
            const int v = A.ctab.slot[s];
            ++probes;
            if (v < 0) break;
            if (c < 0 && A.cache.raw(v) == k) c = v;
            s = (s + 1) & A.ctab.mask;
          }
        }
      }
      hits += c >= 0;
    }
    if (A.back && c >= 0) A.back[c] = r;  // a cache row goes to one row at most
#pragma unroll
    for (int p = 0; p < kPayloads; ++p) {
      if (!A.dst[p]) continue;
      const int wd = A.width[p];
      unsigned* out = A.dst[p] + (long long)r * wd;
      const unsigned* in = A.src[p] + (long long)c * wd;
      for (int j = 0; j < wd; ++j) out[j] = c >= 0 ? in[j] : 0u;
    }
  }
  if (A.counts) {  // summed over the warp, then the block: an atomic a block
    __shared__ int s_counts[2];
    if (threadIdx.x < 2) s_counts[threadIdx.x] = 0;
    __syncthreads();
    hits = __reduce_add_sync(0xffffffffu, hits);
    probes = __reduce_add_sync(0xffffffffu, probes);
    if ((threadIdx.x & 31) == 0 && (hits || probes)) {
      atomicAdd(&s_counts[0], hits);
      atomicAdd(&s_counts[1], probes);
    }
    __syncthreads();
    if (threadIdx.x == 0 && (s_counts[0] || s_counts[1])) {
      atomicAdd(A.counts, s_counts[0]);
      atomicAdd(A.counts + 1, s_counts[1]);
    }
  }
}

// Every slot of both tables, sent_c, sent_k and `back` (if any) to -1 (all
// bits set), and the counts to 0: a kernel, so the call adds no memset
// node to a graph.
__global__ void __launch_bounds__(kJoinThreads) join_reset_kernel(int4* table, int n4, int* tail,
                                                                  int* back, int n_back,
                                                                  int* counts) {
  const int4 none = make_int4(-1, -1, -1, -1);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) table[i] = none;
  if (back)
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_back; i += stride) back[i] = -1;
  if (blockIdx.x == 0 && threadIdx.x < 2) {
    tail[threadIdx.x] = -1;
    if (counts) counts[threadIdx.x] = 0;
  }
}

int blocks_for(long long n) {
  const long long b = (n + kJoinThreads - 1) / kJoinThreads;
  return (int)(b < 1 ? 1 : (b > kJoinMaxBlocks ? kJoinMaxBlocks : b));
}

// `table` holds slots_c + slots_k + 2 ints: the cache table, the current
// table, sent_c and sent_k. Both slot counts are powers of two >= 4, and
// `table` is 16-byte aligned.
template <class Rows>
int launch(JoinArgs<Rows> A, int* table, int slots_c, int slots_k, const unsigned* const* src,
           unsigned* const* dst, const int* width, void* stream) {
  if (A.n_cur <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  A.ctab = Table{table, (unsigned)slots_c - 1u};
  A.ktab = Table{table + slots_c, (unsigned)slots_k - 1u};
  A.sent_c = table + slots_c + slots_k;
  A.sent_k = (unsigned*)(table + slots_c + slots_k + 1);
  for (int p = 0; p < kPayloads; ++p) {
    A.src[p] = src[p];
    A.dst[p] = dst[p];
    A.width[p] = width[p];
  }
  const int n4 = (slots_c + slots_k) / 4;
  join_reset_kernel<<<blocks_for(n4), kJoinThreads, 0, st>>>(
      (int4*)table, n4, table + slots_c + slots_k, A.back, A.n_cache, A.counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  join_insert_kernel<Rows>
      <<<blocks_for((long long)A.n_cache + A.n_cur), kJoinThreads, 0, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  join_probe_kernel<Rows><<<blocks_for(A.n_cur), kJoinThreads, 0, st>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

// _join: keys (ga, gb, feat) a side; the current side's ga and gb hold one
// entry per `div` rows. Up to two payloads (src_p [n_cache, w_p] 32-bit
// words into dst_p [n_cur, w_p]; w_p 0 or a null dst: none); `back`
// (null: none) gets for each cache row the current row it went to, or -1;
// `counts` (null: none) gets [hits, probes].
extern "C" int nudge_join3(const int* c_ga, const int* c_gb, const int* c_feat,
                           const bool* c_valid, int n_cache, const int* k_ga, const int* k_gb,
                           const int* k_feat, const bool* k_valid, int n_cur, int div, int* table,
                           int slots_c, int slots_k, const unsigned* src0, unsigned* dst0, int w0,
                           const unsigned* src1, unsigned* dst1, int w1, int* back, int* counts,
                           void* stream) {
  JoinArgs<TriRows> A{};
  A.cache = TriRows{c_ga, c_gb, c_feat, c_valid, 1};
  A.cur = TriRows{k_ga, k_gb, k_feat, k_valid, div};
  A.n_cache = n_cache;
  A.n_cur = n_cur;
  A.back = back;
  A.counts = counts;
  const unsigned* src[kPayloads] = {src0, src1};
  unsigned* dst[kPayloads] = {w0 > 0 ? dst0 : nullptr, w1 > 0 ? dst1 : nullptr};
  const int width[kPayloads] = {w0, w1};
  return launch(A, table, slots_c, slots_k, src, dst, width, stream);
}

// join_i32: one int32 key a row; the rest as nudge_join3.
extern "C" int nudge_join1(const int* c_key, const bool* c_valid, int n_cache, const int* k_key,
                           const bool* k_valid, int n_cur, int* table, int slots_c, int slots_k,
                           const unsigned* src0, unsigned* dst0, int w0, const unsigned* src1,
                           unsigned* dst1, int w1, int* back, int* counts, void* stream) {
  JoinArgs<WordRows> A{};
  A.cache = WordRows{c_key, c_valid};
  A.cur = WordRows{k_key, k_valid};
  A.n_cache = n_cache;
  A.n_cur = n_cur;
  A.back = back;
  A.counts = counts;
  const unsigned* src[kPayloads] = {src0, src1};
  unsigned* dst[kPayloads] = {w0 > 0 ? dst0 : nullptr, w1 > 0 ? dst1 : nullptr};
  const int width[kPayloads] = {w0, w1};
  return launch(A, table, slots_c, slots_k, src, dst, width, stream);
}
