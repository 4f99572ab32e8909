// Hand-written Hopper (sm_90a) kernels for the `tdigest` strategy's sketch
// builds: the per-row log-bucket histogram of the digest, and the per-row
// top-K multiset of the exact sketch. Built by nvcc into a shared library with
// a plain C interface and loaded with ctypes (krr_tpu_torch/ops/cuda_build.py);
// the wrappers, the input checks and the launch counters live in
// krr_tpu_torch/ops/cuda_sketch.py, the device helpers in common.cuh.
//
// Both kernels take row-major float32 matrices whose row i holds counts[i]
// valid samples, left-justified; positions at or past counts[i] (and past the
// width) are never read. They launch on the caller's stream, allocate
// nothing, and return cudaGetLastError().
//
// K3 digest_hist_kernel replaces krr_tpu/ops/pallas_sketch.py:_digest_kernel.
//   Same function as digest.bucketize + a per-row histogram + the running
//   peak over the valid prefix: bucket 0 for v <= min_value, else
//   1 + clip(floor(log(v / min_value) / log_gamma), 0, B - 2), in the
//   reference's float32 op order (__fdiv_rn, the accurate logf, floor), with
//   the clip done in float so NaN lands in bucket 1 and +inf in bucket B - 1,
//   as XLA's saturating float->int32 cast gives (a C++ cast of NaN or inf is
//   undefined). Counts are exact integers written as float32; the peak is
//   K2's NaN-propagating max, -inf for an empty row.
//   Bound: bytes (one read of the row, one write of the histogram). The TPU
//   kernel built the histogram as a one-hot product on the MXU; a shared
//   atomic per sample is the Hopper counterpart. What stood between the
//   formula route and the bound was the instruction count (two IEEE
//   divisions, an accurate logf, floor and the clips: some 55-60 instructions
//   a sample) and one 4-byte load in flight per thread. This design: the row
//   is read with common.cuh visit_row (16-byte loads, four in flight), and
//   the bucket comes from two int32 tables that krr_digest_tables builds on
//   the card once per spec (the wrapper keeps them per spec and device: a
//   build costs about a third of a streamed 8,192-column chunk's fold) with
//   digest_tables_kernel and the kernel's own bucket_index: the edge table
//   E[b], the smallest bit pattern whose bucket is >= b, found by bisection
//   over the patterns, and the coarse table, one entry per 2^16-pattern range
//   of (min_value, E[B - 1]). A range whose bucket steps at most once (every
//   range but the last at the default gamma = 1.01) packs its lower bucket
//   and the step's low 16 bits into its entry, so a sample costs a NaN test,
//   three compares and one shared-memory read before its atomic; the last
//   range, ranges with more steps (a smaller gamma) and B >= 2^15 walk up the
//   edge table instead. That equals the formula wherever the formula is
//   monotone in the bit pattern, which krr_digest_table_check proves over all
//   2^32 patterns on the card (chip_smoke.py digest_proof). One 256-thread
//   block per row keeps its B uint32 bins and both tables in shared memory
//   (39 KB at B = 2,560, so five blocks share an SM); past kHistSmemBytes the
//   same kernel counts into the row of the output itself, read as uint32,
//   converts it in place at the end, and reads the tables from global memory.
//   The peak is K2's key: NaN takes INT32_MAX, so one max reduction gives the
//   peak and the NaN flag. Idle rows (every sample in bucket 0, so each
//   warp's atomics hit one address) time below rows of spread values
//   (PERF.md), so the atomics are not aggregated.
//
// K4 topk_select_kernel replaces krr_tpu/ops/pallas_sketch.py:_topk_kernel
// (and its _stage_bits).
//   Same function: the top-min(K, n) multiset of the valid prefixes of the
//   chunk and the state, as ordered bits (max(v, 0) with NaN kept, as K1).
//   tau is max(b, 0) for b the (total - kv)-th smallest ordered bits in
//   signed order (kv = min(total, K)), which is what K1's 31-step bisection
//   gives; slots [0, c_gt) hold the survivors (bits > tau), [c_gt, kv)
//   copies of tau, [kv, K) -inf, each placed value the float of its ordered
//   bits. The TPU kernel premasked padding to INT32_MAX and so dropped a
//   valid sample whose bits are 0x7fffffff; this one skips positions past
//   the counts and keeps it.
//   Bound: bytes (one read of both prefixes, one write of the slots). This
//   design: one 1024-thread block per row. The row's head (chunk prefix,
//   then state prefix) is converted once into shared memory with 16-byte
//   loads. tau comes from common.cuh's radix select (cached_radix_select over
//   a CachedRow, shared with K1): four passes of 8-bit digits over the cached
//   head and the tail (streamed with 16-byte loads), against the 31 passes of
//   the bisection it replaces; the third pass keeps the keys that match the
//   top 16 bits in a shared buffer, and when they fit the fourth reads them
//   instead of the row. Then two more passes compact the survivors: each
//   thread counts its own, one block-wide scan (warp shuffles, then the 32
//   warp totals) gives each thread its first slot, and the second pass
//   places them in the same visit order, so the slot order is deterministic.
//   Shared memory: a 1,344-byte header (bin totals, pick, warp totals), the
//   32 KB lane-column histogram, 8 KB of candidates and a 184 KB cache of
//   47,104 ordered bits = 230,720 of the 232,448 bytes a block may use; a
//   120,960-sample row's 73,856-sample tail (61%) is read by five passes
//   (three digit passes and the two compaction passes). What bounds the
//   passes now is an open question (PERF.md). The TPU kernel's
//   rank matmul and three-piece bf16 split worked around the MXU and are not
//   needed here.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstring>

#include "common.cuh"

namespace {

using krr::block_reduce;
using krr::kCanonicalNan;
using krr::kExponentBits;
using krr::kInt32Max;
using krr::kInt32Min;
using krr::kMagnitudeMask;
using krr::kNegInfBits;

constexpr int kHistThreads = 256;
constexpr int kTableThreads = 256;
// Largest shared-memory footprint (bins, edge table, coarse table) K3 keeps
// on chip; past it all three live in global memory.
constexpr int kHistSmemBytes = 192 * 1024;
// The coarse table indexes a bit pattern by its top 16 bits; a packed entry
// holds a bucket in its top 15 bits, so B must stay below 2^15 for it.
constexpr int kCoarseShift = 16;
constexpr int kCoarseMask = (1 << kCoarseShift) - 1;
constexpr int kPackedBuckets = (1 << 15) - 1;
constexpr int kInfBits = 0x7f800000;

constexpr int kTopkThreads = 1024;
constexpr int kTopkWarps = kTopkThreads / 32;
// Shared-memory header: the radix select's bin totals and pick
// [0, kRadixPickInts), warp totals [264, 296), warp offsets [296, 328), the
// survivor count at [328]; padded to 16 bytes. The radix histogram follows,
// then the candidates, then the cache of krr::kRadixCacheInts ordered bits:
// 336 + 8,192 + 2,048 + 47,104 ints = 230,720 bytes, inside the 232,448
// bytes a block may use.
constexpr int kTopkWarpTotals = 264;
constexpr int kTopkHeaderInts = 336;
constexpr int kTopkFixedInts = kTopkHeaderInts + krr::kRadixHistInts + krr::kRadixCandidates;
static_assert(krr::kRadixPickInts <= kTopkWarpTotals, "header overlap");
static_assert((kTopkFixedInts + krr::kRadixCacheInts) * 4 <= 232448, "shared memory");
static_assert(kTopkFixedInts % 4 == 0, "the cache is 16-byte aligned");

__device__ __forceinline__ int bucket_index(float v, float min_value, float log_gamma, float top) {
  if (v <= min_value) return 0;  // also negatives, zeros and -inf; NaN goes on
  const float raw = floorf(__fdiv_rn(logf(__fdiv_rn(v, min_value)), log_gamma));
  float clipped = raw >= 0.0f ? raw : 0.0f;  // NaN -> 0
  clipped = clipped <= top ? clipped : top;  // +inf and overflow -> B - 2
  return 1 + static_cast<int>(clipped);
}

// The bucket of the float with bits `bits`, by the tables: edges[b] (b in
// [1, B)) is the smallest pattern whose bucket is >= b, edges[B - 1] the top
// edge; coarse[r] describes the range of patterns whose top 16 bits are
// base + r (the last entry also stands for every range past it). An entry
// >= 0 is (b << 16) | offset: the range's buckets are b + 1 from its low 16
// bits `offset` on and b below it (offset 0: all b + 1). An entry < 0 is ~b0,
// b0 the bucket of the range's first pattern above min_value: walk up the
// edges from there. The same answer as bucket_index wherever bucket_index is
// monotone in the pattern.
__device__ __forceinline__ int table_bucket(int bits, int min_bits, int top_edge, int last_bucket,
                                            const int* edges, const int* coarse, int base, int last_range) {
  if ((bits & kMagnitudeMask) > kExponentBits) return 1;  // NaN
  if (bits <= min_bits) return 0;  // v <= min_value: negatives and -0.0 are negative ints
  if (bits >= top_edge) return last_bucket;
  const int entry = coarse[min((bits >> kCoarseShift) - base, last_range)];
  if (entry >= 0) return (entry >> kCoarseShift) + ((bits & kCoarseMask) >= (entry & kCoarseMask));
  // min: a start above B - 2 would walk off the edges (only possible where
  // bucket_index is not monotone, which the check would report).
  int b = min(~entry, last_bucket - 1);
  while (bits >= edges[b + 1]) ++b;  // stops at edges[B - 1] = top_edge at the latest
  return b;
}

// Thread i < B writes edges[i] (edges[0] = INT32_MIN, unread): a bisection
// over [min_bits + 1, +inf], whose bucket is B - 1. Thread B + r writes
// coarse[r] from the buckets at the ends of range r and, when they differ by
// one, a bisection inside it for the step. At most 31 bucket_index calls.
__global__ void __launch_bounds__(kTableThreads)
digest_tables_kernel(int* __restrict__ tables, int num_buckets, int base, int coarse_len, float min_value,
                     float log_gamma) {
  const int i = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const float top = static_cast<float>(num_buckets - 2);
  const int first = __float_as_int(min_value) + 1;
  const auto bucket = [&](int bits) { return bucket_index(__int_as_float(bits), min_value, log_gamma, top); };
  if (i == 0) {
    tables[0] = kInt32Min;
  } else if (i < num_buckets) {
    int lo = first;
    int hi = kInfBits;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (bucket(mid) >= i) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    tables[i] = lo;
  } else if (i < num_buckets + coarse_len) {
    const int r = i - num_buckets;
    const int start = (base + r) << kCoarseShift;
    const int lo_end = max(start, first);
    const int hi_end = min(start + kCoarseMask, kInfBits);
    const int b0 = bucket(lo_end);
    const int b_end = bucket(hi_end);
    int entry = ~b0;  // walk: the last range, a bucket too large to pack, or more than one step
    if (r < coarse_len - 1 && num_buckets <= kPackedBuckets && b_end <= b0 + 1) {
      entry = (b0 - 1) << kCoarseShift;  // offset 0: the whole range is b0
      if (b_end == b0 + 1) {
        int lo = lo_end + 1;  // the first pattern of bucket b0 + 1
        int hi = hi_end;
        while (lo < hi) {
          const int mid = lo + ((hi - lo) >> 1);
          if (bucket(mid) > b0) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        entry = (b0 << kCoarseShift) | (lo - start);
      }
    }
    tables[i] = entry;
  }
}

// kShared: the bins and the tables in shared memory (the tables copied in
// from `tables`); otherwise the bins are the output row and the tables are
// read where they are.
template <bool kShared>
__global__ void __launch_bounds__(kHistThreads)
digest_hist_kernel(const float* __restrict__ values, const int* __restrict__ counts, float* hist,
                   float* __restrict__ peak, const int* __restrict__ tables, long long t, int num_buckets,
                   int base, int coarse_len, float min_value) {
  extern __shared__ __align__(16) unsigned smem_bins[];
  __shared__ int scratch[33];
  const long long row = blockIdx.x;
  float* out = hist + row * num_buckets;
  const int tid = static_cast<int>(threadIdx.x);
  const int stride = static_cast<int>(blockDim.x);
  unsigned* bins;
  const int* edges;
  if constexpr (kShared) {
    bins = smem_bins;
    int* shared_tables = reinterpret_cast<int*>(smem_bins + num_buckets);
    for (int i = tid; i < num_buckets + coarse_len; i += stride) shared_tables[i] = tables[i];
    edges = shared_tables;
  } else {
    bins = reinterpret_cast<unsigned*>(out);
    edges = tables;
  }
  const int* coarse = edges + num_buckets;
  for (int b = tid; b < num_buckets; b += stride) bins[b] = 0u;
  __syncthreads();

  const int valid = static_cast<int>(min(static_cast<long long>(max(counts[row], 0)), t));
  const int min_bits = __float_as_int(min_value);
  const int top_edge = edges[num_buckets - 1];
  const int last_range = coarse_len - 1;
  int best = kInt32Min;  // below every key of a valid sample
  krr::visit_row(values + row * t, 0, valid, tid, stride, [&](int, float x) {
    const int b = table_bucket(__float_as_int(x), min_bits, top_edge, num_buckets - 1, edges, coarse, base,
                               last_range);
    atomicAdd(&bins[b], 1u);
    best = max(best, krr::nan_high_max_key(x));
  });
  best = block_reduce<false>(best, scratch);  // its barriers also order the bins
  for (int b = tid; b < num_buckets; b += stride) out[b] = static_cast<float>(bins[b]);
  if (tid == 0) {
    peak[row] = valid == 0           ? __uint_as_float(kNegInfBits)
                : best == kInt32Max ? __uint_as_float(kCanonicalNan)
                                    : krr::from_max_key(best);
  }
}

// The proof behind the tables: bucket_index and table_bucket on every one of
// the 2^32 bit patterns. result[0] += the patterns where they differ,
// result[1] = the smallest such pattern (as unsigned; start it at ~0).
__global__ void __launch_bounds__(kTableThreads)
digest_table_check_kernel(const int* __restrict__ tables, unsigned long long* result, int num_buckets, int base,
                          int coarse_len, float min_value, float log_gamma) {
  const float top = static_cast<float>(num_buckets - 2);
  const int min_bits = __float_as_int(min_value);
  const int* coarse = tables + num_buckets;
  const int top_edge = tables[num_buckets - 1];
  unsigned long long mismatches = 0;
  unsigned long long first = ~0ull;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const int bits = static_cast<int>(static_cast<unsigned>(i));
    const int want = bucket_index(__int_as_float(bits), min_value, log_gamma, top);
    const int got = table_bucket(bits, min_bits, top_edge, num_buckets - 1, tables, coarse, base, coarse_len - 1);
    if (want != got) {
      ++mismatches;
      first = min(first, i);
    }
  }
  if (mismatches) {
    atomicAdd(&result[0], mismatches);
    atomicMin(&result[1], first);
  }
}

__global__ void __launch_bounds__(kTopkThreads)
topk_select_kernel(const float* __restrict__ values, const int* __restrict__ counts,
                   const float* __restrict__ state, const int* __restrict__ state_counts,
                   float* __restrict__ out, long long t, long long s, int k, int cache_cap) {
  extern __shared__ __align__(16) int smem[];
  int* pick = smem;
  int* warp_totals = smem + kTopkWarpTotals;
  int* warp_offsets = warp_totals + 32;
  int* survivors = warp_offsets + 32;
  int* hist = smem + kTopkHeaderInts;
  int* candidates = hist + krr::kRadixHistInts;
  int* cache = smem + kTopkFixedInts;

  const long long row = blockIdx.x;
  const int c = static_cast<int>(min(static_cast<long long>(max(counts[row], 0)), t));
  const int sc = s > 0 ? static_cast<int>(min(static_cast<long long>(max(state_counts[row], 0)), s)) : 0;
  const int total = c + sc;  // the wrapper keeps t + s below 2^31
  const int kv = min(total, k);
  const float* __restrict__ v = values + row * t;
  const float* __restrict__ st = state + row * s;
  float* __restrict__ o = out + row * static_cast<long long>(k);
  // Signed loop strides: `p += blockDim.x` (unsigned) makes an int induction
  // wrap-around arithmetic, nvcc then cannot count the trips, and each thread
  // keeps one load in flight instead of four (half K1's speed; PERF.md).
  const int tid = static_cast<int>(threadIdx.x);
  const int stride = static_cast<int>(blockDim.x);
  if (total == 0) {
    for (int slot = tid; slot < k; slot += stride) o[slot] = __uint_as_float(kNegInfBits);
    return;
  }
  // Position p of the row is chunk[p] for p < c, else state[p - c]; the
  // cache holds positions [0, keys.cached), the tail the rest of both
  // prefixes.
  const krr::CachedRow keys(v, c, st, sc, cache_cap);
  const int tau = krr::cached_radix_select(keys, cache, total - kv, hist, pick, candidates);

  // Compact the survivors (bits > tau) into slots [0, c_gt): count each
  // thread's survivors over the keys it visits (the cache, then the tail),
  // scan the counts across the block (warp shuffles, then the 32 warp
  // totals), and place them in a second pass over the same keys in the same
  // order, so the slot order is deterministic, with two barriers per row.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int mine = 0;
  const auto count = [&](int bits) { mine += bits > tau; };
  krr::visit_cache(cache, keys.cached, count);
  keys.visit_tail(count);
  int inclusive = mine;
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int other = __shfl_up_sync(0xffffffffu, inclusive, offset);
    if (lane >= offset) inclusive += other;
  }
  if (lane == 31) warp_totals[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kTopkWarps ? warp_totals[lane] : 0;
    int warps_inclusive = own;
    for (int offset = 1; offset < 32; offset <<= 1) {
      const int other = __shfl_up_sync(0xffffffffu, warps_inclusive, offset);
      if (lane >= offset) warps_inclusive += other;
    }
    warp_offsets[lane] = warps_inclusive - own;
    if (lane == 31) *survivors = warps_inclusive;
  }
  __syncthreads();
  int slot = warp_offsets[warp] + inclusive - mine;
  const auto place = [&](int bits) {
    if (bits > tau) {
      if (slot < k) o[slot] = __int_as_float(bits);
      ++slot;
    }
  };
  krr::visit_cache(cache, keys.cached, place);
  keys.visit_tail(place);
  const int c_gt = *survivors;
  for (int slot = c_gt + tid; slot < k; slot += stride) {
    o[slot] = slot < kv ? __int_as_float(tau) : __uint_as_float(kNegInfBits);
  }
}

// The tables' extent for a spec: the coarse table spans the 2^16-pattern
// ranges from the first pattern above min_value to the top edge, estimated
// here in double with a margin. An estimate off either way only costs time:
// a pattern past the last range reads the last entry and walks up the edges.
struct TableShape {
  int base;
  int coarse_len;
};

TableShape table_shape(int num_buckets, float min_value, float log_gamma) {
  int min_bits;
  std::memcpy(&min_bits, &min_value, sizeof min_bits);
  const int base = (min_bits + 1) >> kCoarseShift;
  const double top = static_cast<double>(min_value) * std::exp(static_cast<double>(log_gamma) * (num_buckets - 2));
  int top_bits = kInfBits;
  if (top * 1.00001 < static_cast<double>(FLT_MAX)) {
    const float top32 = static_cast<float>(top * 1.00001);
    std::memcpy(&top_bits, &top32, sizeof top_bits);
  }
  const int last = std::min(top_bits, kInfBits) >> kCoarseShift;
  return {base, std::max(last - base + 1, 1)};
}

cudaError_t build_tables(int* tables, int num_buckets, TableShape shape, float min_value, float log_gamma,
                         cudaStream_t stream) {
  const int threads = num_buckets + shape.coarse_len;
  digest_tables_kernel<<<(threads + kTableThreads - 1) / kTableThreads, kTableThreads, 0, stream>>>(
      tables, num_buckets, shape.base, shape.coarse_len, min_value, log_gamma);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of scratch krr_digest_tables and krr_digest_table_check need for the
// tables of a spec (min_value and log_gamma positive and finite, B >= 2).
int krr_digest_table_ints(int num_buckets, float min_value, float log_gamma) {
  return num_buckets + table_shape(num_buckets, min_value, log_gamma).coarse_len;
}

// Builds the tables of a spec into `tables`, which krr_digest_hist reads.
int krr_digest_tables(int* tables, int num_buckets, float min_value, float log_gamma, void* stream) {
  return static_cast<int>(build_tables(tables, num_buckets, table_shape(num_buckets, min_value, log_gamma),
                                       min_value, log_gamma, static_cast<cudaStream_t>(stream)));
}

// `tables` holds the spec's tables, built by krr_digest_tables.
int krr_digest_hist(const float* values, const int* counts, float* hist, float* peak, const int* tables, int n,
                    long long t, int num_buckets, float min_value, float log_gamma, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TableShape shape = table_shape(num_buckets, min_value, log_gamma);
  const long long smem = (2LL * num_buckets + shape.coarse_len) * static_cast<long long>(sizeof(int));
  if (smem <= kHistSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(digest_hist_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    digest_hist_kernel<true><<<n, kHistThreads, static_cast<int>(smem), s>>>(
        values, counts, hist, peak, tables, t, num_buckets, shape.base, shape.coarse_len, min_value);
  } else {
    digest_hist_kernel<false><<<n, kHistThreads, 0, s>>>(values, counts, hist, peak, tables, t, num_buckets,
                                                          shape.base, shape.coarse_len, min_value);
  }
  return static_cast<int>(cudaGetLastError());
}

// Builds the tables of a spec into `tables` and checks them against
// bucket_index on all 2^32 bit patterns: result[0] mismatches, result[1] the
// smallest mismatching pattern (set result to {0, ~0} first).
int krr_digest_table_check(int* tables, unsigned long long* result, int num_buckets, float min_value,
                           float log_gamma, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TableShape shape = table_shape(num_buckets, min_value, log_gamma);
  cudaError_t err = build_tables(tables, num_buckets, shape, min_value, log_gamma, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  digest_table_check_kernel<<<132 * 16, kTableThreads, 0, s>>>(tables, result, num_buckets, shape.base,
                                                                shape.coarse_len, min_value, log_gamma);
  return static_cast<int>(cudaGetLastError());
}

int krr_topk_select(const float* values, const int* counts, const float* state, const int* state_counts,
                    float* out, int n, long long t, long long s, int k, void* stream) {
  if (n <= 0) return 0;
  const long long width = t + s;
  const int cache_cap = static_cast<int>(width < krr::kRadixCacheInts ? width : krr::kRadixCacheInts);
  const int smem_bytes = (kTopkFixedInts + cache_cap) * static_cast<int>(sizeof(int));
  cudaError_t err =
      cudaFuncSetAttribute(topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_select_kernel<<<n, kTopkThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      values, counts, state, state_counts, out, t, s, k, cache_cap);
  return static_cast<int>(cudaGetLastError());
}

// The cache size, so a test can put the cache edge where it wants it.
int krr_topk_cache_ints(void) { return krr::kRadixCacheInts; }

const char* krr_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
