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
//   Bound: bytes at the default B = 2,560 (one read of the row, one write of
//   the histogram), with ~20 float32 operations per sample for the log close
//   behind. The TPU kernel built the histogram as a one-hot product on the
//   MXU; here one block per row keeps its B uint32 bins in shared memory
//   (10 KB at B = 2,560, so several blocks share an SM) and fills them with
//   shared-memory atomics from coalesced strided loads. When 4 B bytes exceed
//   kHistSmemBuckets the same kernel counts into the row of the output itself,
//   read as uint32, and converts it in place at the end.
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
//   loads. tau comes from common.cuh's radix select: four passes of 8-bit
//   digits over the cached head and the tail (streamed with 16-byte loads),
//   against the 31 passes of the bisection it replaces. Then two more
//   passes compact the survivors: each thread counts
//   its own, one block-wide scan (warp shuffles, then the 32 warp totals)
//   gives each thread its first slot, and the second pass places them in the
//   same visit order, so the slot order is deterministic. Shared memory: a
//   1,344-byte header (bin totals, pick, warp totals), the 32 KB lane-column
//   histogram and a 192 KB cache of 49,152 ordered bits = 230,720 of the
//   232,448 bytes a block may use; the histogram took 8K ints from the
//   bisection's cache, so a 120,960-sample row re-reads a 71,808-sample tail
//   (59%, against 63,616) on each of the five passes after the first. What
//   bounds the passes now is an open question (PERF.md). The TPU kernel's
//   rank matmul and three-piece bf16 split worked around the MXU and are not
//   needed here.

#include "common.cuh"

namespace {

using krr::block_reduce;
using krr::kCanonicalNan;
using krr::kExponentBits;
using krr::kInt32Min;
using krr::kMagnitudeMask;
using krr::kNegInfBits;
using krr::ordered_bits;

constexpr int kHistThreads = 256;
// Largest bucket count whose bins K3 keeps in shared memory (192 KB).
constexpr int kHistSmemBuckets = 48 * 1024;

constexpr int kTopkThreads = 1024;
constexpr int kTopkWarps = kTopkThreads / 32;
// Shared-memory header: the radix select's bin totals and pick
// [0, kRadixPickInts), warp totals [264, 296), warp offsets [296, 328), the
// survivor count at [328]; padded to 16 bytes. The radix histogram follows,
// then the cache.
constexpr int kTopkWarpTotals = 264;
constexpr int kTopkHeaderInts = 336;
// Ordered bits of a row's head kept in shared memory: 336 + 8,192 + 49,152
// ints = 230,720 bytes, inside the 232,448 bytes a block may use.
constexpr int kTopkCacheInts = 48 * 1024;
static_assert(krr::kRadixPickInts <= kTopkWarpTotals, "header overlap");
static_assert((kTopkHeaderInts + krr::kRadixHistInts + kTopkCacheInts) * 4 <= 232448, "shared memory");

__device__ __forceinline__ int bucket_index(float v, float min_value, float log_gamma, float top) {
  if (v <= min_value) return 0;  // also negatives, zeros and -inf; NaN goes on
  const float raw = floorf(__fdiv_rn(logf(__fdiv_rn(v, min_value)), log_gamma));
  float clipped = raw >= 0.0f ? raw : 0.0f;  // NaN -> 0
  clipped = clipped <= top ? clipped : top;  // +inf and overflow -> B - 2
  return 1 + static_cast<int>(clipped);
}

__global__ void __launch_bounds__(kHistThreads)
digest_hist_kernel(const float* __restrict__ values, const int* __restrict__ counts, float* hist,
                   float* __restrict__ peak, long long t, int num_buckets, float min_value, float log_gamma,
                   int bins_in_smem) {
  extern __shared__ unsigned smem_bins[];
  __shared__ int scratch[33];
  const long long row = blockIdx.x;
  float* out = hist + row * num_buckets;
  unsigned* bins = bins_in_smem ? smem_bins : reinterpret_cast<unsigned*>(out);
  const int tid = static_cast<int>(threadIdx.x);
  const int stride = static_cast<int>(blockDim.x);
  for (int b = tid; b < num_buckets; b += stride) bins[b] = 0u;
  __syncthreads();

  const long long valid = min(static_cast<long long>(max(counts[row], 0)), t);
  const float* __restrict__ v = values + row * t;
  const float top = static_cast<float>(num_buckets - 2);
  int best = kInt32Min;  // below every key of a non-NaN value
  int saw_nan = 0;
  for (long long i = tid; i < valid; i += stride) {
    const float x = v[i];
    atomicAdd(&bins[bucket_index(x, min_value, log_gamma, top)], 1u);
    const int bits = __float_as_int(x);
    if ((bits & kMagnitudeMask) > kExponentBits) {
      saw_nan = 1;
    } else {
      best = max(best, krr::max_key(bits));
    }
  }
  best = block_reduce<false>(best, scratch);
  saw_nan = block_reduce<false>(saw_nan, scratch);  // its barriers also order the bins
  for (int b = tid; b < num_buckets; b += stride) out[b] = static_cast<float>(bins[b]);
  if (threadIdx.x == 0) {
    peak[row] = valid <= 0 ? __uint_as_float(kNegInfBits)
                : saw_nan  ? __uint_as_float(kCanonicalNan)
                           : krr::from_max_key(best);
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
  int* cache = hist + krr::kRadixHistInts;

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
  // cache holds positions [0, cached), the tail the rest of both prefixes.
  const int cached = min(total, cache_cap);
  const int chunk_tail = min(cached, c);
  const int state_tail = cached - chunk_tail;
  krr::visit_row(v, 0, chunk_tail, tid, stride, [&](int p, float x) { cache[p] = ordered_bits(x); });
  krr::visit_row(st, 0, state_tail, tid, stride, [&](int p, float x) { cache[c + p] = ordered_bits(x); });
  __syncthreads();

  const auto visit_tail = [=](auto&& f) {
    const auto key = [&](int, float x) { f(ordered_bits(x)); };
    krr::visit_row(v, chunk_tail, c, tid, stride, key);
    krr::visit_row(st, state_tail, sc, tid, stride, key);
  };
  const int tau = krr::radix_select_ordered(cache, cached, visit_tail, total - kv, hist, pick);

  // Compact the survivors (bits > tau) into slots [0, c_gt): count each
  // thread's survivors over the keys it visits (the cache, then the tail),
  // scan the counts across the block (warp shuffles, then the 32 warp
  // totals), and place them in a second pass over the same keys in the same
  // order, so the slot order is deterministic, with two barriers per row.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int mine = 0;
  const auto count = [&](int bits) { mine += bits > tau; };
  krr::visit_cache(cache, cached, count);
  visit_tail(count);
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
  krr::visit_cache(cache, cached, place);
  visit_tail(place);
  const int c_gt = *survivors;
  for (int slot = c_gt + tid; slot < k; slot += stride) {
    o[slot] = slot < kv ? __int_as_float(tau) : __uint_as_float(kNegInfBits);
  }
}

}  // namespace

extern "C" {

int krr_digest_hist(const float* values, const int* counts, float* hist, float* peak, int n, long long t,
                    int num_buckets, float min_value, float log_gamma, void* stream) {
  if (n <= 0) return 0;
  const int bins_in_smem = num_buckets <= kHistSmemBuckets ? 1 : 0;
  const int smem_bytes = bins_in_smem ? num_buckets * static_cast<int>(sizeof(unsigned)) : 0;
  cudaError_t err =
      cudaFuncSetAttribute(digest_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  digest_hist_kernel<<<n, kHistThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      values, counts, hist, peak, t, num_buckets, min_value, log_gamma, bins_in_smem);
  return static_cast<int>(cudaGetLastError());
}

int krr_topk_select(const float* values, const int* counts, const float* state, const int* state_counts,
                    float* out, int n, long long t, long long s, int k, void* stream) {
  if (n <= 0) return 0;
  const long long width = t + s;
  const int cache_cap = static_cast<int>(width < kTopkCacheInts ? width : kTopkCacheInts);
  const int smem_bytes = (kTopkHeaderInts + krr::kRadixHistInts + cache_cap) * static_cast<int>(sizeof(int));
  cudaError_t err =
      cudaFuncSetAttribute(topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_select_kernel<<<n, kTopkThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      values, counts, state, state_counts, out, t, s, k, cache_cap);
  return static_cast<int>(cudaGetLastError());
}

// The cache size, so a test can put the cache edge where it wants it.
int krr_topk_cache_ints(void) { return kTopkCacheInts; }

const char* krr_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
