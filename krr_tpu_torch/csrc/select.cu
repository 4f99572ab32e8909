// Hand-written Hopper (sm_90a) kernels for the exact `simple` strategy device
// program: per-row exact CPU percentile over the ordered bits, and per-row
// memory peak. Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (krr_tpu_torch/ops/cuda_build.py); the wrappers, the
// input checks and the launch counters live in krr_tpu_torch/ops/cuda_select.py;
// the device helpers (ordered bits, rank, block reduction, max keys, the row
// visitor, the bisection loop, the radix select over a head-cached row) are
// shared with sketch.cu through common.cuh.
//
// Both kernels take a row-major [n, t] float32 matrix whose row i holds
// counts[i] valid samples, left-justified; positions at or past counts[i]
// (and past t) are never read. They launch on the caller's stream, allocate
// nothing, and return cudaGetLastError().
//
// K1 bisect_select_kernel replaces krr_tpu/ops/pallas_select.py:_bisect_kernel.
//   Same function: float -> value-monotone int32 bits (NaN keeps its bits;
//   negatives, -0.0 and subnormals -> 0, as jnp.maximum(v, 0.0) gives on
//   XLA's CPU backend), rank floor((n-1)*q/100) in float32 clamped into
//   [0, n-1], num_iters bisection steps over [0, INT32_MAX], canonical NaN
//   for an empty row. The TPU kernel premasked invalid positions to
//   INT32_MAX; this one skips them, which counts the same set for every
//   mid < INT32_MAX.
//   Bound: bytes. The least work reads the row once (4 B/sample); a
//   120,960-sample row is 484 KB and does not fit the 227 KB of shared
//   memory a block may use, so the TPU design (the whole row tile resident in
//   VMEM for all 31 steps, each step one pass over it) does not carry over:
//   31 passes over a row that does not fit meant 31 re-reads of its tail.
//   This design: one 1024-thread block per row, the same shared layout and
//   helper as K4 (common.cuh CachedRow, cached_radix_select). The first
//   46K ordered bits of the row are converted once into shared memory with
//   16-byte loads; at 31 steps (every call of the scans) the answer comes
//   from the radix select, 8-bit digit passes over the cache and the tail
//   (streamed with 16-byte loads) that give what the 31 steps pin:
//   max(b, 0) for b the rank-th smallest key in signed order. The third
//   pass keeps the keys that match the top 16 bits in a shared buffer (a few
//   hundred on a row of spread values), so the fourth reads them instead of
//   the row when they fit: the tail is read three times, not 31. The rank
//   comes from counts[i], the keys stop at the width t: a rank past the keys
//   (counts[i] > t) never satisfies a bisection step, which climbs to
//   INT32_MAX (the NaN 0x7fffffff), and the digit walk would have no digit
//   to pick, so that case is decided before the select. Fewer than 31 steps
//   stop the bisection part way by definition and keep it: one pass over the
//   cache and the tail per step.
//
// K2 row_max_kernel replaces krr_tpu/ops/pallas_select.py:_rowmax_kernel.
//   Same function as jnp.max over the valid prefix on XLA's CPU backend:
//   subnormals read as zero of their sign, +0.0 ranks above -0.0, NaN
//   propagates (written out by hand: fmaxf would drop it); canonical NaN for
//   a NaN row or an empty row. The max is taken over an integer key that
//   orders float32 totally, so it does not depend on the reduction order.
//   Bound: bytes, one read of the row. This design: one 256-thread block per
//   row; each thread reads 16 bytes at a time, four loads in flight, after a
//   scalar head up to the row's first 16-byte boundary (a row starts aligned
//   only when t % 4 == 0) and before a scalar tail at the count. The work per
//   sample is branch-free: NaN takes the key INT32_MAX, above every other
//   value's, so one max reduction gives the peak and the NaN flag together.
//
// K5 radix_digit_hist_kernel replaces no Pallas kernel: it is the count pass
//   of the JAX package's host-streamed selection
//   (krr_tpu/ops/selection.py:masked_percentile_bisect_from_host, a jnp
//   masked compare-and-sum per bisection step, 31 passes over the host
//   chunks). The port streams a radix select instead (3 passes of 11, 11
//   and 10 bits, krr_tpu_torch/ops/selection.py): one pass per digit, and
//   this kernel folds one time chunk of a pass into the running
//   [n, 2^bits] digit histogram of each row: digit
//   (u >> shift) & (2^bits - 1), for 1 <= bits <= 12, of every valid key
//   u = ordered_bits ^ 0x80000000 whose bits above shift + bits equal the
//   row's prefix.
//   Bound: bytes, one read of the chunk plus a read and a write of each
//   non-zero bin (a row's keys fill a few dozen of 2,048 bins on the first
//   pass, fewer under a prefix). The 8-bit design before it kept a
//   [256 bins][32 lanes] shared histogram per row (32 KB, 256 KB at 11
//   bits) and paid a zero and a 32-column sum per row as large as the
//   row's 32 KB of loads. This design: one shared histogram of 2^bits ints
//   per row, zeroed with 16-byte stores; 16-byte loads through visit_row;
//   after one __syncthreads only the non-zero bins are added into the
//   row's global bins. A hot bin (an idle row's keys all read 0) is
//   counted as a run per thread, added to the shared bin when the bin
//   changes, and a warp whose runs all end on one bin adds their sum once:
//   an idle row costs one shared add per warp, not one per key. One
//   256-thread block per row (32 registers, 8 blocks an SM): with the fixed
//   cost per row this small, short-lived blocks overlap each other (a
//   persistent grid, each block walking rows gridDim.x apart, was measured
//   and was not faster: PERF.md). Only the block that owns a row writes its
//   bins in a launch, so the global bins take plain adds, not atomics.

#include "common.cuh"

namespace {

using krr::block_reduce;
using krr::kCanonicalNan;
using krr::kInt32Max;
using krr::kInt32Min;

constexpr int kSelectThreads = 1024;
constexpr int kMaxThreads = 256;
// Shared-memory header: the radix select's bin totals and pick
// [0, kRadixPickInts), the bisection's reduction scratch [264, 297); padded to
// 16 bytes. The radix histogram follows, then the candidates, then the
// cache: 304 + 8,192 + 2,048 + 47,104 ints = 230,592 bytes, inside the
// 232,448 bytes a block may use.
constexpr int kSelectScratch = 264;
constexpr int kSelectHeaderInts = 304;
constexpr int kSelectFixedInts = kSelectHeaderInts + krr::kRadixHistInts + krr::kRadixCandidates;
static_assert(krr::kRadixPickInts <= kSelectScratch, "header overlap");
static_assert((kSelectFixedInts + krr::kRadixCacheInts) * 4 <= 232448, "shared memory");
static_assert(kSelectFixedInts % 4 == 0, "the cache is 16-byte aligned");

__global__ void __launch_bounds__(kSelectThreads)
bisect_select_kernel(const float* __restrict__ values, const int* __restrict__ counts,
                     float* __restrict__ out, long long t, int cache_cap, float q, int num_iters) {
  extern __shared__ __align__(16) int smem[];
  int* pick = smem;
  int* scratch = smem + kSelectScratch;
  int* hist = smem + kSelectHeaderInts;
  int* candidates = hist + krr::kRadixHistInts;
  int* cache = smem + kSelectFixedInts;

  const long long row = blockIdx.x;
  const int count = counts[row];
  if (count <= 0) {
    if (threadIdx.x == 0) out[row] = __uint_as_float(kCanonicalNan);
    return;
  }
  const int valid = static_cast<int>(min(static_cast<long long>(count), t));
  const int rank = krr::selection_rank(count, q);
  const krr::CachedRow keys(values + row * t, valid, nullptr, 0, cache_cap);
  int answer;
  if (num_iters < 31) {
    keys.fill(cache);
    const auto tail_le = [&](int mid) {
      int le = 0;
      keys.visit_tail([&](int key) { le += key <= mid; });
      return le;
    };
    answer = krr::bisect_ordered(cache, keys.cached, tail_le, rank, num_iters, scratch);
  } else if (rank >= valid) {
    answer = kInt32Max;  // no step finds rank + 1 keys: the bisection climbs to INT32_MAX
  } else {
    answer = krr::cached_radix_select(keys, cache, rank, hist, pick, candidates);
  }
  if (threadIdx.x == 0) out[row] = __int_as_float(answer);
}

__global__ void __launch_bounds__(kMaxThreads)
row_max_kernel(const float* __restrict__ values, const int* __restrict__ counts,
               float* __restrict__ out, long long t) {
  __shared__ int scratch[33];
  const long long row = blockIdx.x;
  const int valid = static_cast<int>(min(static_cast<long long>(max(counts[row], 0)), t));
  if (valid == 0) {
    if (threadIdx.x == 0) out[row] = __uint_as_float(kCanonicalNan);
    return;
  }
  int best = kInt32Min;  // below every key of a valid sample
  krr::visit_row(values + row * t, 0, valid, static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x),
                 [&](int, float x) { best = max(best, krr::nan_high_max_key(x)); });
  best = block_reduce<false>(best, scratch);
  if (threadIdx.x == 0) out[row] = best == kInt32Max ? __uint_as_float(kCanonicalNan) : krr::from_max_key(best);
}

constexpr int kDigitThreads = 256;

__global__ void __launch_bounds__(kDigitThreads)
radix_digit_hist_kernel(const float* __restrict__ values, const int* __restrict__ eff,
                        const int* __restrict__ prefixes, int* __restrict__ bins, long long t, int shift, int bits) {
  extern __shared__ __align__(16) int hist[];  // 2^bits ints, at least 4
  const int tid = static_cast<int>(threadIdx.x);
  const int stride = static_cast<int>(blockDim.x);
  const long long row = blockIdx.x;
  const int valid = static_cast<int>(min(static_cast<long long>(max(eff[row], 0)), t));
  if (valid == 0) return;  // nothing to add: the row's bins stay as they are
  const int nbins = 1 << bits;
  int4* hist4 = reinterpret_cast<int4*>(hist);
  for (int i = tid; i < (nbins + 3) / 4; i += stride) hist4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const unsigned digit_mask = static_cast<unsigned>(nbins - 1);
  const unsigned mask = shift + bits >= 32 ? 0u : 0xffffffffu << (shift + bits);  // the bits above the digit
  const unsigned prefix = static_cast<unsigned>(prefixes[row]) & mask;
  int last = -1;  // this thread's run: `run` keys of bin `last`
  int run = 0;
  krr::visit_row(values + row * t, 0, valid, tid, stride, [&](int, float x) {
    const unsigned u = static_cast<unsigned>(krr::ordered_bits(x)) ^ 0x80000000u;
    const bool match = (u & mask) == prefix;
    const int bin = static_cast<int>((u >> shift) & digit_mask);
    const bool change = match && bin != last;
    if (change && run) atomicAdd(&hist[last], run);
    run = change ? 1 : run + match;
    last = change ? bin : last;
  });
  const int lead = __shfl_sync(0xffffffffu, last, 0);
  if (__all_sync(0xffffffffu, last == lead)) {  // one bin for the whole warp: one add
    const int total = __reduce_add_sync(0xffffffffu, run);
    if ((tid & 31) == 0 && total) atomicAdd(&hist[lead], total);
  } else if (run) {
    atomicAdd(&hist[last], run);
  }
  __syncthreads();
  int* out = bins + row * nbins;
  for (int b = tid; b < nbins; b += stride) {
    const int count = hist[b];
    if (count) out[b] += count;
  }
}

}  // namespace

extern "C" {

int krr_bisect_select(const float* values, const int* counts, float* out, int n, long long t, float q,
                      int num_iters, void* stream) {
  if (n <= 0) return 0;
  const int cache_cap = static_cast<int>(t < krr::kRadixCacheInts ? t : krr::kRadixCacheInts);
  const int smem_bytes = (kSelectFixedInts + cache_cap) * static_cast<int>(sizeof(int));
  cudaError_t err =
      cudaFuncSetAttribute(bisect_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bisect_select_kernel<<<n, kSelectThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      values, counts, out, t, cache_cap, q, num_iters);
  return static_cast<int>(cudaGetLastError());
}

int krr_row_max(const float* values, const int* counts, float* out, int n, long long t, void* stream) {
  if (n <= 0) return 0;
  row_max_kernel<<<n, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(values, counts, out, t);
  return static_cast<int>(cudaGetLastError());
}

int krr_radix_digit_hist(const float* values, const int* eff, const int* prefixes, int* bins, int n, long long t,
                         int shift, int bits, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  const int smem_bytes = max(1 << bits, 4) * static_cast<int>(sizeof(int));
  radix_digit_hist_kernel<<<n, kDigitThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(values, eff, prefixes,
                                                                                             bins, t, shift, bits);
  return static_cast<int>(cudaGetLastError());
}

// The cache size, so a test can put the cache edge where it wants it.
int krr_select_cache_ints(void) { return krr::kRadixCacheInts; }

const char* krr_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
