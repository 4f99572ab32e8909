// Hand-written Hopper (sm_90a) kernels for the exact `simple` strategy device
// program: per-row CPU percentile by bit-space bisection, and per-row memory
// peak. Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (krr_tpu_torch/ops/cuda_build.py); the wrappers, the
// input checks and the launch counters live in krr_tpu_torch/ops/cuda_select.py.
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
//   [0, n-1], 31 bisection steps over [0, INT32_MAX], canonical NaN for an
//   empty row. The TPU kernel premasked invalid positions to INT32_MAX; this
//   one skips them, which counts the same set for every mid < INT32_MAX.
//   Bound: bytes. The least work reads the row once (4 B/sample), but
//   bisection reads it once per step. A 120,960-sample row is 484 KB and
//   does not fit the 227 KB of shared memory a block may use, so the TPU
//   design (whole row tile resident in VMEM for all 31 steps) does not carry
//   over. This design: one 1024-thread block per row; the first
//   kSelectCacheInts ordered bits of the row are converted once into shared
//   memory (~47% of a 7-day @ 5 s row), and each of the 31 steps counts the
//   cached head from shared memory and streams the tail from global memory.
//   With one such block per SM the 132 tails in flight (~254 KB each) fit
//   the 50 MB L2, so the re-reads mostly hit L2 rather than HBM. A radix
//   select (4 passes instead of 31) is the known next step.
//
// K2 row_max_kernel replaces krr_tpu/ops/pallas_select.py:_rowmax_kernel.
//   Same function as jnp.max over the valid prefix on XLA's CPU backend:
//   subnormals read as zero of their sign, +0.0 ranks above -0.0, NaN
//   propagates (written out by hand: fmaxf would drop it); canonical NaN for
//   a NaN row or an empty row. The max is taken over an integer key that
//   orders float32 totally, so it does not depend on the reduction order.
//   Bound: bytes, one read of the row. One 256-thread block per row,
//   coalesced strided loads, warp-shuffle + shared-memory block reduction.

#include <cuda_runtime.h>

namespace {

constexpr int kInt32Max = 0x7fffffff;
constexpr int kInt32Min = -2147483647 - 1;
constexpr int kMagnitudeMask = 0x7fffffff;
constexpr int kExponentBits = 0x7f800000;
constexpr int kMinNormalBits = 0x00800000;
constexpr unsigned kCanonicalNan = 0x7fc00000u;

constexpr int kSelectThreads = 1024;
constexpr int kMaxThreads = 256;
// Shared-memory header: 32 warp partials + the block total, padded.
constexpr int kHeaderInts = 64;
// Ordered bits of a row's head kept in shared memory: 57,344 ints + the
// header = 229,632 bytes, inside the 232,448 bytes a block may use.
constexpr int kSelectCacheInts = 56 * 1024;

__device__ __forceinline__ int ordered_bits(float v) {
  const int bits = __float_as_int(v);
  if ((bits & kMagnitudeMask) > kExponentBits) return bits;  // NaN keeps its bits
  return bits >= kMinNormalBits ? bits : 0;  // negatives, -0.0, subnormals -> 0
}

__device__ __forceinline__ int selection_rank(int count, float q) {
  // float32 op order of the reference: cast, -1, *q, /100, floor, clip.
  // The _rn intrinsics keep nvcc from contracting or reassociating.
  const float r = __fdiv_rn(__fmul_rn(__fsub_rn(__int2float_rn(count), 1.0f), q), 100.0f);
  const int rank = __float2int_rd(r);
  return min(max(rank, 0), max(count - 1, 0));
}

// Block-wide sum (kSum) or max of one int per thread; every thread gets the
// result. blockDim.x must be a multiple of 32. `scratch` holds 33 ints.
template <bool kSum>
__device__ __forceinline__ int block_reduce(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int offset = 16; offset > 0; offset >>= 1) {
    const int other = __shfl_down_sync(0xffffffffu, v, offset);
    v = kSum ? v + other : max(v, other);
  }
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int identity = kSum ? 0 : kInt32Min;
    v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : identity;
    for (int offset = 16; offset > 0; offset >>= 1) {
      const int other = __shfl_down_sync(0xffffffffu, v, offset);
      v = kSum ? v + other : max(v, other);
    }
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  return scratch[32];
}

__global__ void __launch_bounds__(kSelectThreads)
bisect_select_kernel(const float* __restrict__ values, const int* __restrict__ counts,
                     float* __restrict__ out, long long t, int cache_cap, float q, int num_iters) {
  extern __shared__ int smem[];
  int* scratch = smem;
  int* cache = smem + kHeaderInts;

  const long long row = blockIdx.x;
  const int count = counts[row];
  const long long valid = min(static_cast<long long>(max(count, 0)), t);
  if (count <= 0) {
    if (threadIdx.x == 0) out[row] = __uint_as_float(kCanonicalNan);
    return;
  }
  const float* __restrict__ v = values + row * t;
  const int cached = static_cast<int>(min(valid, static_cast<long long>(cache_cap)));
  for (int i = threadIdx.x; i < cached; i += blockDim.x) cache[i] = ordered_bits(v[i]);
  __syncthreads();

  const int rank = selection_rank(count, q);
  int lo = 0;
  int hi = kInt32Max;
  for (int it = 0; it < num_iters; ++it) {
    const int mid = lo + ((hi - lo) >> 1);  // floor division, as in the reference
    int le = 0;
    for (int i = threadIdx.x; i < cached; i += blockDim.x) le += cache[i] <= mid;
    for (long long i = cached + threadIdx.x; i < valid; i += blockDim.x) le += ordered_bits(v[i]) <= mid;
    le = block_reduce<true>(le, scratch);
    if (le >= rank + 1) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (threadIdx.x == 0) out[row] = __int_as_float(lo);
}

__global__ void __launch_bounds__(kMaxThreads)
row_max_kernel(const float* __restrict__ values, const int* __restrict__ counts,
               float* __restrict__ out, long long t) {
  __shared__ int scratch[33];
  const long long row = blockIdx.x;
  const int count = counts[row];
  const long long valid = min(static_cast<long long>(max(count, 0)), t);
  if (valid <= 0) {
    if (threadIdx.x == 0) out[row] = __uint_as_float(kCanonicalNan);
    return;
  }
  const float* __restrict__ v = values + row * t;
  int best = kInt32Min;  // below every key of a non-NaN value
  int saw_nan = 0;
  for (long long i = threadIdx.x; i < valid; i += blockDim.x) {
    int bits = __float_as_int(v[i]);
    const int magnitude = bits & kMagnitudeMask;
    if (magnitude > kExponentBits) {
      saw_nan = 1;
      continue;
    }
    if (magnitude < kMinNormalBits) bits &= kInt32Min;  // subnormal -> zero of its sign
    const int key = bits >= 0 ? bits : bits ^ kMagnitudeMask;
    best = max(best, key);
  }
  best = block_reduce<false>(best, scratch);
  saw_nan = block_reduce<false>(saw_nan, scratch);
  if (threadIdx.x == 0) {
    const int bits = best >= 0 ? best : best ^ kMagnitudeMask;
    out[row] = saw_nan ? __uint_as_float(kCanonicalNan) : __int_as_float(bits);
  }
}

}  // namespace

extern "C" {

int krr_bisect_select(const float* values, const int* counts, float* out, int n, long long t, float q,
                      int num_iters, void* stream) {
  if (n <= 0) return 0;
  const int cache_cap = static_cast<int>(t < kSelectCacheInts ? t : kSelectCacheInts);
  const int smem_bytes = (kHeaderInts + cache_cap) * static_cast<int>(sizeof(int));
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

const char* krr_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
