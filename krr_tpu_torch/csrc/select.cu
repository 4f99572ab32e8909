// Hand-written Hopper (sm_90a) kernels for the exact `simple` strategy device
// program: per-row CPU percentile by bit-space bisection, and per-row memory
// peak. Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (krr_tpu_torch/ops/cuda_build.py); the wrappers, the
// input checks and the launch counters live in krr_tpu_torch/ops/cuda_select.py;
// the device helpers (ordered bits, rank, block reduction, max keys, the row
// visitor, the bisection loop) are shared with sketch.cu through common.cuh.
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
//   the 50 MB L2, so the re-reads mostly hit L2 rather than HBM. The radix
//   select of common.cuh (4 passes instead of 31, as K4 uses it) returns the
//   same answer and is the known next step.
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

#include "common.cuh"

namespace {

using krr::block_reduce;
using krr::kCanonicalNan;
using krr::kInt32Max;
using krr::kInt32Min;
using krr::ordered_bits;

constexpr int kSelectThreads = 1024;
constexpr int kMaxThreads = 256;
// Shared-memory header: 32 warp partials + the block total, padded.
constexpr int kHeaderInts = 64;
// Ordered bits of a row's head kept in shared memory: 57,344 ints + the
// header = 229,632 bytes, inside the 232,448 bytes a block may use.
constexpr int kSelectCacheInts = 56 * 1024;

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
  const int stride = static_cast<int>(blockDim.x);
  for (int i = static_cast<int>(threadIdx.x); i < cached; i += stride) cache[i] = ordered_bits(v[i]);
  __syncthreads();

  const auto tail_le = [=](int mid) {
    int le = 0;
    for (long long i = cached + threadIdx.x; i < valid; i += blockDim.x) le += ordered_bits(v[i]) <= mid;
    return le;
  };
  const int lo = krr::bisect_ordered(cache, cached, tail_le, krr::selection_rank(count, q), num_iters, scratch);
  if (threadIdx.x == 0) out[row] = __int_as_float(lo);
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
