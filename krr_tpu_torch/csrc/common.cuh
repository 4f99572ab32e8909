// Device helpers shared by the port's kernels (select.cu, sketch.cu): the
// ordered-bits map of the exact selection, the reference's float32 rank, a
// block-wide reduction, the total-order key of the NaN-propagating max, and
// the bit-space bisection loop. ops/cuda_build.py hashes this header into the
// name of every library it builds, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>

namespace krr {

constexpr int kInt32Max = 0x7fffffff;
constexpr int kInt32Min = -2147483647 - 1;
constexpr int kMagnitudeMask = 0x7fffffff;
constexpr int kExponentBits = 0x7f800000;
constexpr int kMinNormalBits = 0x00800000;
constexpr unsigned kCanonicalNan = 0x7fc00000u;
constexpr unsigned kNegInfBits = 0xff800000u;

// float -> value-monotone int32 over max(v, 0): NaN keeps its bits;
// negatives, -0.0 and subnormals -> 0, as jnp.maximum(v, 0.0) gives on XLA's
// CPU backend.
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

// Key of the NaN-propagating max (the caller tests NaN first): subnormals read
// as zero of their sign, and the int32 key orders float32 totally with +0.0
// above -0.0, so a max over keys does not depend on the reduction order.
__device__ __forceinline__ int max_key(int bits) {
  if ((bits & kMagnitudeMask) < kMinNormalBits) bits &= kInt32Min;  // subnormal -> zero of its sign
  return bits >= 0 ? bits : bits ^ kMagnitudeMask;
}

__device__ __forceinline__ float from_max_key(int key) {
  return __int_as_float(key >= 0 ? key : key ^ kMagnitudeMask);
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

// The bit-space bisection of the JAX package's selection (bisect_mid /
// bisect_update): the smallest x in [0, INT32_MAX] such that at least
// rank + 1 of the row's ordered bits are <= x, after num_iters steps (31 pin
// every bit). The row is `cached` ordered bits in shared memory plus whatever
// `tail_le(mid)` counts for this thread (the rest of the row, read from
// global memory). Every thread of the block calls it and gets the answer.
// Loop strides are signed ints: with `i += blockDim.x` (unsigned) an int
// induction wraps around, nvcc cannot count the trips and does not batch the
// loads.
template <typename TailLe>
__device__ __forceinline__ int bisect_ordered(const int* cache, int cached, TailLe tail_le, int rank,
                                              int num_iters, int* scratch) {
  int lo = 0;
  int hi = kInt32Max;
  const int stride = static_cast<int>(blockDim.x);
  for (int it = 0; it < num_iters; ++it) {
    const int mid = lo + ((hi - lo) >> 1);  // floor division, as in the reference
    int le = 0;
    for (int i = static_cast<int>(threadIdx.x); i < cached; i += stride) le += cache[i] <= mid;
    le += tail_le(mid);
    le = block_reduce<true>(le, scratch);
    if (le >= rank + 1) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

}  // namespace krr
