// Device helpers shared by the port's kernels (select.cu, sketch.cu): the
// ordered-bits map of the exact selection, the reference's float32 rank, a
// block-wide reduction, the total-order keys of the NaN-propagating max, a
// row visitor with 16-byte loads, the bit-space bisection loop, the radix
// select that returns the same answer, and the head-cached row that K1 and
// K4 run it over. ops/cuda_build.py hashes this header into the name of
// every library it builds, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

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

// max_key with NaN folded in: every NaN -> INT32_MAX, above max_key(+inf) =
// 0x7f800000, which no other value reaches. One max over these keys gives
// the peak and whether the row held a NaN, without a branch per sample.
__device__ __forceinline__ int nan_high_max_key(float v) {
  const int bits = __float_as_int(v);
  return (bits & kMagnitudeMask) > kExponentBits ? kInt32Max : max_key(bits);
}

// Calls f(i, p[i]) for the positions i of [begin, end) that fall to this
// thread, one of `lanes` threads (lanes >= 3) sharing the range: a scalar
// head up to the first 16-byte boundary (a row of a matrix whose width is
// not a multiple of 4 starts unaligned), a float4 body with kUnroll loads in
// flight per thread, and a scalar tail. A thread visits its positions in the
// same order on every call, so two passes see the same sequence.
template <int kUnroll = 4, typename F>
__device__ __forceinline__ void visit_row(const float* __restrict__ p, int begin, int end, int lane, int lanes,
                                          F&& f) {
  if (begin >= end) return;
  const int misaligned = static_cast<int>((reinterpret_cast<size_t>(p + begin) >> 2) & 3);
  const int head = min(end - begin, (4 - misaligned) & 3);
  if (lane < head) f(begin + lane, p[begin + lane]);
  const int body_begin = begin + head;
  const int quads = (end - body_begin) >> 2;
  const float4* __restrict__ body = reinterpret_cast<const float4*>(p + body_begin);
  const auto visit4 = [&](int j, const float4& x) {
    const int i = body_begin + 4 * j;
    f(i, x.x);
    f(i + 1, x.y);
    f(i + 2, x.z);
    f(i + 3, x.w);
  };
  int j = lane;
  for (; j + (kUnroll - 1) * lanes < quads; j += kUnroll * lanes) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(body + j + u * lanes);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) visit4(j + u * lanes, x[u]);
  }
  for (; j < quads; j += lanes) visit4(j, __ldg(body + j));
  const int tail_begin = body_begin + 4 * quads;
  if (lane < end - tail_begin) f(tail_begin + lane, p[tail_begin + lane]);
}

// Calls f(key) for this thread's share of the first `cached` ints of a
// 16-byte-aligned shared-memory array, four at a time, in a fixed order.
template <typename F>
__device__ __forceinline__ void visit_cache(const int* cache, int cached, F&& f) {
  const int stride = static_cast<int>(blockDim.x);
  const int quads = cached >> 2;
  const int4* cache4 = reinterpret_cast<const int4*>(cache);
  for (int i = static_cast<int>(threadIdx.x); i < quads; i += stride) {
    const int4 q = cache4[i];
    f(q.x);
    f(q.y);
    f(q.z);
    f(q.w);
  }
  for (int i = 4 * quads + static_cast<int>(threadIdx.x); i < cached; i += stride) f(cache[i]);
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

// Shared memory of radix_select_ordered: the digit histogram, one column per
// lane ([bin][lane], so the 32 lanes of a warp never hit one bank or one
// address, however hot a bin), the bin totals plus the picked digit, the
// residual rank and the candidate count, and the candidate buffer.
constexpr int kRadixBins = 256;
constexpr int kRadixHistInts = kRadixBins * 32;
constexpr int kRadixPickInts = kRadixBins + 3;
constexpr int kRadixCandidates = 2048;

// The answer of bisect_ordered at 31 steps, by an MSB-first radix select:
// max(b, 0) where b is the rank-th smallest (0-based) of the row's ordered
// bits in signed int32 order. The 31 bisection steps pin exactly that: a
// negative key (a NaN with its sign bit set) counts toward the rank but can
// never be the answer. The row is the same as bisect_ordered's: `cached`
// ordered bits in shared memory (16-byte aligned) plus what
// `visit_tail(f)` hands to f(key) for this thread. The rank must be below
// the row's key count: past it no digit passes the residual rank.
//
// u = bits ^ 0x80000000 turns signed order into unsigned order. Four passes
// of 8-bit digits, each a histogram of the current digit over the keys whose
// higher digits equal the prefix found so far, then a scan of the bins for
// the digit where the running count passes the residual rank. 8 bits because
// a lane-column histogram of 11 bits (2048 x 32 ints) would not fit beside
// the cache. A negative first digit ends the search at 0. The third pass
// also copies the keys that match the 16-bit prefix into `candidates`; when
// they fit (a few hundred on a row of spread values, against ties that
// overflow it), the last pass reads them instead of the row.
//
// Every thread of the block calls it and gets the answer; `hist` holds
// kRadixHistInts ints (16-byte aligned), `pick` kRadixPickInts and
// `candidates` kRadixCandidates; blockDim.x is a multiple of 32.
template <typename TailVisit>
__device__ __forceinline__ int radix_select_ordered(const int* cache, int cached, TailVisit visit_tail, int rank,
                                                    int* hist, int* pick, int* candidates) {
  const int tid = static_cast<int>(threadIdx.x);
  const int stride = static_cast<int>(blockDim.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = stride >> 5;
  int* found = pick + kRadixBins + 2;  // keys matching the 16-bit prefix
  unsigned prefix = 0u;  // the digits found so far, in place
  unsigned mask = 0u;    // their bit positions
  int residual = rank;   // the rank among the keys that match the prefix
  if (tid == 0) *found = 0;  // ordered before the third pass by the first pass's barriers
  for (int shift = 24; shift >= 0; shift -= 8) {
    int4* hist4 = reinterpret_cast<int4*>(hist);
    for (int i = tid; i < kRadixHistInts / 4; i += stride) hist4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const int buffered = shift == 0 ? *found : kRadixCandidates + 1;  // final after the third pass
    if (buffered <= kRadixCandidates) {
      for (int i = tid; i < buffered; i += stride) {
        const unsigned u = static_cast<unsigned>(candidates[i]) ^ 0x80000000u;
        if ((u & mask) == prefix) atomicAdd(&hist[(u & 0xffu) * 32 + lane], 1);
      }
    } else {
      const bool collect = shift == 8;
      const auto count = [&](int key) {
        const unsigned u = static_cast<unsigned>(key) ^ 0x80000000u;
        if ((u & mask) == prefix) {
          atomicAdd(&hist[((u >> shift) & 0xffu) * 32 + lane], 1);
          if (collect) {
            const int slot = atomicAdd(found, 1);
            if (slot < kRadixCandidates) candidates[slot] = key;
          }
        }
      };
      visit_cache(cache, cached, count);
      visit_tail(count);
    }
    __syncthreads();
    for (int b = warp; b < kRadixBins; b += warps) {
      int total = hist[b * 32 + lane];
      for (int offset = 16; offset > 0; offset >>= 1) total += __shfl_xor_sync(0xffffffffu, total, offset);
      if (lane == 0) pick[b] = total;
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds bins [8l, 8l + 8); the first lane whose inclusive count
      // passes the residual holds the digit.
      int own = 0;
      for (int j = 0; j < 8; ++j) own += pick[lane * 8 + j];
      int inclusive = own;
      for (int offset = 1; offset < 32; offset <<= 1) {
        const int other = __shfl_up_sync(0xffffffffu, inclusive, offset);
        if (lane >= offset) inclusive += other;
      }
      const unsigned passed = __ballot_sync(0xffffffffu, inclusive > residual);
      if (lane == __ffs(passed) - 1) {
        int below = inclusive - own;
        int digit = lane * 8;
        while (below + pick[digit] <= residual) below += pick[digit++];
        pick[kRadixBins] = digit;
        pick[kRadixBins + 1] = residual - below;
      }
    }
    __syncthreads();
    const unsigned digit = static_cast<unsigned>(pick[kRadixBins]);
    residual = pick[kRadixBins + 1];
    prefix |= digit << shift;
    mask |= 0xffu << shift;
    if (shift == 24 && digit < 0x80u) return 0;  // the key is negative: the answer is 0
  }
  return max(static_cast<int>(prefix ^ 0x80000000u), 0);
}

// Ordered bits of a row kept in shared memory by K1 and K4 beside the radix
// histogram and the candidates: 46K ints (184 KB).
constexpr int kRadixCacheInts = 46 * 1024;

// A row of ordered bits read as two segments, one after the other: a[0, na)
// then b[0, nb) (K4's chunk and state; K1 passes nb = 0). Its head,
// positions [0, cached), is converted once into a shared-memory cache; its
// tail is streamed from global memory with 16-byte loads on every pass.
// Every thread of the block builds the same CachedRow.
struct CachedRow {
  const float* a;
  int na;
  const float* b;
  int nb;
  int cached;  // positions in the cache: a's head, then b's
  int a_head;
  int b_head;

  __device__ __forceinline__ CachedRow(const float* a_, int na_, const float* b_, int nb_, int cache_cap)
      : a(a_), na(na_), b(b_), nb(nb_), cached(min(na_ + nb_, cache_cap)), a_head(min(cached, na_)),
        b_head(cached - a_head) {}

  // Converts the head into `cache` (16-byte aligned), then a barrier.
  __device__ __forceinline__ void fill(int* cache) const {
    const int tid = static_cast<int>(threadIdx.x);
    const int stride = static_cast<int>(blockDim.x);
    visit_row(a, 0, a_head, tid, stride, [&](int p, float x) { cache[p] = ordered_bits(x); });
    visit_row(b, 0, b_head, tid, stride, [&](int p, float x) { cache[na + p] = ordered_bits(x); });
    __syncthreads();
  }

  // Calls f(key) for this thread's share of the tail, in a fixed order.
  template <typename F>
  __device__ __forceinline__ void visit_tail(F&& f) const {
    const int tid = static_cast<int>(threadIdx.x);
    const int stride = static_cast<int>(blockDim.x);
    const auto key = [&](int, float x) { f(ordered_bits(x)); };
    visit_row(a, a_head, na, tid, stride, key);
    visit_row(b, b_head, nb, tid, stride, key);
  }
};

// Fills the row's cache, then radix_select_ordered over the cache and the
// tail: max(b, 0) for b the rank-th smallest key. The rank must be below the
// row's key count (the digit walk has no digit to pick past it).
__device__ __forceinline__ int cached_radix_select(const CachedRow& row, int* cache, int rank, int* hist, int* pick,
                                                   int* candidates) {
  row.fill(cache);
  return radix_select_ordered(
      cache, row.cached, [&](auto&& f) { row.visit_tail(f); }, rank, hist, pick, candidates);
}

}  // namespace krr
