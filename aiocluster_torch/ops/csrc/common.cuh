// Shared helpers of the port's CUDA kernels: eight-element vector loads and
// stores (one 16-byte transaction for every 2-byte type), widening and
// narrowing of the stored dtypes, and a block-wide sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Dtype codes the wrappers pass (bytes per element, or a tag; kU4 is the
// packed u4r residual rung, two owners a byte).
enum : int { kInt8 = 1, kInt16 = 2, kInt32 = 4, kU4 = 100, kBf16 = 102, kF32 = 104 };

// 8 consecutive elements starting at an 8-element boundary of a row whose
// length is a multiple of 8: the address is aligned to 8 * sizeof(T)
// bytes (the wrappers check the base pointers).
template <typename T>
struct alignas(sizeof(T) * 8 >= 16 ? 16 : sizeof(T) * 8) Vec8 {
  T v[8];
};

template <typename T>
__device__ __forceinline__ Vec8<T> ld8(const T* p) {
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4, "dtype");
  Vec8<T> out;
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint2*>(out.v) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(out.v) = *reinterpret_cast<const uint4*>(p);
  } else {
    reinterpret_cast<uint4*>(out.v)[0] = reinterpret_cast<const uint4*>(p)[0];
    reinterpret_cast<uint4*>(out.v)[1] = reinterpret_cast<const uint4*>(p)[1];
  }
  return out;
}

template <typename T>
__device__ __forceinline__ void st8(T* p, const Vec8<T>& x) {
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(x.v);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(x.v);
  } else {
    reinterpret_cast<uint4*>(p)[0] = reinterpret_cast<const uint4*>(x.v)[0];
    reinterpret_cast<uint4*>(p)[1] = reinterpret_cast<const uint4*>(x.v)[1];
  }
}

// Stored FD interval means widen exactly to f32 and narrow once, with
// round-to-nearest-even for bfloat16 (the reference's astype).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum of one value per thread over the block, returned to every thread.
// Safe to call back to back (the first barrier fences the previous
// call's reads of the partials).
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T partial[32];
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  T total = 0;
  const int warps = (blockDim.x + 31) >> 5;
  for (int k = 0; k < warps; ++k) total += partial[k];
  return total;
}
