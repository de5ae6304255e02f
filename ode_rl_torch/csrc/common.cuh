// Shared helpers of the ode_rl_torch kernels: dtype conversion and a
// deterministic block reduction. Every kernel is templated on float and
// __nv_bfloat16 inputs and accumulates in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace odek {

// dtype codes shared with ode_rl_torch/ops/common.py::DTYPE_CODES.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Sum of v over the warp, in every lane. The xor butterfly adds in a fixed
// order, so the result is deterministic.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Calls launch(T{}) with T = float or __nv_bfloat16 as dtype says, and
// returns cudaGetLastError() (cudaErrorInvalidValue for another dtype).
template <typename Launch>
int launch_for_dtype(int dtype, Launch&& launch) {
  if (dtype == kF32) {
    launch(float{});
  } else if (dtype == kBF16) {
    launch(__nv_bfloat16{});
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Sum (a, b) over the block; every thread gets both totals. Warps reduce
// by shuffles, then every thread adds the per-warp partials in the same
// fixed order, so the result is deterministic. blockDim.x must be a
// multiple of 32 and at most 1024.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float part_a[32];
  __shared__ float part_b[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part_a[warp] = a;
    part_b[warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  const int n_warps = blockDim.x / 32;
  for (int i = 0; i < n_warps; ++i) {
    a += part_a[i];
    b += part_b[i];
  }
}

}  // namespace odek
