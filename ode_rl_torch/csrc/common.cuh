// Shared helpers of the ode_rl_torch kernels: dtype conversion, a
// deterministic block reduction, mbarriers and the dynamic shared-memory
// opt-in. Every kernel is templated on float and __nv_bfloat16 inputs and
// accumulates in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

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

template <typename Launch, typename T>
int call_launch(Launch& launch, T tag) {
  if constexpr (std::is_void_v<decltype(launch(tag))>) {
    launch(tag);
    return 0;
  } else {
    return launch(tag);
  }
}

// Calls launch(T{}) with T = float or __nv_bfloat16 as dtype says, and
// returns cudaGetLastError() (cudaErrorInvalidValue for another dtype). A
// launch that returns an int refuses its arguments with a nonzero code,
// which is returned instead.
template <typename Launch>
int launch_for_dtype(int dtype, Launch&& launch) {
  int err;
  if (dtype == kF32) {
    err = call_launch(launch, float{});
  } else if (dtype == kBF16) {
    err = call_launch(launch, __nv_bfloat16{});
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Lets `kernel` ask for `bytes` of dynamic shared memory, once per kernel
// (each caller passes one size per kernel); setting it twice from two
// threads is harmless.
inline cudaError_t allow_max_smem(const void* kernel, int bytes) {
  static std::atomic<const void*> done[32] = {};
  for (auto& slot : done) {
    const void* seen = slot.load(std::memory_order_relaxed);
    if (seen == kernel) return cudaSuccess;
    if (seen == nullptr) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess) slot.store(kernel, std::memory_order_relaxed);
      return err;
    }
  }
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace odek
