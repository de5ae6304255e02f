// Shared helpers of the ode_rl_torch kernels: dtype conversion, a
// deterministic block reduction, mbarriers, wgmma and its shared-memory
// descriptors, and the dynamic shared-memory opt-in. Every kernel is templated on float and __nv_bfloat16 inputs and
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

// ---- Warpgroup matrix multiply (wgmma, sm_90a) ----

// Barrier of the 128 threads of warpgroup wg (named barrier 1 + wg; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas that own the registers.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// TMA's swizzle of rows of `row_bytes` (32, 64 or 128) in a 1 KB aligned
// region: the 16-byte unit at bits 4.. of an offset is XORed with bits 7..
__device__ __forceinline__ uint32_t swizzle(uint32_t off, int row_bytes) {
  return off ^ (((off >> 7) & (row_bytes / 16 - 1)) << 4);
}

// wgmma shared-memory descriptor of an MN-major operand NT columns wide
// (one swizzle atom): start address, leading byte offset (between atoms
// along N: one atom, so unused), stride byte offset (between groups of 8
// K rows) and the swizzle (1: 128 B at NT 64, 2: 64 B at 32, 3: 32 B at
// 16).
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, int nt) {
  const uint64_t row_bytes = nt * 2;
  const uint64_t layout = nt == 64 ? 1 : (nt == 32 ? 2 : 3);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         (((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

// wgmma shared-memory descriptor of a K-major operand whose 8-row groups
// are 8 consecutive swizzle rows, `sbo` bytes apart, with the given swizzle
// (1: 128 B, 2: 64 B, 3: 32 B); base offset 0.
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr, uint32_t sbo,
                                                 uint64_t layout) {
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// D (64 x 64, fp32) += A (64 x 16) . B (16 x 64), both bf16 in shared
// memory; TransA / TransB 0 for a K-major operand, 1 for an MN-major one.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, %34, %35;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(TransA), "n"(TransB));
}

// D (64 x 32, fp32) += A (64 x 16) . B (16 x 32), as wgmma_m64n64k16.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, %18, %19;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "n"(TransA), "n"(TransB));
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
