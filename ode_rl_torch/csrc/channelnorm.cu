// K8: channelnorm, the per-pixel L2 norm over channels.
//
// Replaces (Pallas, TPU): ode_rl_tpu/ops/channelnorm.py::_kernel (via
// _channelnorm_pallas): x (B, H, W, C) -> sqrt(sum_c x^2) (B, H, W, 1),
// reduced in fp32 and written in the input dtype.
//
// What bounds it on the H100: bytes for large maps, and below them the
// launch. On FlowNet2's path C is 3 (image brightness errors) or 2 (flow
// magnitudes) at (8, 64, 64): 32,768 pixels, 393 KB read and 131 KB
// written in fp32 at C = 3, 0.157 us at 3.35 TB/s, below what one launch
// of an empty kernel takes. chip_smoke.py times two controls on K8's grid
// beside it: that empty kernel, and one that reads the same bytes with
// whole-warp loads and writes one value a pixel, with no squares and no
// square root.
//
// Design: one thread a pixel, reading its C channels in order from
// consecutive addresses (neighbouring threads read neighbouring pixels, so
// a warp's loads span 32*C contiguous elements). It squares and adds the
// channels in the order c = 0..C-1 in fp32, rounding after every product
// and sum (no fused multiply-add), as the plain version does, and takes an
// IEEE square root, so it agrees with the plain version bit for bit. The
// backward is a torch expression in ops/channelnorm.py, as it is a jnp
// formula in JAX.

#include "common.cuh"

namespace {

using odek::from_f32;
using odek::to_f32;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    channelnorm_kernel(const T* __restrict__ x, T* __restrict__ out,
                       long long n_pix, int C) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const T* xp = x + p * C;
  float sum = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = to_f32(xp[c]);
    sum = __fadd_rn(sum, __fmul_rn(v, v));
  }
  out[p] = from_f32<T>(sqrtf(sum));
}

// Controls for chip_smoke.py's timing of K8, on K8's grid (a thread a
// pixel, blocks of 256). The first does nothing: the floor no launch goes
// below. The second reads all n_pix * C elements of x, thread p the
// elements p, p + n_pix, ... (each load a whole warp's 128 contiguous
// bytes), and writes their sum to out[p]: a load, then a dependent store,
// with no squares and no square root.
__global__ void __launch_bounds__(kThreads) channelnorm_floor_kernel() {}

__global__ void __launch_bounds__(kThreads)
    channelnorm_copy_kernel(const float* __restrict__ x,
                            float* __restrict__ out, long long n_pix, int C) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  float sum = 0.f;
  for (int c = 0; c < C; ++c) sum += x[p + c * n_pix];
  out[p] = sum;
}

unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int odek_channelnorm(const void* x, void* out, long long n_pix,
                                int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    channelnorm_kernel<T><<<blocks_for(n_pix), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n_pix, C);
  });
}

// The two controls above, for chip_smoke.py only: with `x` null the empty
// kernel, else the read-then-write one on fp32 x (n_pix, C) and out
// (n_pix). Returns the launch's error.
extern "C" int odek_channelnorm_control(const void* x, void* out,
                                        long long n_pix, int C,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x == nullptr) {
    channelnorm_floor_kernel<<<blocks_for(n_pix), kThreads, 0, st>>>();
  } else {
    channelnorm_copy_kernel<<<blocks_for(n_pix), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n_pix, C);
  }
  return (int)cudaGetLastError();
}
