// K8: channelnorm, the per-pixel L2 norm over channels.
//
// Replaces (Pallas, TPU): ode_rl_tpu/ops/channelnorm.py::_kernel (via
// _channelnorm_pallas): x (B, H, W, C) -> sqrt(sum_c x^2) (B, H, W, 1),
// reduced in fp32 and written in the input dtype.
//
// What bounds it on the H100: bytes. On FlowNet2's path C is 3 (image
// brightness errors) or 2 (flow magnitudes) at (8, 64, 64): 32,768 pixels,
// 400 KB read and 130 KB written in fp32, a few microseconds of memory
// time, so the launch dominates.
//
// Design: one thread per pixel, reading its C channels in order from
// consecutive addresses (neighbouring threads read neighbouring pixels, so
// a warp's loads span 32*C contiguous elements). The backward is a torch
// expression in ops/channelnorm.py, as it is a jnp formula in JAX.

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
    sum += v * v;
  }
  out[p] = from_f32<T>(sqrtf(sum));
}

}  // namespace

extern "C" int odek_channelnorm(const void* x, void* out, long long n_pix,
                                int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks =
      (unsigned int)((n_pix + kThreads - 1) / kThreads);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    channelnorm_kernel<T><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n_pix, C);
  });
}
