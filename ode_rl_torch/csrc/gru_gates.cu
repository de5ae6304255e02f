// K3 and K4: the GroupNorm tails of the ConvGRU step.
//
// Replaces (Pallas, TPU):
//   K3  ode_rl_tpu/ops/gru_gates.py::_gates_kernel (via _gates_pallas):
//       GroupNorm + sigmoid on the gate conv output, split at C into z and
//       r, writes z and r*h;
//   K4  ode_rl_tpu/ops/gru_gates.py::_blend_kernel (via _blend_pallas):
//       GroupNorm + tanh on the candidate conv output, writes
//       (1 - z) * h + z * cand.
//
// GroupNorm statistics are per (sample, group) over (H, W, C/G) in fp32,
// with one-pass moments E[x^2] - E[x]^2 clamped at 0 and eps 1e-5, as
// _groupnorm_f32 computes them. Channels group contiguously on the last
// axis, as JAX's reshape(..., G, C/G) does. K3's first C channels are z
// and its last C are r, so at G = 4 groups 0-1 feed z and groups 2-3 r*h.
// r*h and the blend are formed in fp32 and rounded once to the output
// dtype, as the Pallas kernels do.
//
// What bounds it on the H100: device-memory bandwidth. Each element is a
// handful of flops, so the cost is the bytes moved: K3 at the flagship
// shape (gates (128,16,16,128), h (128,16,16,64), bf16) reads 12 MB and
// writes 8 MB, K4 reads 12 MB and writes 4 MB.
//
// Design. One block per (sample, group): 128 x 4 blocks for K3 and
// 128 x 2 for K4 at the flagship shape. Pass 1 takes the fp32 sum and sum
// of squares over the group with a deterministic block reduction; pass 2
// reads the group again (from L2: a group is 16-32 KB) to normalise,
// apply scale/bias and the activation, and write. Neighbouring threads
// touch neighbouring channels of one pixel, so loads coalesce within a
// group's channel slice. Fusing both tails and the moments into one pass
// over registers is later work.

#include "common.cuh"

namespace {

using odek::block_sum2;
using odek::from_f32;
using odek::to_f32;

constexpr int kThreads = 256;

// Mean and rstd of channels [g*cs, (g+1)*cs) of one sample's (HW, C) map.
template <typename T>
__device__ __forceinline__ void group_moments(const T* __restrict__ x,
                                              int HW, int C, int cs, int g,
                                              float eps, float& mean,
                                              float& rstd) {
  const int n = HW * cs;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / cs;
    const int c = g * cs + i - p * cs;
    const float v = to_f32(x[(long long)p * C + c]);
    s1 += v;
    s2 += v * v;
  }
  block_sum2(s1, s2);
  mean = s1 / n;
  const float var = fmaxf(s2 / n - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

// gates (B, HW, 2C), h (B, HW, C) -> z, rh (B, HW, C); grid (B, G).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_gates_kernel(const T* __restrict__ gates, const T* __restrict__ h,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ z,
                     T* __restrict__ rh, int HW, int C, int G, float eps) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int C2 = 2 * C;
  const int cs = C2 / G;
  const T* xs = gates + (long long)b * HW * C2;
  const long long hbase = (long long)b * HW * C;
  float mean, rstd;
  group_moments(xs, HW, C2, cs, g, eps, mean, rstd);

  const int n = HW * cs;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / cs;
    const int c = g * cs + i - p * cs;
    const float v = to_f32(xs[(long long)p * C2 + c]);
    const float gn = (v - mean) * rstd * scale[c] + bias[c];
    const float sig = 1.f / (1.f + expf(-gn));
    if (c < C) {
      z[hbase + (long long)p * C + c] = from_f32<T>(sig);
    } else {
      const long long o = hbase + (long long)p * C + (c - C);
      rh[o] = from_f32<T>(sig * to_f32(h[o]));
    }
  }
}

// cand, z, h (B, HW, C) -> out (B, HW, C); grid (B, G).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_blend_kernel(const T* __restrict__ cand, const T* __restrict__ z,
                     const T* __restrict__ h, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int HW, int C, int G, float eps) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int cs = C / G;
  const long long base = (long long)b * HW * C;
  float mean, rstd;
  group_moments(cand + base, HW, C, cs, g, eps, mean, rstd);

  const int n = HW * cs;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / cs;
    const int c = g * cs + i - p * cs;
    const long long o = base + (long long)p * C + c;
    const float gn = (to_f32(cand[o]) - mean) * rstd * scale[c] + bias[c];
    const float cv = tanhf(gn);
    const float zv = to_f32(z[o]);
    const float hv = to_f32(h[o]);
    out[o] = from_f32<T>((1.f - zv) * hv + zv * cv);
  }
}

}  // namespace

extern "C" int odek_gru_gates(const void* gates, const void* h,
                              const void* scale, const void* bias, void* z,
                              void* rh, int B, int HW, int C, int G, float eps,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, G);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == odek::kF32) {
    gru_gates_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(gates), static_cast<const float*>(h), sc, bi,
        static_cast<float*>(z), static_cast<float*>(rh), HW, C, G, eps);
  } else if (dtype == odek::kBF16) {
    using bf = __nv_bfloat16;
    gru_gates_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(gates), static_cast<const bf*>(h), sc, bi,
        static_cast<bf*>(z), static_cast<bf*>(rh), HW, C, G, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int odek_gru_blend(const void* cand, const void* z, const void* h,
                              const void* scale, const void* bias, void* out,
                              int B, int HW, int C, int G, float eps,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, G);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == odek::kF32) {
    gru_blend_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(cand), static_cast<const float*>(z),
        static_cast<const float*>(h), sc, bi, static_cast<float*>(out), HW, C,
        G, eps);
  } else if (dtype == odek::kBF16) {
    using bf = __nv_bfloat16;
    gru_blend_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(cand), static_cast<const bf*>(z),
        static_cast<const bf*>(h), sc, bi, static_cast<bf*>(out), HW, C, G,
        eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
