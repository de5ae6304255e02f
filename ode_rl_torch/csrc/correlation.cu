// K5, K6 and K7: the FlowNetC cost volume and its two gradients.
//
// Replaces (Pallas, TPU):
//   K5  ode_rl_tpu/ops/correlation.py::_corr_kernel (via
//       _correlation_pallas): out[b,y,x,i] = mean_c f1[b,y,x,c] *
//       f2[b, y+oy_i, x+ox_i, c], zero where the window leaves the image;
//   K6  ::_bwd_f1_kernel (via _correlation_bwd_pallas): the gradient of f1;
//   K7  ::_bwd_f2_kernel: the gradient of f2.
//
// Displacement i = iy*n + ix (n = 2d/stride + 1) has the offset
// (oy, ox) = (iy*stride - d, ix*stride - d): displacement-major, as the
// TPU kernel and the reference's CUDA op order their channels.
//
// Layout. K5 writes NHWC (B, H, W, n*n), not the TPU's (B, Dy, Dx, H, W):
// its consumer is the channel concat in front of FlowNetC's conv3_1, and
// NHWC is what that concat and the cuDNN conv after it read, so no
// transpose is paid on either side. K6 and K7 read the cotangent in the
// same layout.
//
// What bounds them on the H100. At the FlowNetC bench shape (f1, f2
// (256, 8, 8, 256), d = 20, stride 2, bf16) only 7 x 7 of the 441 windows
// overlap the 8 x 8 map, so K5 reads 8 MB of f2 from L2 and writes 14 MB
// of mostly zeros: bytes. At the FlyingChairs feature shape
// (8, 48, 64, 256) nearly every window overlaps, and each f2 pixel is read
// by up to 441 output pixels: L2 bandwidth, about 5 GB of window reads.
// Tiling f2's neighbourhood in shared memory is later work.
//
// Design.
//   K5: one block per output pixel (b, y, x). The block stages f1's C
//       channels in shared memory as fp32; its 8 warps share out the
//       windows that overlap the map, each warp's lanes read neighbouring
//       channels of the f2 window (coalesced), and a fixed-order warp
//       butterfly sums them into a row of n*n outputs in shared memory,
//       zero for the windows in the padding. The block then writes the
//       row, coalesced.
//   K6: a gather, one thread per (b, y, x, c): sum over the in-bounds
//       displacements of g[b,y,x,i] * f2[b, y+oy, x+ox, c], / C.
//   K7: the TPU kernel scatters into overlapping windows of the padded f2,
//       which needs atomics on a GPU. Here it is a gather instead, one
//       thread per unpadded (b, y', x', c): the sum over the displacements
//       whose source pixel (y'-oy, x'-ox) is in bounds of
//       g[b, y'-oy, x'-ox, i] * f1[b, y'-oy, x'-ox, c], / C. No atomics, so
//       the result is bit-reproducible, and the padded border that the TPU
//       kernel computes and slices away is never computed.
// All three accumulate in fp32 in a fixed order and round once to the
// input dtype. (The Pallas backward kernels round their bf16 accumulator
// after every dy step, K6, or every (dy, dx) step, K7.)

#include "common.cuh"

namespace {

using odek::from_f32;
using odek::to_f32;
using odek::warp_sum;

constexpr int kFwdWarps = 8;
constexpr int kThreads = 256;

struct CorrShape {
  int B, H, W, C, d, stride, n;
};

__device__ __forceinline__ int ceil_div_pos(int a, int b) {
  return a > 0 ? (a + b - 1) / b : 0;
}

// Displacement indices [lo, hi] along one axis for which the window pixel
// p + i*stride - d of output pixel p lies in [0, size).
__device__ __forceinline__ void window_range(int p, int size,
                                             const CorrShape& s, int& lo,
                                             int& hi) {
  lo = ceil_div_pos(s.d - p, s.stride);
  hi = min(s.n - 1, (size - 1 - p + s.d) / s.stride);
}

// Displacement indices [lo, hi] along one axis for which the source pixel
// q - (i*stride - d) of f2 pixel q lies in [0, size).
__device__ __forceinline__ void source_range(int q, int size,
                                             const CorrShape& s, int& lo,
                                             int& hi) {
  lo = ceil_div_pos(q + s.d - size + 1, s.stride);
  hi = min(s.n - 1, (q + s.d) / s.stride);
}

// f1, f2 (B, H, W, C) -> out (B, H, W, n*n); grid B*H*W, C + n*n floats
// of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(32 * kFwdWarps)
    corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                    T* __restrict__ out, CorrShape s) {
  extern __shared__ float smem[];
  float* f1s = smem;         // f1[b, y, x, :] in fp32
  float* outs = smem + s.C;  // this pixel's n*n outputs
  const long long pix = blockIdx.x;
  const int x = (int)(pix % s.W);
  const int y = (int)((pix / s.W) % s.H);
  const long long b = pix / ((long long)s.H * s.W);
  const int nd = s.n * s.n;
  for (int c = threadIdx.x; c < s.C; c += blockDim.x) {
    f1s[c] = to_f32(f1[pix * s.C + c]);
  }
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    outs[i] = 0.f;  // windows in the zero padding
  }
  __syncthreads();

  // Only the windows that overlap the map are computed: 7 x 7 of the
  // 21 x 21 at the bench shape.
  int iy0, iy1, ix0, ix1;
  window_range(y, s.H, s, iy0, iy1);
  window_range(x, s.W, s, ix0, ix1);
  const int nx = ix1 - ix0 + 1;
  const int n_valid = (iy1 - iy0 + 1) * nx;
  const int lane = threadIdx.x % 32;
  const T* f2b = f2 + b * s.H * s.W * s.C;
  for (int k = threadIdx.x / 32; k < n_valid; k += kFwdWarps) {
    const int iy = iy0 + k / nx;
    const int ix = ix0 + k % nx;
    const int yy = y + iy * s.stride - s.d;
    const int xx = x + ix * s.stride - s.d;
    const T* win = f2b + ((long long)yy * s.W + xx) * s.C;
    float acc = 0.f;
    for (int c = lane; c < s.C; c += 32) {
      acc += f1s[c] * to_f32(win[c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      outs[iy * s.n + ix] = acc / (float)s.C;
    }
  }
  __syncthreads();
  T* o = out + pix * nd;
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    o[i] = from_f32<T>(outs[i]);  // coalesced
  }
}

// g (B, H, W, n*n), f2 (B, H, W, C) -> gf1 (B, H, W, C); one thread per
// element of gf1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    corr_bwd_f1_kernel(const T* __restrict__ g, const T* __restrict__ f2,
                       T* __restrict__ gf1, CorrShape s) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)s.B * s.H * s.W * s.C) return;
  const int c = (int)(t % s.C);
  const long long pix = t / s.C;
  const int x = (int)(pix % s.W);
  const int y = (int)((pix / s.W) % s.H);
  const long long b = pix / ((long long)s.H * s.W);
  const T* gp = g + pix * s.n * s.n;
  const T* f2b = f2 + b * s.H * s.W * s.C + c;
  int iy0, iy1, ix0, ix1;
  window_range(y, s.H, s, iy0, iy1);
  window_range(x, s.W, s, ix0, ix1);
  float acc = 0.f;
  for (int iy = iy0; iy <= iy1; ++iy) {
    const int yy = y + iy * s.stride - s.d;
    for (int ix = ix0; ix <= ix1; ++ix) {
      const int xx = x + ix * s.stride - s.d;
      acc += to_f32(gp[iy * s.n + ix]) *
             to_f32(f2b[((long long)yy * s.W + xx) * s.C]);
    }
  }
  gf1[t] = from_f32<T>(acc / (float)s.C);
}

// g (B, H, W, n*n), f1 (B, H, W, C) -> gf2 (B, H, W, C); one thread per
// element of gf2, gathering from the output pixels whose windows cover it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    corr_bwd_f2_kernel(const T* __restrict__ g, const T* __restrict__ f1,
                       T* __restrict__ gf2, CorrShape s) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)s.B * s.H * s.W * s.C) return;
  const int c = (int)(t % s.C);
  const long long pix = t / s.C;
  const int x = (int)(pix % s.W);
  const int y = (int)((pix / s.W) % s.H);
  const long long b = pix / ((long long)s.H * s.W);
  const long long bpix = b * s.H * s.W;
  const int nd = s.n * s.n;
  int iy0, iy1, ix0, ix1;
  source_range(y, s.H, s, iy0, iy1);
  source_range(x, s.W, s, ix0, ix1);
  float acc = 0.f;
  for (int iy = iy0; iy <= iy1; ++iy) {
    const int ys = y + s.d - iy * s.stride;
    for (int ix = ix0; ix <= ix1; ++ix) {
      const long long src = bpix + (long long)ys * s.W + x + s.d -
                            ix * s.stride;
      acc += to_f32(g[src * nd + iy * s.n + ix]) * to_f32(f1[src * s.C + c]);
    }
  }
  gf2[t] = from_f32<T>(acc / (float)s.C);
}

CorrShape make_shape(int B, int H, int W, int C, int d, int stride) {
  return CorrShape{B, H, W, C, d, stride, 2 * d / stride + 1};
}

unsigned int elementwise_blocks(const CorrShape& s) {
  const long long total = (long long)s.B * s.H * s.W * s.C;
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int odek_correlation_fwd(const void* f1, const void* f2, void* out,
                                    int B, int H, int W, int C, int d,
                                    int stride, int dtype, void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)((long long)B * H * W);
  const size_t smem = (size_t)(C + s.n * s.n) * sizeof(float);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    corr_fwd_kernel<T><<<blocks, 32 * kFwdWarps, smem, st>>>(
        static_cast<const T*>(f1), static_cast<const T*>(f2),
        static_cast<T*>(out), s);
  });
}

extern "C" int odek_correlation_bwd_f1(const void* g, const void* f2,
                                       void* gf1, int B, int H, int W, int C,
                                       int d, int stride, int dtype,
                                       void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    corr_bwd_f1_kernel<T><<<elementwise_blocks(s), kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(f2),
        static_cast<T*>(gf1), s);
  });
}

extern "C" int odek_correlation_bwd_f2(const void* g, const void* f1,
                                       void* gf2, int B, int H, int W, int C,
                                       int d, int stride, int dtype,
                                       void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    corr_bwd_f2_kernel<T><<<elementwise_blocks(s), kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(f1),
        static_cast<T*>(gf2), s);
  });
}
