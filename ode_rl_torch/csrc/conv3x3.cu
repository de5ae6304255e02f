// K1 and K2: the 3x3 stride-1 SAME convolution of the ODE field ConvNet,
// NHWC x HWIO -> NHWC, as an implicit-im2col GEMM.
//
// Replaces (Pallas, TPU):
//   K1  ode_rl_tpu/ops/conv3x3.py::_fwd_kernel (via _pallas_fwd), also
//       used for dx with the spatially flipped, channel-transposed weights;
//   K2  ode_rl_tpu/ops/conv3x3.py::_wgrad_kernel (via _pallas_wgrad).
//
// What bounds it on the H100. At the flagship shape (x (128,16,16,64),
// w (576,64)) one call is M = B*H*W = 32,768 rows, K = 9*Cin = 576,
// N = Cout = 64: 2.4 GFLOP against about 8 MB of activations in and out.
// On the tensor cores both bounds are a few microseconds, so a fast
// version is a tensor-core GEMM fed by TMA. These first kernels are
// simple and right instead: fp32 FMA from shared memory, so they are
// bound by the FMA issue rate and shared-memory bandwidth of the SMs,
// far from either roofline. wgmma and TMA are later work.
//
// Design. A block owns a 64 x 64 output tile; 256 threads each hold a
// 4 x 4 fp32 accumulator. The A tile (patches) is gathered straight from
// the NHWC input with the SAME bounds computed in the kernel (zeros
// outside), so no padded copy is made; the B tile comes from the weights
// laid out as (9*Cin, Cout) in HWIO order, which is kernel.reshape(9*Cin,
// Cout), the JAX layout. Neighbouring threads load neighbouring input
// channels, so the gathers coalesce.
//
// K2 cannot carry the TPU kernel's accumulation across an in-order grid:
// Hopper blocks run in parallel and in no order. It is split-K instead:
// block s sums its own range of rows into scratch (S, 9*Cin, Cout) fp32,
// and a second kernel sums the S partials in a fixed order. No atomics;
// the result is deterministic.

#include "common.cuh"

namespace {

using odek::from_f32;
using odek::to_f32;

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 sub-tile
constexpr int kTile = 64;      // output tile edge (pixels or channels)
constexpr int kChunk = 16;     // reduction step held in shared memory
constexpr int kPad = 4;        // row padding of the shared tiles

// Element (m, k) of the implicit im2col matrix: m is an output pixel
// (b, y, x), k = tap * Cin + ci with tap = dy * 3 + dx.
template <typename T>
__device__ __forceinline__ float patch_at(const T* __restrict__ x,
                                          long long m, int k, long long M,
                                          int H, int W, int Cin) {
  if (m >= M || k >= 9 * Cin) return 0.f;
  const int tap = k / Cin;
  const int ci = k - tap * Cin;
  const int dy = tap / 3;
  const int dx = tap - dy * 3;
  const long long hw = (long long)H * W;
  const long long b = m / hw;
  const int r = (int)(m - b * hw);
  const int y = r / W + dy - 1;
  const int xx = r % W + dx - 1;
  if (y < 0 || y >= H || xx < 0 || xx >= W) return 0.f;
  return to_f32(x[((b * H + y) * W + xx) * Cin + ci]);
}

// K1: out (M, Cout) = patches (M, 9*Cin) . w (9*Cin, Cout).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ out, int B, int H, int W, int Cin,
                       int Cout) {
  __shared__ float a_s[kChunk][kTile + kPad];  // [k][m]
  __shared__ float b_s[kChunk][kTile + kPad];  // [k][n]
  const long long M = (long long)B * H * W;
  const int K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
      const int kk = i % kChunk;
      const int mm = i / kChunk;
      a_s[kk][mm] = patch_at(x, m0 + mm, k0 + kk, M, H, W, Cin);
    }
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int kk = i / kTile;
      const int nn = i % kTile;
      const int k = k0 + kk;
      const int n = n0 + nn;
      b_s[kk][nn] =
          (k < K && n < Cout) ? to_f32(w[(long long)k * Cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) out[m * Cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// K2, pass 1: scratch[s] (9*Cin, Cout) = patches[rows of s]^T . g[rows of s].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_wgrad_partial_kernel(const T* __restrict__ x,
                                 const T* __restrict__ g,
                                 float* __restrict__ scratch, int B, int H,
                                 int W, int Cin, int Cout,
                                 long long rows_per_split) {
  __shared__ float a_s[kChunk][kTile + kPad];  // [m][k]
  __shared__ float g_s[kChunk][kTile + kPad];  // [m][n]
  const long long M = (long long)B * H * W;
  const int K = 9 * Cin;
  const int k0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const long long m_begin = (long long)blockIdx.z * rows_per_split;
  const long long m_end =
      m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long mb = m_begin; mb < m_end; mb += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int mm = i / kTile;
      const int kk = i % kTile;
      const long long m = mb + mm;
      a_s[mm][kk] = m < m_end ? patch_at(x, m, k0 + kk, M, H, W, Cin) : 0.f;
    }
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int mm = i / kTile;
      const int nn = i % kTile;
      const long long m = mb + mm;
      const int n = n0 + nn;
      g_s[mm][nn] =
          (m < m_end && n < Cout) ? to_f32(g[m * Cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kChunk; ++mm) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[mm][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = g_s[mm][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* part = scratch + (long long)blockIdx.z * K * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) part[(long long)k * Cout + n] = acc[i][j];
    }
  }
}

// K2, pass 2: dw = sum over s of scratch[s], in the order s = 0, 1, ...
__global__ void splitk_sum_kernel(const float* __restrict__ scratch,
                                  float* __restrict__ dw, int splits,
                                  long long size) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += scratch[(long long)s * size + idx];
  dw[idx] = sum;
}

unsigned int ceil_div(long long a, long long b) {
  return (unsigned int)((a + b - 1) / b);
}

template <typename T>
void launch_fwd(const void* x, const void* w, void* out, int B, int H, int W,
                int Cin, int Cout, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid(ceil_div(M, kTile), ceil_div(Cout, kTile));
  conv3x3_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      B, H, W, Cin, Cout);
}

template <typename T>
void launch_wgrad(const void* x, const void* g, float* scratch, float* dw,
                  int B, int H, int W, int Cin, int Cout, int splits,
                  long long rows_per_split, cudaStream_t stream) {
  const int K = 9 * Cin;
  const dim3 grid(ceil_div(K, kTile), ceil_div(Cout, kTile), splits);
  conv3x3_wgrad_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), scratch, B, H, W,
      Cin, Cout, rows_per_split);
  const long long size = (long long)K * Cout;
  splitk_sum_kernel<<<ceil_div(size, 256), 256, 0, stream>>>(scratch, dw,
                                                              splits, size);
}

}  // namespace

// x (B,H,W,Cin), w (9*Cin, Cout), out (B,H,W,Cout); all of one dtype.
extern "C" int odek_conv3x3_fwd(const void* x, const void* w, void* out,
                                int B, int H, int W, int Cin, int Cout,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == odek::kF32) {
    launch_fwd<float>(x, w, out, B, H, W, Cin, Cout, s);
  } else if (dtype == odek::kBF16) {
    launch_fwd<__nv_bfloat16>(x, w, out, B, H, W, Cin, Cout, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (B,H,W,Cin), g (B,H,W,Cout) of one dtype; scratch (splits, 9*Cin, Cout)
// and dw (9*Cin, Cout) fp32. Rows [s*rows_per_split, (s+1)*rows_per_split)
// of the B*H*W rows go to split s.
extern "C" int odek_conv3x3_wgrad(const void* x, const void* g, void* scratch,
                                  void* dw, int B, int H, int W, int Cin,
                                  int Cout, int splits,
                                  long long rows_per_split, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  float* out = static_cast<float*>(dw);
  if (dtype == odek::kF32) {
    launch_wgrad<float>(x, g, scr, out, B, H, W, Cin, Cout, splits,
                        rows_per_split, s);
  } else if (dtype == odek::kBF16) {
    launch_wgrad<__nv_bfloat16>(x, g, scr, out, B, H, W, Cin, Cout, splits,
                                rows_per_split, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
