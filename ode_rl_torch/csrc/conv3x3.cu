// K1 and K2: the 3x3 stride-1 SAME convolution of the ODE field ConvNet,
// NHWC x HWIO -> NHWC, as an implicit-im2col GEMM.
//
// Replaces (Pallas, TPU):
//   K1  ode_rl_tpu/ops/conv3x3.py::_fwd_kernel (via _pallas_fwd), also
//       used for dx with the spatially flipped, channel-transposed weights;
//   K2  ode_rl_tpu/ops/conv3x3.py::_wgrad_kernel (via _pallas_wgrad).
//
// What bounds them on the H100. At the flagship shape (x (128,16,16,64),
// w (576,64)) one K1 call is M = B*H*W = 32,768 rows, K = 9*Cin = 576,
// N = Cout = 64: 2.4 GFLOP against about 8.5 MB of activations in and out,
// a few microseconds on either bound.
//
// K1 has two kernels; ops/conv3x3.py::uses_tensor_cores picks one.
//
// * conv3x3_fwd_tc_kernel (bf16, Cin % 16 == 0, Cout % 16 == 0, Cout <= 256,
//   the weights, two halo stages and the output staging within the 227 KB
//   of shared memory): the tensor-core K1 (section "Tensor-core K1" below),
//   about 7 us a launch at the flagship shape against cuDNN's 11.
// * conv3x3_fwd_kernel (everything else, fp32 included): fp32 FMA from
//   shared memory, so bound by the FMA issue rate and shared-memory
//   bandwidth of the SMs, far from either roofline. A block owns a 64 x 64
//   output tile; 256 threads each hold a 4 x 4 fp32 accumulator. The A
//   tile (patches) is gathered straight from the NHWC input with the SAME
//   bounds computed in the kernel (zeros outside), so no padded copy is
//   made; the B tile comes from the weights laid out as (9*Cin, Cout) in
//   HWIO order, which is kernel.reshape(9*Cin, Cout), the JAX layout.
//
// K2 (dW = patches^T . g) is the same 2.4 GFLOP at the flagship shape,
// against 8.5 MB (x and g in bf16, dW in fp32): 2.45 us at 989 TFLOP/s,
// 2.55 us at 3.35 TB/s, so bound by the bytes, barely. It cannot carry the
// TPU kernel's accumulation across an in-order grid: Hopper blocks run in
// parallel and in no order. Every block sums its own pixels into a
// partial, and the partials are summed in a fixed order; no atomics on the
// data, so the result is deterministic. ops/conv3x3.py::
// wgrad_uses_tensor_cores picks one of two kernels.
//
// * conv3x3_wgrad_tc_kernel (bf16, Cin % 64 == 0, Cout % 64 == 0): the
//   tensor-core K2 (section "Tensor-core K2" below): TMA halo and
//   cotangent tiles, wgmma with pixels as the reduction axis, the partials
//   summed after a grid sync in the same cooperative launch. About 13
//   us a launch at the flagship shape against cuDNN's weight gradient's
//   19.5; the partials' round trip through L2 and the grid sync are most
//   of the gap to the bound.
// * conv3x3_wgrad_partial_kernel + splitk_sum_kernel (everything else,
//   fp32 included): fp32 FMA, block s sums its own range of rows into
//   scratch (S, 9*Cin, Cout) fp32, and a second kernel sums the S partials
//   in a fixed order. Bound by the FMA issue rate and the per-element
//   gather (about 310 us at the flagship shape).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using odek::allow_max_smem;
using odek::fence_operands;
using odek::from_f32;
using odek::k_major_desc;
using odek::mbar_expect_tx;
using odek::mbar_init;
using odek::mbar_wait;
using odek::mn_major_desc;
using odek::smem_u32;
using odek::swizzle;
using odek::to_f32;
using odek::warpgroup_sync;
using odek::wgmma_commit;
using odek::wgmma_fence;
using odek::wgmma_m64n64k16;
using odek::wgmma_wait_all;
using odek::wgmma_wait_one;

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

// K1 (SIMT): out (M, Cout) = patches (M, 9*Cin) . w (9*Cin, Cout).
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

// ---------------------------------------------------------------------------
// Tensor-core K1 (bf16).
//
// Design. Persistent blocks, one per SM, walk over output tiles of one
// image, 8 rows by TW = 8, 16 or 32 pixels (8 x 16 at the flagship's
// 16 x 16 maps), cut into 8 x 8 blocks of 64 output pixels.
//
// * The weights stay resident in shared memory: each block loads the whole
//   (9*Cin, Cout) matrix once by TMA (72 KB at the flagship), as column
//   blocks of NT = 64 channels (128-byte swizzle) or NT = 16 (32-byte
//   swizzle), each a region of 9*Cin rows.
// * The input halo of a tile, 10 x (TW+2) x Cin, is one set of 4-D TMA
//   boxes at (y0-1, x0-1): the boxes' out-of-bounds elements are zeros, so
//   SAME padding and ragged H and W need no branch. Channels go in chunks
//   of CW = 64, 32 or 16 (swizzle 128, 64 or 32 bytes: one pixel of a chunk
//   is one swizzle row). Two halo stages, one mbarrier each: the load of
//   the next tile runs under the products of this one.
// * Implicit im2col in the operand descriptor. The 64 pixels of a block
//   are the M rows of a wgmma, 8 image rows of 8. For tap (dy, dx) the 8
//   pixels of one image row are 8 consecutive halo pixels, that is 8
//   consecutive swizzle rows, and the next image row lies one halo row
//   ((TW+2) * CW * 2 bytes) on: a K-major operand with that stride between
//   its 8-row groups. So A is read straight from the halo by a descriptor
//   whose start address moves with the tap and the channels: no im2col
//   copy, no registers, no ldmatrix. The start is not 1 KB aligned in
//   general; the hardware swizzles the absolute address, as TMA wrote it,
//   so the descriptor's base offset stays 0.
// * B, the tap's 16 x NT slice of the weights: an MN-major descriptor (Cout
//   is the contiguous axis of w2d).
// * The 9 * Cin/16 wgmma.m64nNTk16 of a block go out back to back in one
//   commit group, fp32 sums in registers. The loop is unrolled at compile
//   time for Cin = 16, 32 and 64 (KS = Cin/16 = 1, 2, 4): in a runtime
//   loop ptxas waits for each wgmma before issuing the next. Other widths
//   take that slower runtime loop (KS = 0).
// * Two warpgroups: warpgroup w owns blocks w, w + 2, ... of the tile.
// * Epilogue: round once to bf16, write the 8 x 8 x NT block into a
//   staging buffer in shared memory with the output tensor map's swizzle,
//   and store it with one TMA store, which clips what lies outside the
//   image. Storing the fragments directly, 4 bytes a lane, took a third
//   of the tile's time.
// * Deterministic: every output is summed by one warpgroup in a fixed
//   order (taps, then channels). No split-K, no atomics.
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;        // two warpgroups
constexpr int kTcTileRows = 8;         // a tile is 8 rows by TW = 8, 16, 32
// Dynamic shared memory a block may ask for: the H100's 232,448 bytes
// less 64 for the kernel's static barriers.
constexpr int kTcMaxSmem = 232448 - 64;
constexpr int kTcWeightBoxRows = 144;  // 9 * 16 divides 9 * Cin

__host__ __device__ constexpr int round1k(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// Shared-memory plan of one launch; mirrors ops/conv3x3.py::_tc_smem_bytes.
struct TcPlan {
  int tw, halo_w, halo_h;
  int cw;              // channels per halo chunk (64, 32 or 16)
  int n_chunks;        // Cin / cw
  int chunk_bytes;     // one chunk of one stage, 1 KB aligned
  int stage_bytes;     // n_chunks * chunk_bytes
  int nt;              // output channels per wgmma (64 or 16)
  int w_region_bytes;  // 9*Cin rows of nt channels, 1 KB aligned
  int w_bytes;         // Cout / nt regions
  int out_bytes;       // one warpgroup's 8 x 8 x nt staging buffer
  int smem_bytes;      // weights + 2 stages + 2 staging + 1 KB to align
};

TcPlan tc_plan(int Cin, int Cout, int tw) {
  TcPlan p;
  p.tw = tw;
  p.halo_w = tw + 2;
  p.halo_h = kTcTileRows + 2;
  p.cw = Cin % 64 == 0 ? 64 : (Cin % 32 == 0 ? 32 : 16);
  p.n_chunks = Cin / p.cw;
  p.chunk_bytes = round1k(p.halo_h * p.halo_w * p.cw * 2);
  p.stage_bytes = p.n_chunks * p.chunk_bytes;
  p.nt = Cout % 64 == 0 ? 64 : 16;
  p.w_region_bytes = round1k(9 * Cin * p.nt * 2);
  p.w_bytes = (Cout / p.nt) * p.w_region_bytes;
  p.out_bytes = round1k(64 * p.nt * 2);
  p.smem_bytes = p.w_bytes + 2 * p.stage_bytes + 2 * p.out_bytes + 1024;
  return p;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The TMA stores this thread issued have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <int NT>
struct Wgmma;

// D (64 x 64, fp32) += A (64 x 16, K-major) . B (16 x 64, MN-major), both
// bf16 in shared memory.
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n64k16<0, 1>(d, a, b);
  }
};

// D (64 x 16) += A (64 x 16) . B (16 x 16).
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, 1, 1, 1, 0, 1;"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b));
  }
};

// The products of one 8 x 8 block and one column block: a_blk addresses
// the block's tap (0, 0) in the halo stage, b the column block's weights;
// descriptors step by adding to their start address (16-byte units): a
// halo row (row_step) or pixel (col_step) for the tap, 32 bytes (16
// channels) within a chunk, a chunk; 16 weight rows a step.
template <int NT, int KS>
__device__ __forceinline__ void block_products(float (&acc)[NT / 2],
                                               uint64_t a_blk, uint64_t b,
                                               uint32_t row_step,
                                               uint32_t col_step,
                                               const TcPlan& p) {
  constexpr uint64_t b_step = (16 * NT * 2) >> 4;
  if constexpr (KS > 0) {  // Cin = 16 * KS: one chunk, 2 units a step
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t a_tap = a_blk + (tap / 3) * row_step + (tap % 3) * col_step;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        Wgmma<NT>::mma(acc, a_tap + 2 * j, b + (tap * KS + j) * b_step);
      }
    }
  } else {
    const int steps_per_chunk = p.cw / 16;
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t a_tap = a_blk + (tap / 3) * row_step + (tap % 3) * col_step;
      for (int c = 0; c < p.n_chunks; ++c) {
        for (int j = 0; j < steps_per_chunk; ++j) {
          Wgmma<NT>::mma(acc, a_tap + c * (p.chunk_bytes >> 4) + 2 * j, b);
          b += b_step;
        }
      }
    }
  }
}

template <int NT, int KS>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv3x3_fwd_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap out_map, int B,
                          int H, int W, int Cin, int Cout, TcPlan p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // weights, halo stage 0, 1
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t w_base = base;
  const uint32_t halo_base = w_base + p.w_bytes;
  const uint32_t out_base = halo_base + 2 * p.stage_bytes;
  const uint32_t bar_w = smem_u32(&bars[0]);
  const int tid = threadIdx.x;

  const int tiles_x = (W + p.tw - 1) / p.tw;
  const int tiles_y = (H + kTcTileRows - 1) / kTcTileRows;
  const int tiles_img = tiles_x * tiles_y;
  const int n_tiles = B * tiles_img;
  const int cwb = p.cw * 2;  // bytes of one pixel of a halo chunk
  const uint32_t halo_tx = p.n_chunks * p.halo_h * p.halo_w * cwb;

  auto tile_origin = [&](int tile, int& b, int& y0, int& x0) {
    b = tile / tiles_img;
    const int r = tile - b * tiles_img;
    y0 = (r / tiles_x) * kTcTileRows;
    x0 = (r % tiles_x) * p.tw;
  };
  auto load_halo = [&](int tile, int stage) {
    int b, y0, x0;
    tile_origin(tile, b, y0, x0);
    const uint32_t bar = smem_u32(&bars[1 + stage]);
    const uint32_t dst = halo_base + stage * p.stage_bytes;
    mbar_expect_tx(bar, halo_tx);
    for (int c = 0; c < p.n_chunks; ++c) {
      tma_load_4d(dst + c * p.chunk_bytes, &x_map, bar, c * p.cw, x0 - 1,
                  y0 - 1, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_w, 9 * Cin * Cout * 2);
    for (int nb = 0; nb < Cout / NT; ++nb) {
      for (int k0 = 0; k0 < 9 * Cin; k0 += kTcWeightBoxRows) {
        tma_load_2d(w_base + nb * p.w_region_bytes + k0 * NT * 2, &w_map,
                    bar_w, nb * NT, k0);
      }
    }
    for (int s = 0; s < 2; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < n_tiles) load_halo(tile, s);
    }
  }

  const int wg = tid / 128;
  const bool leader = tid % 128 == 0;  // issues the warpgroup's TMA stores
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // Accumulator fragment: rows g and g + 8 of this warp's 16, that is
  // pixels (2 * warp, g) and (2 * warp + 1, g) of the 8 x 8 block; columns
  // 8j + 2t and 8j + 2t + 1 of the column block.
  const int g = lane / 4;
  const int t4 = lane % 4;
  const uint32_t out_stage = out_base + wg * p.out_bytes;
  const uint32_t row_step = (p.halo_w * cwb) >> 4;
  const uint32_t col_step = cwb >> 4;
  const uint64_t a_layout = p.cw == 64 ? 1 : (p.cw == 32 ? 2 : 3);

  mbar_wait(bar_w, 0);
  int iter = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++iter) {
    const int stage = iter & 1;
    mbar_wait(smem_u32(&bars[1 + stage]), (iter >> 1) & 1);
    const uint32_t stage_base = halo_base + stage * p.stage_bytes;
    int b, y0, x0;
    tile_origin(tile, b, y0, x0);

    for (int blk = wg; blk < p.tw / 8; blk += 2) {
      const uint64_t a_blk =
          k_major_desc(stage_base + blk * 8 * cwb, row_step << 4, a_layout);
      for (int nb = 0; nb < Cout / NT; ++nb) {
        float acc[NT / 2];
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
        fence_operands(acc);
        wgmma_fence();
        block_products<NT, KS>(
            acc, a_blk, mn_major_desc(w_base + nb * p.w_region_bytes, NT),
            row_step, col_step, p);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(acc);

        // The staging buffer is free once the last store has read it.
        if (leader) tma_store_wait_read();
        warpgroup_sync(wg);
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          const int pixel = (2 * warp + half_row) * 8 + g;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[4 * j + 2 * half_row], acc[4 * j + 2 * half_row + 1]);
            const uint32_t off = swizzle(
                (pixel * NT + 8 * j + 2 * t4) * 2, NT * 2);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(out_stage + off),
                         "r"(*reinterpret_cast<uint32_t*>(&v))
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        warpgroup_sync(wg);
        if (leader) {
          tma_store_4d(&out_map, out_stage, nb * NT, x0 + blk * 8, y0, b);
        }
      }
    }

    // Every warp is done with this stage: refill it with the tile two on.
    __syncthreads();
    if (tid == 0) {
      const int next = tile + 2 * gridDim.x;
      if (next < n_tiles) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_halo(next, stage);
      }
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that
// this library links no libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

CUtensorMapSwizzle swizzle_mode(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// Codes returned on top of cudaError_t: a tensor map was refused
// (kTcMapError + its CUresult), or cuTensorMapEncodeTiled is missing.
constexpr int kTcMapError = 10000;

// A bf16 NHWC tensor (B, H, W, C) as a TMA map with box (box_c, box_w,
// box_h, 1), swizzled by box_c * 2 bytes.
CUresult encode_nhwc(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int B, int H, int W, int C, int box_c, int box_w,
                     int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(box_c * 2),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---------------------------------------------------------------------------
// Tensor-core K2 (bf16): dW (9*Cin, Cout) = patches^T . g, fp32 sums.
//
// Orientation. One wgmma.m64n64k16 per (tap, 16 pixels): M = 64 input
// channels (A: the halo, shifted by the tap), N = 64 output channels (B:
// the cotangent tile), K = 16 pixels. Both operands are read straight from
// the TMA tiles by descriptor, MN-major (channels are the contiguous axis,
// one pixel is one 128-byte swizzle row; the instruction's transpose flags
// say so). Rule: Cin and Cout multiples of 64, so that both M and N are
// whole 64-channel blocks; a wider conv has (Cin/64) * (Cout/64) channel
// pairs, each its own blocks.
//
// * Tiles are 8 image rows by TW = 8, 16 or 32 pixels, as for K1. A K-step
//   is two groups of 8 pixels, each 8 consecutive pixels of one image row:
//   8 consecutive swizzle rows of the g tile and, for tap (dy, dx), of the
//   halo, starting dy halo rows and dx pixels on. The descriptor's stride
//   byte offset is the distance between the two groups: 1 KB (the next 8
//   pixels of the same row, TW >= 16) or one halo row (the next image row,
//   TW = 8, for the halo; 1 KB for g). As for K1, the start address is not
//   1 KB aligned and the base offset stays 0.
// * A block owns one tap row dy of one channel pair over a run of tiles;
//   its three warpgroups own dx = 0, 1, 2, one 64 x 64 fp32 accumulator
//   (32 registers) each. So a block's partial is 48 KB, not the 147 KB of
//   all 9 taps: writing the partials to L2 and reading them back cost
//   more than the products when a block held all 9 taps (PERF.md §6).
// * The halo (10 x (TW+2) x 64) and the g tile (8 x TW x 64) come by 4-D TMA
//   into 2-4 stages; the box elements outside the image are zeros, so SAME
//   padding and ragged tiles (g = 0 there) need no branch. A tile's TW/2
//   wgmmas go out back to back in one commit group (unrolled by TW), and
//   the next tile's group goes out before this one is waited for.
// * Reduction across blocks, in the same launch, deterministic. The launch
//   is cooperative (every block resident at once): block (pair, dy, s)
//   writes its partial (staged in shared memory, 16-byte stores) to
//   scratch[s]; cooperative groups' grid sync; then every block sums a
//   fixed slice of dW over s in a fixed tree (q threads a unit, each a
//   fixed range of s in order, then the q sums in order). No atomics on
//   the data, and the plan (T, S, q) is a function of the shape alone, so
//   two calls are bit-equal.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // three warpgroups, one per tap column dx
constexpr int kWgMaxStages = 4;
// One block's partial: the 3 taps of its row, 64 x 64 fp32 each, in
// 16-byte units; a channel pair's partial is 3 of them (9 taps).
constexpr int kWgRowUnits = 3 * 64 * 64 / 4;
constexpr int kWgPairUnits = 3 * kWgRowUnits;

// Shared-memory plan of the tensor-core K2: at most 231,424 bytes (three
// stages of 8 x 32 tiles), so it fits at every width.
struct WgPlan {
  int tw, halo_w, halo_h;
  int halo_bytes;   // one 64-channel halo, 1 KB aligned
  int stage_bytes;  // halo + the 64-channel g tile, each 1 KB aligned
  int stages;       // as many as fit, 2 to kWgMaxStages
  int smem_bytes;   // the stages or the staged partial, + 1 KB to align
};

WgPlan wg_plan(int tw) {
  WgPlan p;
  p.tw = tw;
  p.halo_w = tw + 2;
  p.halo_h = kTcTileRows + 2;
  p.halo_bytes = round1k(p.halo_h * p.halo_w * 128);
  p.stage_bytes = p.halo_bytes + round1k(kTcTileRows * tw * 128);
  p.stages = std::max(2, std::min(kWgMaxStages,
                                  (kTcMaxSmem - 1024) / p.stage_bytes));
  p.smem_bytes =
      std::max(p.stages * p.stage_bytes, kWgRowUnits * 16) + 1024;
  return p;
}

// The products of one tile for one tap: halo_tap addresses halo pixel
// (dy, dx) of the stage, g_tile the cotangent tile, both MN-major
// (transpose flags 1, 1). The descriptor encoding is the one of
// k_major_desc (128-byte swizzle); descriptors step by adding to their
// start address in 16-byte units (8 a pixel).
template <int TW>
__device__ __forceinline__ void wgrad_tile_products(float (&acc)[32],
                                                    uint32_t halo_tap,
                                                    uint32_t g_tile) {
  constexpr int halo_w = TW + 2;
  // Second group of 8 pixels: the next 8 of the row, or the next row.
  constexpr uint32_t a_sbo = TW == 8 ? halo_w * 128 : 1024;
  const uint64_t a0 = k_major_desc(halo_tap, a_sbo, 1);
  const uint64_t b0 = k_major_desc(g_tile, 1024, 1);
#pragma unroll
  for (int k = 0; k < TW / 2; ++k) {  // 8 * TW pixels, 16 a step
    int py, px;
    if constexpr (TW == 8) {
      py = 2 * k;
      px = 0;
    } else {
      py = k / (TW / 16);
      px = (k % (TW / 16)) * 16;
    }
    wgmma_m64n64k16<1, 1>(acc, a0 + (py * halo_w + px) * 8,
                          b0 + (py * TW + px) * 8);
  }
}

// Sum of unit `col` of the float4 partials s0 .. s1-1, in that order.
__device__ __forceinline__ float4 sum_splits(const float4* __restrict__ src,
                                             long long n4, long long col,
                                             int s0, int s1) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = s0; s < s1; ++s) {
    const float4 v = __ldcg(src + s * n4 + col);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  return acc;
}

template <int TW>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv3x3_wgrad_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap g_map,
                            float* __restrict__ scratch,
                            float* __restrict__ dw, int B, int H, int W,
                            int Cin, int Cout, int splits,
                            int tiles_per_split, WgPlan p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kWgMaxStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x;
  // Block (pair, dy, split): tap row dy of channel pair (mb, nb) over the
  // tiles of run `split`.
  const int split = blockIdx.x % splits;
  const int dy = (blockIdx.x / splits) % 3;
  const int pair = blockIdx.x / splits / 3;
  const int mb = pair / (Cout / 64);  // input-channel block
  const int nb = pair % (Cout / 64);  // output-channel block

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_img = tiles_x * ((H + kTcTileRows - 1) / kTcTileRows);
  const int n_tiles = B * tiles_img;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n = max(t_end - t_begin, 0);
  const uint32_t stage_tx = (p.halo_h * p.halo_w + kTcTileRows * TW) * 128;

  auto load_tile = [&](int i, int stage) {
    const int tile = t_begin + i;
    const int b = tile / tiles_img;
    const int r = tile - b * tiles_img;
    const int y0 = (r / tiles_x) * kTcTileRows;
    const int x0 = (r % tiles_x) * TW;
    const uint32_t bar = smem_u32(&bars[stage]);
    const uint32_t dst = base + stage * p.stage_bytes;
    mbar_expect_tx(bar, stage_tx);
    tma_load_4d(dst, &x_map, bar, mb * 64, x0 - 1, y0 - 1, b);
    tma_load_4d(dst + p.halo_bytes, &g_map, bar, nb * 64, x0, y0, b);
  };

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < p.stages && i < n; ++i) load_tile(i, i);
  }

  const int dx = tid / 128;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // One commit group a tile, and the next tile's group goes out before
  // this one is waited for: the tensor cores do not drain between tiles.
  fence_operands(acc);
  wgmma_fence();
  for (int i = 0; i < n; ++i) {
    const int stage = i % p.stages;
    mbar_wait(smem_u32(&bars[stage]), (i / p.stages) & 1);
    const uint32_t halo = base + stage * p.stage_bytes;
    wgrad_tile_products<TW>(acc, halo + (dy * p.halo_w + dx) * 128,
                            halo + p.halo_bytes);
    wgmma_commit();
    if (i == 0) continue;
    wgmma_wait_one();
    // Every warpgroup is done with tile i - 1: refill its stage.
    __syncthreads();
    const int prev = i - 1;
    if (tid == 0 && prev + p.stages < n) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(prev + p.stages, prev % p.stages);
    }
  }
  wgmma_wait_all();
  fence_operands(acc);
  __syncthreads();

  // This block's partial, staged in shared memory (the stages are free:
  // the loop ends on a __syncthreads) as [dx][ci][16-byte unit u ^ (ci %
  // 16)] of 64 x 64 fp32, then copied out whole with 16-byte stores to
  // taps dy*3 .. dy*3+2 of its pair's region of scratch[split]. Fragment
  // of a thread: rows ci = 16 * warp + g and + 8, output channels 8j + 2t
  // and 8j + 2t + 1. The XOR puts the 8 rows of a store in 8 distinct
  // bank groups.
  float4* staged = reinterpret_cast<float4*>(smem_raw +
                                             (base - smem_u32(smem_raw)));
  {
    const int warp = (tid % 128) / 32;
    const int g = (tid % 32) / 4;
    const int t4 = tid % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = warp * 16 + g + 8 * half;
      float* row = reinterpret_cast<float*>(staged + dx * 1024 + ci * 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int unit = (2 * j + t4 / 2) ^ (ci % 16);
        *reinterpret_cast<float2*>(row + 4 * unit + 2 * (t4 % 2)) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
  __syncthreads();
  const int pairs = (Cin / 64) * (Cout / 64);
  {
    float4* part = reinterpret_cast<float4*>(scratch) +
                   (long long)(split * pairs + pair) * kWgPairUnits +
                   dy * kWgRowUnits;
    for (int i = tid; i < kWgRowUnits; i += kWgThreads) part[i] = staged[i];
  }

  // Every partial is written before any block sums.
  cg::this_grid().sync();

  // This block's slice of the partials' units [c0, c0 + cols), summed over
  // the splits: q threads a unit, thread r over splits [r*S/q, (r+1)*S/q),
  // then the q sums in order of r; each sum goes to its place in dW.
  const long long n4 = (long long)pairs * kWgPairUnits;
  const long long per = (n4 + gridDim.x - 1) / gridDim.x;
  const long long c0 = blockIdx.x * per;
  const int cols = (int)max(min(c0 + per, n4) - c0, 0LL);
  const float4* src = reinterpret_cast<const float4*>(scratch);
  float4* out = reinterpret_cast<float4*>(dw);
  // dW's unit of partial unit e: pair, tap, row ci, swizzled unit.
  auto dw_unit = [&](long long e) {
    const int pr = (int)(e / kWgPairUnits);
    const int rem = (int)(e - (long long)pr * kWgPairUnits);
    const int tap = rem / 1024;
    const int ci = (rem % 1024) / 16;
    const int unit = (rem % 16) ^ (ci % 16);
    const int row = tap * Cin + (pr / (Cout / 64)) * 64 + ci;
    return ((long long)row * Cout + (pr % (Cout / 64)) * 64) / 4 + unit;
  };
  if (cols > kWgThreads / 2) {
    for (int c = tid; c < cols; c += kWgThreads) {
      out[dw_unit(c0 + c)] = sum_splits(src, n4, c0 + c, 0, splits);
    }
  } else if (cols > 0) {
    const int q = min(kWgThreads / cols, splits);
    float4* red = staged;
    if (tid < q * cols) {
      const int c = tid % cols;
      const int r = tid / cols;
      red[r * cols + c] = sum_splits(src, n4, c0 + c, r * splits / q,
                                     (r + 1) * splits / q);
    }
    __syncthreads();
    if (tid < cols) {
      float4 s = red[tid];
      for (int r = 1; r < q; ++r) {
        const float4 v = red[r * cols + tid];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      out[dw_unit(c0 + tid)] = s;
    }
  }
}

using TcKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, int, int,
                          int, int, int, TcPlan);

template <int NT>
TcKernel tc_kernel(int Cin) {
  switch (Cin) {
    case 16: return conv3x3_fwd_tc_kernel<NT, 1>;
    case 32: return conv3x3_fwd_tc_kernel<NT, 2>;
    case 64: return conv3x3_fwd_tc_kernel<NT, 4>;
    default: return conv3x3_fwd_tc_kernel<NT, 0>;
  }
}

// The host's share of a launch counts: the flagship step is host-bound and
// launches K1 hundreds of times. So these two queries run once per process
// (one kind of card per process).
int sm_count() {
  static const int count = [] {
    int device, n;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return count;
}

int launch_fwd_tc(const void* x, const void* w, void* out, int B, int H,
                  int W, int Cin, int Cout, int tw, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (!aligned || Cin % 16 || Cout % 16 || Cout > 256 ||
      (tw != 8 && tw != 16 && tw != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const TcPlan p = tc_plan(Cin, Cout, tw);
  if (p.smem_bytes > kTcMaxSmem) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTcMapError;

  CUtensorMap x_map, w_map, out_map;
  CUresult res = encode_nhwc(encode, &x_map, x, B, H, W, Cin, p.cw,
                             p.halo_w, p.halo_h);
  if (res == CUDA_SUCCESS) {
    res = encode_nhwc(encode, &out_map, out, B, H, W, Cout, p.nt, 8, 8);
  }
  if (res == CUDA_SUCCESS) {  // (9*Cin, Cout) as a 2-D map, box (nt, 144)
    const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)9 * Cin};
    const cuuint64_t strides[1] = {(cuuint64_t)Cout * 2};
    const cuuint32_t box[2] = {(cuuint32_t)p.nt, kTcWeightBoxRows};
    const cuuint32_t ones[2] = {1, 1};
    res = encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                 const_cast<void*>(w), dims, strides, box, ones,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(p.nt * 2),
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (res != CUDA_SUCCESS) return kTcMapError + (int)res;

  const int tiles = B * ((H + kTcTileRows - 1) / kTcTileRows) *
                    ((W + p.tw - 1) / p.tw);
  const int sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;
  const TcKernel kernel = p.nt == 64 ? tc_kernel<64>(Cin) : tc_kernel<16>(Cin);
  const cudaError_t attr =
      allow_max_smem(reinterpret_cast<const void*>(kernel), kTcMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, kTcThreads, p.smem_bytes, stream>>>(
      x_map, w_map, out_map, B, H, W, Cin, Cout, p);
  return 0;
}

using WgKernel = void (*)(CUtensorMap, CUtensorMap, float*, float*, int, int,
                          int, int, int, int, int, WgPlan);

int launch_wgrad_tc(const void* x, const void* g, float* scratch, float* dw,
                    int B, int H, int W, int Cin, int Cout, int tw,
                    int splits, int tiles_per_split, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(scratch) |
                         reinterpret_cast<uintptr_t>(dw)) & 15) == 0;
  const int tiles = B * ((H + kTcTileRows - 1) / kTcTileRows) *
                    ((W + tw - 1) / tw);
  const int grid = (Cin / 64) * (Cout / 64) * 3 * splits;
  if (!aligned || Cin % 64 || Cout % 64 || (tw != 8 && tw != 16 && tw != 32) ||
      splits < 1 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < tiles || grid > sm_count()) {
    return (int)cudaErrorInvalidValue;
  }
  const WgPlan p = wg_plan(tw);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTcMapError;
  CUtensorMap x_map, g_map;
  CUresult res = encode_nhwc(encode, &x_map, x, B, H, W, Cin, 64, p.halo_w,
                             p.halo_h);
  if (res == CUDA_SUCCESS) {
    res = encode_nhwc(encode, &g_map, g, B, H, W, Cout, 64, tw, kTcTileRows);
  }
  if (res != CUDA_SUCCESS) return kTcMapError + (int)res;

  const WgKernel kernel = tw == 8    ? conv3x3_wgrad_tc_kernel<8>
                          : tw == 16 ? conv3x3_wgrad_tc_kernel<16>
                                     : conv3x3_wgrad_tc_kernel<32>;
  const cudaError_t attr =
      allow_max_smem(reinterpret_cast<const void*>(kernel), kTcMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  // Cooperative: the launch fails rather than run blocks that could not
  // all be resident, which the grid sync needs.
  void* args[] = {&x_map, &g_map, &scratch, &dw, &B, &H, &W, &Cin, &Cout,
                  &splits, &tiles_per_split, const_cast<WgPlan*>(&p)};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kWgThreads),
      args, p.smem_bytes, stream);
}

unsigned int ceil_div(long long a, long long b) {
  return (unsigned int)((a + b - 1) / b);
}

}  // namespace

// K1, SIMT: x (B,H,W,Cin), w (9*Cin, Cout), out (B,H,W,Cout); one dtype.
extern "C" int odek_conv3x3_fwd(const void* x, const void* w, void* out,
                                int B, int H, int W, int Cin, int Cout,
                                int dtype, void* stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid(ceil_div(M, kTile), ceil_div(Cout, kTile));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    conv3x3_fwd_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), B, H, W, Cin, Cout);
  });
}

// K1, tensor cores: as odek_conv3x3_fwd for bf16 with Cin % 16 == 0,
// Cout % 16 == 0, Cout <= 256, 16-byte aligned pointers and output tiles
// 8 rows high and tile_w (8, 16 or 32) wide. Returns
// cudaErrorInvalidValue for arguments outside that, 10000 + the CUresult
// if a tensor map is refused, else cudaGetLastError().
extern "C" int odek_conv3x3_fwd_tc(const void* x, const void* w, void* out,
                                   int B, int H, int W, int Cin, int Cout,
                                   int tile_w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    if constexpr (std::is_same_v<decltype(tag), __nv_bfloat16>) {
      return launch_fwd_tc(x, w, out, B, H, W, Cin, Cout, tile_w, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
}

// K2: x (B,H,W,Cin), g (B,H,W,Cout) of one dtype; scratch (splits, 9*Cin,
// Cout) and dw (9*Cin, Cout) fp32. Rows [s*rows_per_split,
// (s+1)*rows_per_split) of the B*H*W rows go to split s.
extern "C" int odek_conv3x3_wgrad(const void* x, const void* g, void* scratch,
                                  void* dw, int B, int H, int W, int Cin,
                                  int Cout, int splits,
                                  long long rows_per_split, int dtype,
                                  void* stream) {
  const int K = 9 * Cin;
  const dim3 grid(ceil_div(K, kTile), ceil_div(Cout, kTile), splits);
  const long long size = (long long)K * Cout;
  float* scr = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    conv3x3_wgrad_partial_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), scr, B, H, W,
        Cin, Cout, rows_per_split);
    splitk_sum_kernel<<<ceil_div(size, 256), 256, 0, st>>>(
        scr, static_cast<float*>(dw), splits, size);
  });
}

// K2, tensor cores: as odek_conv3x3_wgrad for bf16 with Cin % 64 == 0,
// Cout % 64 == 0, 16-byte aligned pointers, tiles 8 rows high and tile_w
// (8, 16 or 32) wide, `splits` partials of `tiles_per_split` tiles each
// (covering every tile), and (Cin/64) * (Cout/64) * splits blocks at most
// one per SM. One cooperative launch. Returns cudaErrorInvalidValue for
// arguments outside that, 10000 + the CUresult if a tensor map is refused,
// else the launch's error.
extern "C" int odek_conv3x3_wgrad_tc(const void* x, const void* g,
                                     void* scratch, void* dw, int B, int H,
                                     int W, int Cin, int Cout, int tile_w,
                                     int splits, int tiles_per_split,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    if constexpr (std::is_same_v<decltype(tag), __nv_bfloat16>) {
      return launch_wgrad_tc(x, g, static_cast<float*>(scratch),
                             static_cast<float*>(dw), B, H, W, Cin, Cout,
                             tile_w, splits, tiles_per_split, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
}
