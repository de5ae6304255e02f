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
// (256, 8, 8, 256), d = 20, stride 2, bf16) each pixel meets 16 of the 441
// windows inside the 8 x 8 map, so K5 writes 14 MB of mostly zeros against
// 17 MB of features read, 0.5 GFLOP: bytes (9.3 us at 3.35 TB/s). At the
// FlyingChairs feature shape (8, 48, 64, 256) nearly every window
// overlaps, and each f2 pixel is read by up to 441 output pixels: L2
// bandwidth, about 5 GB of window reads. Tiling f2's neighbourhood in
// shared memory for maps above 64 pixels is later work.
//
// K5, K6 and K7 have two kernels each; ops/correlation.py::tc_plan picks
// one.
//
// * corr_fwd_tc_kernel, corr_bwd_f1_tc_kernel and corr_bwd_f2_tc_kernel
//   (bf16, H*W <= 64, C = 64, 128 or 256, 16-byte aligned features): one
//   sample a block, the pixel-pair products on the tensor cores (section
//   "Tensor-core K5-K7" below). The bench shape takes them: K5, K6 and
//   K7 about 13.3, 10.5 and 10.4 us a call alone there, against the SIMT
//   kernels' 96, 89 and 103 (H100, PERF.md).
// * The SIMT kernels (everything else, fp32 included, so fp32 stays strict
//   fp32), described next.
//
// Design of the SIMT kernels.
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
// All six kernels accumulate in fp32 in a fixed order and round once to
// the input dtype. (The Pallas backward kernels round their bf16
// accumulator after every dy step, K6, or every (dy, dx) step, K7.)

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using odek::allow_max_smem;
using odek::fence_operands;
using odek::from_f32;
using odek::k_major_desc;
using odek::mn_major_desc;
using odek::smem_u32;
using odek::to_f32;
using odek::warp_sum;
using odek::warpgroup_sync;
using odek::wgmma_commit;
using odek::wgmma_fence;
using odek::wgmma_m64n64k16;
using odek::wgmma_wait_all;

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

// ---------------------------------------------------------------------------
// Tensor-core K5-K7 (bf16, a map of at most 64 pixels).
//
// The structure. A sample's map fits one 64-row tile, so a pixel pair
// (p, q) is an entry of a 64 x 64 matrix, and displacement i of pixel p is
// the pair (p, p + o_i) where that pixel lies in the map (pair_disp below;
// every in-map (p, i) is exactly one pair, every other pair none).
//   K5: S = f1 . f2^T (64 x 64, K = C channels); out[p, i] = S[p, p + o_i]
//       / C, zero where p + o_i leaves the map.
//   K7: gf2 = M . f1 / C with M[q, p] = g[p, i] for q = p + o_i, else 0
//       (64 x 64, K = 64 pixels; N = C channels).
//   K6: gf1 = M^T . f2 / C on the same M (build_pair_matrix): row q of M
//       is K, the p along a row are M, so M's bytes are an MN-major A.
//       No padded f2 and no per-dy accumulation, as the Pallas kernel has.
//
// Design.
// * One block a sample (256 blocks at the bench shape on 132 SMs), so
//   nothing is summed across blocks: no atomics, no split reduction, and
//   every output has one fixed order of summation; two calls are
//   bit-equal.
// * The features come into shared memory by 16-byte cp.async copies, one
//   a thread at a time, each put where wgmma's 128-byte swizzle wants it:
//   a 64-channel slice of a pixel is one 128-byte row, 64 rows a chunk
//   (load_rows_sw128). A 1-D bulk copy would land the rows unswizzled, and
//   a TMA tensor map costs host time on every call (3-10 us for three,
//   PERF.md); these copies need neither. Pixels past H*W are zero rows.
// * The same chunks are K5's A (f1) and B (f2), both K-major (C is the
//   contiguous axis), and K6's and K7's B (f2, f1), MN-major (pixels are
//   their K). M is one more chunk: K7's K-major A, K6's MN-major A.
// * fp32 sums in registers (wgmma.m64n64k16), divided by C and rounded to
//   bf16 once.
// * K5's epilogue: the sample's whole (H*W, n*n) output, zeros included,
//   is staged in shared memory (the operand chunks are free by then) at
//   the byte offset it has in device memory within a 16-byte unit, zeroed
//   by 16-byte stores, filled with the pair products, then copied out in
//   aligned 16-byte units (the ragged unit at each end of a sample by
//   element). Zeros are written, not computed.
// * K6's and K7's epilogue: each warpgroup stages its 64-channel block of
//   the gradient into the feature chunk that block has just consumed, then
//   copies its H*W rows out in 16-byte units.
// ---------------------------------------------------------------------------

constexpr int kTcPixels = 64;  // the tile: wgmma's M; K5's N, K6/K7's K
constexpr int kTcChunkBytes = kTcPixels * 128;  // 64 rows of 64 channels
constexpr int kTcFwdThreads = 128;  // one warpgroup
constexpr int kTcBwdThreads = 256;  // two warpgroups
// Dynamic shared memory a block may ask for: the H100's 232,448 bytes less
// 1 KB for the static pixel table. A launch that asks for more fails.
constexpr int kTcSmemLimit = 232448 - 1024;

// K5's dynamic shared memory: the two operands or the staged output, the
// larger, and 1 KB to align the base. K6 and K7 need less (C*128 + 8 KB +
// 1 KB).
int tc_fwd_smem_bytes(int C, int nd) {
  return std::max(2 * C * 128, 16 + kTcPixels * nd * 2) + 1024;
}

// Pixel coordinates of the map and the displacement of each in-map pixel
// offset, in shared memory: (2H-1)(2W-1) < 4*H*W <= 256 offsets.
struct PairTable {
  unsigned char y[kTcPixels], x[kTcPixels];
  short disp[4 * kTcPixels];
};

__device__ void build_pair_table(PairTable& t, const CorrShape& s) {
  const int ow = 2 * s.W - 1;
  for (int k = threadIdx.x; k < s.H * s.W; k += blockDim.x) {
    t.y[k] = (unsigned char)(k / s.W);
    t.x[k] = (unsigned char)(k % s.W);
  }
  for (int k = threadIdx.x; k < (2 * s.H - 1) * ow; k += blockDim.x) {
    // Offset (oy, ox) = (k / ow - (H-1), k % ow - (W-1)) is displacement
    // (iy, ix) where oy + d = iy * stride, ox + d = ix * stride, iy, ix < n.
    const int ty = k / ow - (s.H - 1) + s.d;
    const int tx = k % ow - (s.W - 1) + s.d;
    int i = -1;
    if (ty >= 0 && tx >= 0 && ty % s.stride == 0 && tx % s.stride == 0 &&
        ty / s.stride < s.n && tx / s.stride < s.n) {
      i = (ty / s.stride) * s.n + tx / s.stride;
    }
    t.disp[k] = (short)i;
  }
}

// Displacement of the pixel pair (p, q), both in the map: the i with
// q = p + o_i, or -1.
__device__ __forceinline__ int pair_disp(const PairTable& t, int p, int q,
                                         const CorrShape& s) {
  return t.disp[(t.y[q] - t.y[p] + s.H - 1) * (2 * s.W - 1) + t.x[q] -
                t.x[p] + s.W - 1];
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(dst), "r"(0)
               : "memory");
}

// The cp.async copies this thread issued have landed, and what every
// thread wrote is visible to wgmma once the block has synchronised.
__device__ __forceinline__ void operands_ready() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// Rows [0, rows) of a (rows, C) bf16 matrix at src into shared memory at
// dst as C/64 chunks of 64 rows x 128 bytes, 16-byte unit u of row r at
// unit u ^ (r % 8) (TMA's 128-byte swizzle; dst 1 KB aligned). Rows
// [rows, 64) are zeros. Issued by cp.async; operands_ready() waits.
__device__ void load_rows_sw128(uint32_t dst, const __nv_bfloat16* src,
                                int rows, int C) {
  const int units = C / 8;  // 16-byte units a row
  for (int k = threadIdx.x; k < kTcPixels * units; k += blockDim.x) {
    const int r = k / units;
    const int c = k - r * units;
    const uint32_t at = dst + (c / 8) * kTcChunkBytes + r * 128 +
                        (((c % 8) ^ (r % 8)) << 4);
    if (r < rows) {
      cp_async16(at, src + (long long)r * C + c * 8);
    } else {
      st_shared_zero16(at);
    }
  }
}

// M (64 x 64 bf16, row q, column p) of one sample at m in shared memory,
// in load_rows_sw128's layout (one chunk): M[q][p] = g[p, i] where
// q = p + o_i, else 0, rows and columns past H*W included. g is the
// sample's (H*W, n*n) cotangent. Every entry is written once, by 16-byte
// units. K7 reads M as a K-major A operand (M . f1); K6 reads the same
// bytes as an MN-major one (M^T . f2).
__device__ void build_pair_matrix(uint32_t m, const unsigned short* g,
                                  const PairTable& t, const CorrShape& s) {
  const int hw = s.H * s.W;
  const int nd = s.n * s.n;
  for (int k = threadIdx.x; k < kTcPixels * 8; k += blockDim.x) {
    const int q = k / 8;
    const int u = k % 8;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 8 * u + 2 * e + h;
        const int i = (p < hw && q < hw) ? pair_disp(t, p, q, s) : -1;
        if (i >= 0) pair |= (uint32_t)__ldg(g + p * nd + i) << (16 * h);
      }
      v[e] = pair;
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                     m + q * 128 + ((u ^ (q % 8)) << 4)),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// S += f1 . f2^T over the channels, KC chunks (1, 2 or 4), unrolled: in a
// runtime loop ptxas would wait for each wgmma before the next.
template <int KC>
__device__ __forceinline__ void pair_products(float (&acc)[32], uint32_t a,
                                              uint32_t b) {
  // 16 channels a step: 32 bytes along a row, a chunk every 4 steps.
#pragma unroll
  for (int k = 0; k < KC * 4; ++k) {
    const uint32_t off = (k / 4) * kTcChunkBytes + (k % 4) * 32;
    wgmma_m64n64k16<0, 0>(acc, k_major_desc(a + off, 1024, 1),
                          k_major_desc(b + off, 1024, 1));
  }
}

// K5, tensor cores: f1, f2 (B, H, W, C = 64 * KC) -> out (B, H, W, n*n),
// bf16; grid B, one warpgroup a block.
template <int KC>
__global__ void __launch_bounds__(kTcFwdThreads)
    corr_fwd_tc_kernel(const __nv_bfloat16* __restrict__ f1,
                       const __nv_bfloat16* __restrict__ f2,
                       __nv_bfloat16* __restrict__ out, CorrShape s) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ PairTable table;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int hw = s.H * s.W;
  const int nd = s.n * s.n;
  const long long b = blockIdx.x;
  const uint32_t f1s = base;
  const uint32_t f2s = base + KC * kTcChunkBytes;
  load_rows_sw128(f1s, f1 + b * hw * s.C, hw, s.C);
  load_rows_sw128(f2s, f2 + b * hw * s.C, hw, s.C);
  build_pair_table(table, s);
  operands_ready();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_operands(acc);
  wgmma_fence();
  pair_products<KC>(acc, f1s, f2s);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(acc);
  __syncthreads();  // the operands are free: stage the output there

  // Element e of the sample's output at staged byte lead + 2e, lead its
  // byte offset within a 16-byte unit of device memory (out is 16-byte
  // aligned), so staged units and device units line up.
  const long long o0 = b * hw * nd;
  const int lead = (int)(o0 % 8) * 2;
  const int bytes = hw * nd * 2;
  const int units = (lead + bytes + 15) / 16;
  for (int k = threadIdx.x; k < units; k += kTcFwdThreads) {
    st_shared_zero16(base + 16 * k);
  }
  __syncthreads();

  // Accumulator fragment: rows 16*warp + g and + 8 (pixel p), columns
  // 8j + 2*t4 and + 1 (pixel q).
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (base - raw) + lead);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = 16 * warp + 8 * half + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * j + 2 * t4 + e;
        if (p < hw && q < hw) {
          const int i = pair_disp(table, p, q, s);
          if (i >= 0) {
            staged[p * nd + i] =
                __float2bfloat16(acc[4 * j + 2 * half + e] / (float)s.C);
          }
        }
      }
    }
  }
  __syncthreads();

  const uint4* src = reinterpret_cast<const uint4*>(smem_raw + (base - raw));
  __nv_bfloat16* dst = out + (o0 - lead / 2);  // 16-byte aligned
  for (int k = threadIdx.x; k < units; k += kTcFwdThreads) {
    if (16 * k >= lead && 16 * k + 16 <= lead + bytes) {
      reinterpret_cast<uint4*>(dst)[k] = src[k];
    } else {  // a ragged unit at either end of the sample
      for (int e = 8 * k; e < 8 * k + 8; ++e) {
        if (2 * e >= lead && 2 * e < lead + bytes) {
          dst[e] = staged[e - lead / 2];
        }
      }
    }
  }
}

// K6 (kMt true) and K7 (false), tensor cores, one sample: g (H, W, n*n)
// and the features f (H, W, C) at this block's sample -> the gradient gf
// (H, W, C): gf1 = M^T . f2 / C, gf2 = M . f1 / C. Two warpgroups, each
// owning every other 64-channel block of gf; smem_raw is the block's
// dynamic shared memory, table its static pixel table.
template <bool kMt>
__device__ __forceinline__ void corr_bwd_tc(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ f,
    __nv_bfloat16* __restrict__ gf, const CorrShape& s,
    unsigned char* smem_raw, PairTable& table) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int hw = s.H * s.W;
  const long long b = blockIdx.x;
  const int n_chunks = s.C / 64;
  const uint32_t fs = base;
  const uint32_t ms = base + n_chunks * kTcChunkBytes;
  load_rows_sw128(fs, f + b * hw * s.C, hw, s.C);
  build_pair_table(table, s);
  __syncthreads();  // the table, for build_pair_matrix
  build_pair_matrix(ms,
                    reinterpret_cast<const unsigned short*>(g) +
                        b * hw * s.n * s.n,
                    table, s);
  operands_ready();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int gr = (tid % 32) / 4;
  const int t4 = tid % 4;
  __nv_bfloat16* out = gf + b * hw * s.C;
  for (int nb = wg; nb < n_chunks; nb += 2) {
    const uint32_t chunk = fs + nb * kTcChunkBytes;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // 16 pixels a step
      if constexpr (kMt) {
        // Rows 16k.. of M are K; a row's 64 p (128 bytes) are M, as the
        // 16 rows of f's chunk are K and a row's 64 channels N.
        wgmma_m64n64k16<1, 1>(acc, mn_major_desc(ms + 2048 * k, 64),
                              mn_major_desc(chunk + 2048 * k, 64));
      } else {
        wgmma_m64n64k16<0, 1>(acc, k_major_desc(ms + 32 * k, 1024, 1),
                              mn_major_desc(chunk + 2048 * k, 64));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    // Only this block of channels reads this chunk: once every warp of the
    // warpgroup is past its products, gf's block is staged there (row r,
    // channel c at unit c/8 ^ (r % 8)), then copied out. Rows r >= H*W
    // (zeros) are staged, never stored.
    warpgroup_sync(wg);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + 8 * half + gr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] / (float)s.C,
            acc[4 * j + 2 * half + 1] / (float)s.C);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                         chunk + r * 128 + ((j ^ (r % 8)) << 4) + 4 * t4),
                     "r"(*reinterpret_cast<uint32_t*>(&v))
                     : "memory");
      }
    }
    warpgroup_sync(wg);
    for (int k = tid; k < hw * 8; k += 128) {
      const int r = k / 8;
      const int u = k % 8;
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(chunk + r * 128 + ((u ^ (r % 8)) << 4)));
      *reinterpret_cast<uint4*>(out + (long long)r * s.C + nb * 64 + u * 8) =
          v;
    }
  }
}

// K6, tensor cores: g (B, H, W, n*n), f2 (B, H, W, C) -> gf1 (B, H, W, C),
// bf16; grid B.
__global__ void __launch_bounds__(kTcBwdThreads)
    corr_bwd_f1_tc_kernel(const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ f2,
                          __nv_bfloat16* __restrict__ gf1, CorrShape s) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ PairTable table;
  corr_bwd_tc<true>(g, f2, gf1, s, smem_raw, table);
}

// K7, tensor cores: g (B, H, W, n*n), f1 (B, H, W, C) -> gf2 (B, H, W, C),
// bf16; grid B.
__global__ void __launch_bounds__(kTcBwdThreads)
    corr_bwd_f2_tc_kernel(const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ f1,
                          __nv_bfloat16* __restrict__ gf2, CorrShape s) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ PairTable table;
  corr_bwd_tc<false>(g, f1, gf2, s, smem_raw, table);
}

using FwdTcKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                             __nv_bfloat16*, CorrShape);

// K5 for C = 64, 128 or 256; nullptr for any other C.
FwdTcKernel fwd_tc_kernel(int C) {
  switch (C) {
    case 64: return corr_fwd_tc_kernel<1>;
    case 128: return corr_fwd_tc_kernel<2>;
    case 256: return corr_fwd_tc_kernel<4>;
    default: return nullptr;
  }
}

// What the tensor-core kernels index by: 16-byte aligned pointers, 1 <=
// H*W <= 64 and an unrolled C. ops/correlation.py::tc_plan decides which
// calls come here; this only refuses arguments that would read or write
// out of bounds. Shared memory beyond a block's fails the launch.
bool tc_args_ok(const void* a, const void* b, const void* out,
                const CorrShape& s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return aligned && s.B >= 1 && s.H >= 1 && s.W >= 1 &&
         s.H * s.W <= kTcPixels && fwd_tc_kernel(s.C) != nullptr;
}

using BwdTcKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                             __nv_bfloat16*, CorrShape);

// K6 or K7 on the tensor cores: bf16 under tc_args_ok (g needs no
// alignment: it is read by element). Returns cudaErrorInvalidValue for
// arguments outside that, else the launch's error.
int launch_bwd_tc(BwdTcKernel kernel, const void* g, const void* f, void* gf,
                  const CorrShape& s, int dtype, cudaStream_t st) {
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    if constexpr (std::is_same_v<decltype(tag), __nv_bfloat16>) {
      if (!tc_args_ok(f, f, gf, s)) return (int)cudaErrorInvalidValue;
      const int smem = s.C * 128 + kTcChunkBytes + 1024;
      const cudaError_t attr =
          allow_max_smem(reinterpret_cast<const void*>(kernel), kTcSmemLimit);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<s.B, kTcBwdThreads, smem, st>>>(
          static_cast<const __nv_bfloat16*>(g),
          static_cast<const __nv_bfloat16*>(f),
          static_cast<__nv_bfloat16*>(gf), s);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
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

// K5, tensor cores: as odek_correlation_fwd for bf16 with 16-byte aligned
// pointers, H*W <= 64 and C = 64, 128 or 256 (tc_args_ok). Returns
// cudaErrorInvalidValue for arguments outside that, else the launch's
// error.
extern "C" int odek_correlation_fwd_tc(const void* f1, const void* f2,
                                       void* out, int B, int H, int W, int C,
                                       int d, int stride, int dtype,
                                       void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    if constexpr (std::is_same_v<decltype(tag), __nv_bfloat16>) {
      if (!tc_args_ok(f1, f2, out, s)) return (int)cudaErrorInvalidValue;
      const FwdTcKernel kernel = fwd_tc_kernel(C);
      const cudaError_t attr =
          allow_max_smem(reinterpret_cast<const void*>(kernel), kTcSmemLimit);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<B, kTcFwdThreads, tc_fwd_smem_bytes(C, s.n * s.n), st>>>(
          static_cast<const __nv_bfloat16*>(f1),
          static_cast<const __nv_bfloat16*>(f2),
          static_cast<__nv_bfloat16*>(out), s);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
}

// K6, tensor cores: as odek_correlation_bwd_f1 for bf16, under K5's rule
// (g needs no alignment: it is read by element).
extern "C" int odek_correlation_bwd_f1_tc(const void* g, const void* f2,
                                          void* gf1, int B, int H, int W,
                                          int C, int d, int stride, int dtype,
                                          void* stream) {
  return launch_bwd_tc(corr_bwd_f1_tc_kernel, g, f2, gf1,
                       make_shape(B, H, W, C, d, stride), dtype,
                       static_cast<cudaStream_t>(stream));
}

// K7, tensor cores: as odek_correlation_bwd_f2 for bf16, under K5's rule.
extern "C" int odek_correlation_bwd_f2_tc(const void* g, const void* f1,
                                          void* gf2, int B, int H, int W,
                                          int C, int d, int stride, int dtype,
                                          void* stream) {
  return launch_bwd_tc(corr_bwd_f2_tc_kernel, g, f1, gf2,
                       make_shape(B, H, W, C, d, stride), dtype,
                       static_cast<cudaStream_t>(stream));
}
