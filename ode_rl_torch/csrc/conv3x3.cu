// K1 and K2: the 3x3 stride-1 SAME convolution of the ODE field ConvNet,
// NHWC x HWIO -> NHWC, as an implicit-im2col GEMM.
//
// Replaces (Pallas, TPU):
//   K1  ode_rl_tpu/ops/conv3x3.py::_fwd_kernel (via _pallas_fwd), also
//       used for dx with the spatially flipped, channel-transposed weights;
//   K2  ode_rl_tpu/ops/conv3x3.py::_wgrad_kernel (via _pallas_wgrad).
//
// What bounds them on the H100. At the flagship shape (x (128,16,16,64),
// w (576,64), bf16) one K1 call is M = B*H*W = 32,768 rows, K = 9*Cin =
// 576, N = Cout = 64: 2.4 GFLOP against about 8.5 MB of activations in and
// out, a few microseconds on either bound. At the recipe's shape (B = 4,
// fp32) it is 75.5 MFLOP: 1.13 us of fp32 FMA at 67 TFLOP/s, and the grid
// has to be cut finely to put work on every SM.
//
// A halo operand (B, 2, W, Cin), nullable in every launcher: a 'space'
// rank's conv over its own H rows of a height-sharded map, row 0 of the
// halo the row above x's first, row 1 the row below its last (zeros past
// the frame). The conv is SAME along W and takes its H neighbours from the
// halo instead of zero padding; the output has x's H rows. So a rank's
// tiles cover its own rows only (at a 'space' line of two at the
// flagship's 16 rows, 128 tiles of 8 rows, where a tile of its 8 rows and
// their halo rows cut as 10 rows took 256), and no concatenated copy of
// the map is made (parallel/sp.py). Both kernels of K1 and of K2 take it.
//
// K1 has two kernels; ops/conv3x3.py::uses_tensor_cores picks one.
//
// * conv3x3_fwd_tc_kernel (bf16 in, Cin % 16 == 0, Cout % 16 == 0, Cout <=
//   256, the weights, two halo stages and the output staging within the
//   227 KB of shared memory; bf16 out, or fp32 out for the column-parallel
//   dx partials of a 'model' axis): the tensor-core K1 (section
//   "Tensor-core K1" below), about 7 us a launch at the flagship shape
//   against cuDNN's 11.
// * conv3x3_fwd_simt_kernel (everything else, fp32 included, so fp32 stays
//   strict fp32): fp32 FMA from shared memory (section "SIMT K1" below). A
//   block owns a 16-column strip of an image, a run of its rows and 16 or
//   32 output channels; its weights stay resident in shared memory for
//   the whole run and the input comes a halo row at a time into a ring,
//   the next step's rows loading by cp.async under this step's products;
//   each thread 4 pixels x 8 channels (x 4 at 16). ops/conv3x3.py::
//   simt_plan sizes the run so that the grid is one wave. On an H100 80GB
//   HBM3 (700 W) about 7.5 us a call at the recipe's fp32 (4, 16, 16, 64)
//   -> 64 against cuDNN's fp32 24, and 31 / 31 / 18 at the Vid-ODE
//   field's (4, 32, 32) 128 -> 64 / 64 -> 128 / 64 -> 64 against cuDNN's
//   40 / 36 / 26 (ode_rl_torch/simt_conv_times.py, PERF.md §6).
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
// * conv3x3_wgrad_tc_kernel (bf16, Cin % 64 == 0, Cout % 32 == 0): the
//   tensor-core K2 (section "Tensor-core K2" below): TMA halo and
//   cotangent tiles, wgmma with pixels as the reduction axis (64 or 32
//   output channels a block), the partials summed after a grid sync in the
//   same cooperative launch. About 12 us a launch at the flagship shape
//   against cuDNN's weight gradient's 19.5; the partials' round trip
//   through L2 and the grid sync are most of the gap to the bound.
// * conv3x3_wgrad_simt_kernel (everything else, fp32 included): fp32 FMA
//   (section "SIMT K2" below). A block owns a 64 x 64, 128 x 64 or 64 x
//   128 tile of dW and a run of pixels, each thread an 8 x 8 register
//   tile, pixels staged by cp.async three stages ahead;
//   ops/conv3x3.py::wgrad_simt_plan sizes the runs so that every block is
//   resident, and the same cooperative launch sums the partials in split
//   order after a grid sync. On an H100 80GB HBM3 (700 W) about 8 us a
//   call at the recipe's fp32 shape against cuDNN's 16.3, and 23 / 23 /
//   16.5 at the Vid-ODE field's 32x32 shapes against 24.8 / 24.8 / 20.9.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <algorithm>
#include <atomic>
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
using odek::wgmma_m64n32k16;
using odek::wgmma_m64n64k16;
using odek::wgmma_wait_all;
using odek::wgmma_wait_one;

template <typename T>
bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// 16 bytes from global to shared memory without a register round trip;
// zeros where !valid (no bytes are read then).
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most n of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// store(i, value(i)) for i = first, first + step, ... < n, with kBatch
// loads in flight.
template <typename V, int kBatch, typename Value, typename Store>
__device__ __forceinline__ void batched_copy(int first, int n, int step,
                                             Value value, Store store) {
  for (int i0 = first; i0 < n; i0 += kBatch * step) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * step;
      if (i < n) v[u] = value(i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * step;
      if (i < n) store(i, v[u]);
    }
  }
}

// Four bf16 (8 bytes, raw) as floats.
__device__ __forceinline__ float4 widen4(uint2 u) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// How a block copies its inputs to shared memory: fp32 with channels in
// fours and aligned pointers by 16-byte cp.async, in flight under the
// products; bf16 so by 8-byte loads through registers, widened to fp32;
// anything else element by element.
enum SimtMode : int { kElem = 0, kQuad = 1, kAsync = 2 };

// ---------------------------------------------------------------------------
// SIMT K1: out (M, Cout) = patches (M, 9*Cin) . w (9*Cin, Cout), fp32 FMA.
//
// A block owns one strip of an image (16 output columns), a run of its
// rows and a tile of BN = 16 or 32 output channels (kNV = BN / 16);
// ops/conv3x3.py::simt_plan picks BN and the run. 256 threads in 16
// groups of 16; a thread holds 4 pixels (columns pq, pq + 4, pq + 8,
// pq + 12 of the strip) x 4 * kNV channels (4nq + 16v + e).
// * The block's weights, [9 * cc4][BN], are staged once and stay resident
//   for the whole run: all of Cin, so a run's rows re-read no weights
//   (staged again for every 16-pixel row segment and 64-channel chunk,
//   they would be 75.5 MB from L2 at (4, 32, 32, 128) -> 64, a 604 MFLOP
//   conv). Channels beyond what fits in shared memory go in slabs, one
//   launch each (simt_slab: only past Cin 144 at BN 32, 256 at BN 16),
//   each adding to the last one's output in order.
// * The input comes in halo rows of 18 pixels (the strip and one column
//   each side) x the slab's channels, SAME zeros (or the halo operand's
//   rows -1 and H) written at staging, into a ring of 2 * SR + 2 rows: a
//   step computes SR output rows from SR + 2 resident halo rows while the
//   next step's SR rows load by cp.async (one commit group a step, waited
//   one step later), so each input row is read once a strip and tile,
//   under the products of the step before.
// * The 16 groups: SK of them share one output row's products and SR =
//   16 / SK rows go at once, SK = simt_split(slab): 16 from Cin 61 up.
//   Item j = tap * quads + q (channels 4q .. 4q + 3) goes to group j % SK.
// * What bounds it: fp32 FMA and shared memory's 128 bytes a clock to the
//   registers. A step of 4 input channels is 4 + 4 * kNV 16-byte loads for
//   64 * kNV FMAs: at BN 32 the two 16-thread groups of a warp read 8
//   distinct pixels of the halo (pixel stride = 8 mod 32 floats, so in 8
//   bank groups) and 2 x 4 float4 of weights (rows of odd quads stored
//   with their 16-float halves swapped, so the warp's two quads fall in
//   different banks): one wavefront a load, 12 for 128 FMAs a thread.
// * Fixed order, so two calls are bit-equal: group k's sum runs over its
//   items in order, then the 4 channels of an item, one fmaf chain; the
//   two groups of a warp are added by a shuffle (s_2m + s_2m+1), and an
//   output is (...(p_0 + p_1) + ...) + p_(SK/2-1) over those pair sums,
//   added by one thread from shared memory (SK = 1: s_0 itself); a slab
//   after the first adds its sum to the output, slab by slab.
// ---------------------------------------------------------------------------

constexpr int kSimtGroups = 16;    // groups of 16 threads
constexpr int kSimtThreads = 256;
constexpr int kSimtTileW = 16;     // output columns of a strip
constexpr int kSimtHaloW = kSimtTileW + 2;
constexpr int kSimtBatch = 8;      // loads in flight a thread (register path)
constexpr int kSimtMaxSmem = 232448;  // a block's dynamic shared memory

// Floats between two halo pixels: at least the slab's channels rounded to
// 4, and 8 mod 32, so 4 consecutive pixels lie in 4 even bank groups and
// the next quad's in the odd ones.
__host__ __device__ constexpr int simt_halo_stride(int cs) {
  const int cc4 = (cs + 3) / 4 * 4;
  return cc4 + ((8 - cc4) % 32 + 32) % 32;
}

// Groups that split one output row's products: the largest power of two
// at most min(16, quads of min(cs, 64)). Mirrors ops/conv3x3.py.
__host__ __device__ constexpr int simt_split(int cs) {
  const int quads = ((cs < 64 ? cs : 64) + 3) / 4;
  int sk = 1;
  while (sk * 2 <= quads && sk < kSimtGroups) sk *= 2;
  return sk;
}

// Weights [9 * cc4][bn], the ring of 2 * SR + 2 halo rows [18][stride]
// and the 8 group pairs' sums [8][16][bn] (none at SK = 1), for a slab of
// cs channels. Mirrors ops/conv3x3.py::simt_smem_bytes.
__host__ __device__ constexpr int simt_smem_bytes(int cs, int bn) {
  const int sk = simt_split(cs);
  const int sr = kSimtGroups / sk;
  return (9 * ((cs + 3) / 4 * 4) * bn +
          (2 * sr + 2) * kSimtHaloW * simt_halo_stride(cs) +
          (sk > 1 ? kSimtGroups / 2 * kSimtTileW * bn : 0)) * 4;
}

// Channels of one launch: all of Cin where that plan fits, else the
// fewest equal slabs, in multiples of 4, that fit. Mirrors
// ops/conv3x3.py::simt_slab.
int simt_slab(int Cin, int bn) {
  for (int n = 1;; ++n) {
    const int cs = std::min((Cin + 4 * n - 1) / (4 * n) * 4, Cin);
    if (cs <= 4 || simt_smem_bytes(cs, bn) <= kSimtMaxSmem) return cs;
  }
}

template <typename T, int kMode, int kNV>
__global__ void __launch_bounds__(kSimtThreads, 2)
    conv3x3_fwd_simt_kernel(const T* __restrict__ x,
                            const T* __restrict__ halo,
                            const T* __restrict__ w, T* __restrict__ out,
                            int B, int H, int W, int Cin, int Cout, int c0,
                            int cs, int steps_per_block, int accumulate) {
  constexpr int BN = 16 * kNV;
  extern __shared__ __align__(16) float simt_smem[];
  const int sk = simt_split(cs);
  const int sr = kSimtGroups / sk;
  const int quads = (cs + 3) / 4;
  const int cc4 = 4 * quads;
  const int hs = simt_halo_stride(cs);
  const int ring = 2 * sr + 2;
  const int row_floats = kSimtHaloW * hs;
  // Block = ((b * strips + strip) * runs + run) * tiles + tile.
  const int strips = (W + kSimtTileW - 1) / kSimtTileW;
  const int steps = (H + sr - 1) / sr;
  const int runs = (steps + steps_per_block - 1) / steps_per_block;
  const int n_tiles = (Cout + BN - 1) / BN;
  int blk = blockIdx.x;
  const int n0 = (blk % n_tiles) * BN;
  blk /= n_tiles;
  const int y_begin = (blk % runs) * steps_per_block * sr;
  blk /= runs;
  const int x0 = (blk % strips) * kSimtTileW;
  const int b = blk / strips;
  const int y_end = min(y_begin + steps_per_block * sr, H);
  const int n_steps = (y_end - y_begin + sr - 1) / sr;
  float* w_s = simt_smem;
  float* h_s = w_s + 9 * cc4 * BN;
  float* red = h_s + ring * row_floats;
  const int tid = threadIdx.x;
  const int grp = tid / 16;
  const int kp = grp % sk;        // this group's share of the products
  const int sg = grp / sk;        // and its row of the step
  const int pq = (tid % 16) / 4;  // columns pq + 4i of the strip
  const int nq = tid % 4;         // channels n0 + 4nq + 16v + e

  // The weights: rows tap * Cin + c0 + ci, columns n0 .. n0 + BN - 1, in
  // units of 4 columns (1 for kElem); the rows from cs to cc4 and the
  // columns from Cout zeros. Row r lands at r * BN, its 16-float halves
  // swapped where r / 4 is odd (see above).
  {
    constexpr int upr = kMode == kElem ? BN : BN / 4;
    const int n_units = 9 * cc4 * upr;
    auto w_off = [&](int i) {
      const int r = i / upr;
      return (r * BN + (i % upr) * (BN / upr)) ^ (((r / 4) & 1) * 16);
    };
    auto w_at = [&](int i, bool& ok) {
      const int r = i / upr;
      const int tap = r / cc4;
      const int ci = r - tap * cc4;
      const int n = n0 + (i % upr) * (BN / upr);
      ok = ci < cs && n < Cout;
      return w + (long long)(tap * Cin + c0 + ci) * Cout + n;
    };
    if constexpr (kMode == kAsync) {
      for (int i = tid; i < n_units; i += kSimtThreads) {
        bool ok;
        const T* src = w_at(i, ok);
        cp_async16(w_s + w_off(i), ok ? src : w, ok);
      }
    } else if constexpr (kMode == kQuad) {
      batched_copy<uint2, kSimtBatch>(
          tid, n_units, kSimtThreads,
          [&](int i) {
            bool ok;
            const T* src = w_at(i, ok);
            return ok ? __ldg(reinterpret_cast<const uint2*>(src))
                      : make_uint2(0u, 0u);
          },
          [&](int i, uint2 v) {
            *reinterpret_cast<float4*>(w_s + w_off(i)) = widen4(v);
          });
    } else {
      batched_copy<float, kSimtBatch>(
          tid, n_units, kSimtThreads,
          [&](int i) {
            bool ok;
            const T* src = w_at(i, ok);
            return ok ? to_f32(*src) : 0.f;
          },
          [&](int i, float v) { w_s[w_off(i)] = v; });
    }
  }

  // Halo rows lo .. min(hi, y_end) in units (row, column, channel quad or
  // channel): row y in ring slot (y - y_begin + 1) % ring, columns x0 - 1
  // .. x0 + 16, channels c0 .. c0 + cc4; a null source where the unit is
  // zeros (outside the map, channels from cs; rows -1 and H from the halo
  // operand where there is one).
  const int upp = kMode == kElem ? cc4 : quads;  // units a pixel
  const int row_units = kSimtHaloW * upp;
  auto units = [&](int lo, int hi) {
    return max(0, min(hi, y_end) - lo + 1) * row_units;
  };
  auto unit = [&](int lo, int u, int& off) -> const T* {
    const int y = lo + u / row_units;
    const int v = u % row_units;
    const int col = v / upp;
    const int ci = (v - col * upp) * (kMode == kElem ? 1 : 4);
    off = ((y - y_begin + 1) % ring) * row_floats + col * hs + ci;
    const int xx = x0 + col - 1;
    const bool in_x = y >= 0 && y < H;
    if (xx < 0 || xx >= W || ci >= cs || !(in_x || halo != nullptr)) {
      return nullptr;
    }
    return (in_x ? x + ((long long)(b * H + y) * W + xx) * Cin
                 : halo + ((long long)(b * 2 + (y == H)) * W + xx) * Cin) +
           c0 + ci;
  };
  // Register path: raw bf16 quads or widened elements.
  using V = std::conditional_t<kMode == kQuad, uint2, float>;
  auto load = [&](const T* src) -> V {
    if constexpr (kMode == kQuad) {
      return src != nullptr ? __ldg(reinterpret_cast<const uint2*>(src))
                            : make_uint2(0u, 0u);
    } else {
      return src != nullptr ? to_f32(*src) : 0.f;
    }
  };
  auto put = [&](int off, V v) {
    if constexpr (kMode == kQuad) {
      *reinterpret_cast<float4*>(h_s + off) = widen4(v);
    } else {
      h_s[off] = v;
    }
  };
  // Rows lo .. hi at once: cp.async, or loads batched through registers.
  auto stage_rows = [&](int lo, int hi) {
    const int n = units(lo, hi);
    if constexpr (kMode == kAsync) {
      for (int u = tid; u < n; u += kSimtThreads) {
        int off;
        const T* src = unit(lo, u, off);
        cp_async16(h_s + off, src != nullptr ? src : x, src != nullptr);
      }
    } else {
      batched_copy<V, kSimtBatch>(
          tid, n, kSimtThreads,
          [&](int u) {
            int off;
            return load(unit(lo, u, off));
          },
          [&](int u, V v) {
            int off;
            unit(lo, u, off);
            put(off, v);
          });
    }
  };
  // Register path: the next step's first kAhead units a thread load under
  // this step's products and are stored after them, the rest then. Two
  // cover a row of 64 bf16 channels (288 quads); at BN 32 the sums leave
  // registers for one.
  constexpr int kAhead = kNV == 1 ? 2 : 1;
  V ahead[kAhead];
  auto fetch_ahead = [&](int lo, int hi) {
    const int n = units(lo, hi);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = tid + k * kSimtThreads;
      int off;
      if (u < n) ahead[k] = load(unit(lo, u, off));
    }
  };
  auto put_ahead = [&](int lo, int hi) {
    const int n = units(lo, hi);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = tid + k * kSimtThreads;
      int off;
      if (u < n) {
        unit(lo, u, off);
        put(off, ahead[k]);
      }
    }
    batched_copy<V, kSimtBatch>(
        tid + kAhead * kSimtThreads, n, kSimtThreads,
        [&](int u) {
          int off;
          return load(unit(lo, u, off));
        },
        [&](int u, V v) {
          int off;
          unit(lo, u, off);
          put(off, v);
        });
  };

  stage_rows(y_begin - 1, y_begin + sr);
  cp_async_commit();
  for (int t = 0; t < n_steps; ++t) {
    const int yt = y_begin + t * sr;
    // The next step's rows go into slots no row of this step uses: by
    // cp.async here, waited for a step later (the last barrier of the
    // step before follows its products); through registers under this
    // step's products, stored after them.
    if constexpr (kMode == kAsync) stage_rows(yt + sr + 1, yt + 2 * sr);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kMode != kAsync) fetch_ahead(yt + sr + 1, yt + 2 * sr);

    float acc[4][4 * kNV];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * kNV; ++c) acc[i][c] = 0.f;
    // Halo rows yt + sg - 1, yt + sg, yt + sg + 1 (taps dy = 0, 1, 2).
    const float* r0 = h_s + ((t * sr + sg) % ring) * row_floats;
    const float* r1 = h_s + ((t * sr + sg + 1) % ring) * row_floats;
    const float* r2 = h_s + ((t * sr + sg + 2) % ring) * row_floats;
    int tap = 0;
    int q = kp;  // kp < SK <= quads
    for (int j = kp; j < 9 * quads; j += sk) {
      const int dy = tap / 3;
      const float* hp = (dy == 0 ? r0 : dy == 1 ? r1 : r2) +
                        (pq + tap - 3 * dy) * hs + 4 * q;
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(hp + 4 * i * hs);
      }
      const float* wp = w_s + (tap * cc4 + 4 * q) * BN;
      const int swz = (j & 1) * 16;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 v[kNV];
#pragma unroll
        for (int h = 0; h < kNV; ++h) {
          v[h] = *reinterpret_cast<const float4*>(
              wp + ((e * BN + 4 * nq + 16 * h) ^ swz));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = lane4(a[i], e);
#pragma unroll
          for (int h = 0; h < kNV; ++h) {
            acc[i][4 * h + 0] = fmaf(av, v[h].x, acc[i][4 * h + 0]);
            acc[i][4 * h + 1] = fmaf(av, v[h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(av, v[h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(av, v[h].w, acc[i][4 * h + 3]);
          }
        }
      }
      q += sk;
      while (q >= quads) {
        q -= quads;
        ++tap;
      }
    }
    if constexpr (kMode != kAsync) put_ahead(yt + sr + 1, yt + 2 * sr);

    if (sk > 1) {
      // The warp's two groups (kp even in lanes 0-15, kp + 1 above) add
      // their sums; the lower group writes the pair sum, [pair][px][BN].
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * kNV; ++c) {
          acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 16);
        }
      if ((tid & 16) == 0) {
        float* dst = red + (grp / 2) * kSimtTileW * BN;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < kNV; ++h) {
            *reinterpret_cast<float4*>(dst + (pq + 4 * i) * BN + 4 * nq +
                                       16 * h) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
          }
      }
      __syncthreads();
      // Output o of the step (row o / (16 BN), pixel, channel) summed by
      // one thread over its row's SK / 2 pairs in order.
      const int half = sk / 2;
      for (int o = tid; o < sr * kSimtTileW * BN; o += kSimtThreads) {
        const int r = o / (kSimtTileW * BN);
        const int px = (o / BN) % kSimtTileW;
        const int ch = o % BN;
        const int y = yt + r;
        if (y >= y_end || x0 + px >= W || n0 + ch >= Cout) continue;
        const float* p = red + (r * half * kSimtTileW + px) * BN + ch;
        float sum = p[0];
        for (int m = 1; m < half; ++m) sum += p[m * kSimtTileW * BN];
        T* dst = out + ((long long)(b * H + y) * W + x0 + px) * Cout + n0 + ch;
        if (accumulate) sum = to_f32(*dst) + sum;
        *dst = from_f32<T>(sum);
      }
    } else {
      // One group a row: its sums are the outputs.
      const int y = yt + sg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = x0 + pq + 4 * i;
        if (y >= y_end || xx >= W) continue;
        T* row = out + ((long long)(b * H + y) * W + xx) * Cout;
#pragma unroll
        for (int h = 0; h < kNV; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + 4 * nq + 16 * h + e;
            if (n >= Cout) continue;
            float sum = acc[i][4 * h + e];
            if (accumulate) sum = to_f32(row[n]) + sum;
            row[n] = from_f32<T>(sum);
          }
      }
      __syncthreads();  // every group is done with this step's rows
    }
  }
}

// ---------------------------------------------------------------------------
// SIMT K2: dW (9*Cin, Cout) = patches^T . g, fp32 FMA, split over pixels,
// the splits summed in the same launch.
//
// A block owns one KT x NT tile of dW (rows k = tap * Cin + ci; 64 x 64,
// 128 x 64, one tap at Cin 128, or 64 x 128 at Cout 128) and a run of
// pixels, split s of ops/conv3x3.py::wgrad_simt_plan, which picks the
// splits by a cost model fitted on the H100, every block of the grid
// resident (at most two an SM): at (4, 32, 32, 128) -> 64, 9 tiles of
// 128 x 64 x 29 runs of 144 pixels = 261 blocks.
// * 256 threads: KT * NT / 64 threads cover the tile, each an 8 x 8
//   register tile (rows 4ty .. 4ty + 3 and KT/2 + 4ty .. + 3, columns
//   4tx .. 4tx + 3 and NT/2 + 4tx .. + 3), and PG = 256 / (KT * NT / 64)
//   such copies take the pixels of a stage in PG equal parts. A pixel is
//   4 16-byte loads for 64 FMAs: a warp reads 4 distinct float4 of x and
//   8 of g at NT 64 (2 and 16 at NT 128).
// * Pixels come in stages of 16 through a ring of 4 in shared memory,
//   [pixel][k] and [pixel][n]: by 16-byte cp.async where Cin and Cout are
//   multiples of 4 and the pointers aligned (fp32), three stages in flight
//   under the products, one barrier a stage; else loaded and stored a
//   stage ahead, before the products (bf16 widened to fp32). A thread's
//   staging column (tap, channel) is fixed and its pixels are stepped
//   without division; SAME zeros (rows -1 and H from the halo operand
//   where there is one).
// * The block's PG partials are added in shared memory in order (p_0 +
//   p_1) + ...; with one split that is dW. With S splits every block
//   writes its partial to part[s] (S, 9*Cin, Cout) fp32 and, after a
//   grid sync (a cooperative launch: every block resident), sums a slice
//   of dW over s = 0, 1, ... in order: no atomics, no second launch, and
//   two calls are bit-equal.
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 256;
constexpr int kWsPx = 16;   // pixels a stage
constexpr int kWsRing = 4;  // stages in shared memory
constexpr int kWsSumBatch = 8;  // partials' loads in flight a thread

// The ring of stages, or the PG - 1 partials added into the first, of a
// kt x nt tile (PG = 256 / (kt * nt / 64) copies of it).
__host__ __device__ constexpr int wgrad_simt_smem_bytes(int kt, int nt) {
  const int ring = kWsRing * kWsPx * (kt + nt);
  const int parts = (kWsThreads * 64 / (kt * nt) - 1) * kt * nt;
  return (ring > parts ? ring : parts) * 4;
}

template <typename T, int kMode, int KT, int NT>
__global__ void __launch_bounds__(kWsThreads, 2)
    conv3x3_wgrad_simt_kernel(const T* __restrict__ x,
                              const T* __restrict__ halo,
                              const T* __restrict__ g,
                              float* __restrict__ part,
                              float* __restrict__ dw, int B, int H, int W,
                              int Cin, int Cout, int px_per_split) {
  constexpr int kCopy = KT * NT / 64;      // threads of one copy
  constexpr int PG = kWsThreads / kCopy;  // copies of the tile: 2 or 4
  constexpr int kGrpPx = kWsPx / PG;   // pixels of a stage a copy takes
  constexpr int kV = kMode == kElem ? 1 : 4;  // elements a staging unit
  constexpr int kXCols = KT / kV;
  constexpr int kXStep = kWsThreads / kXCols;
  constexpr int kXItems = kWsPx / kXStep;
  constexpr int kGCols = NT / kV;
  constexpr int kGStep = kWsThreads / kGCols;
  constexpr int kGItems = kWsPx / kGStep;
  extern __shared__ __align__(16) float ws_smem[];
  float* a_s = ws_smem;                         // [ring][16][KT]
  float* g_s = a_s + kWsRing * kWsPx * KT;      // [ring][16][NT]
  const int K = 9 * Cin;
  const int k_tiles = (K + KT - 1) / KT;
  const int k0 = (blockIdx.x % k_tiles) * KT;
  const int n0 = (blockIdx.x / k_tiles) * NT;
  // B * H * W fits an int (odek_conv3x3_wgrad checks).
  const int M = B * H * W;
  const int m_begin = blockIdx.y * px_per_split;
  const int m_end = (int)min((long long)m_begin + px_per_split,
                             (long long)M);
  const int stages = (m_end - m_begin + kWsPx - 1) / kWsPx;
  const int tid = threadIdx.x;
  const int HW = H * W;

  // This thread's staging columns: row k of dW (its tap and channel), and
  // output channel n.
  const int xcol = (tid % kXCols) * kV;
  const int xrow0 = tid / kXCols;
  const int k = k0 + xcol;
  const bool k_ok = k < K;
  const int tap = k_ok ? k / Cin : 0;
  const int ci = k - tap * Cin;
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;
  const int gcol = (tid % kGCols) * kV;
  const int grow0 = tid / kGCols;
  const int n = n0 + gcol;
  const bool n_ok = n < Cout;

  // A staging row's pixel, stepped without division: its index m, row
  // and column.
  struct Px {
    int m, y, xw;
  };
  auto step = [&](Px& c, int n) {
    c.m += n;
    c.xw += n;
    while (c.xw >= W) {
      c.xw -= W;
      if (++c.y == H) c.y = 0;
    }
  };
  // Pixel c's shifted input for this thread's column, or null for zeros.
  auto x_src = [&](const Px& c) -> const T* {
    if (c.m >= m_end || !k_ok) return nullptr;
    const int ys = c.y + dy;
    const int xs = c.xw + dx;
    const bool in_x = ys >= 0 && ys < H;
    if (xs < 0 || xs >= W || !(in_x || halo != nullptr)) return nullptr;
    return in_x ? x + (long long)(c.m + dy * W + dx) * Cin + ci
                : halo + (((long long)(c.m / HW) * 2 + (ys == H)) * W + xs) *
                             Cin +
                      ci;
  };
  // The first pixel of the next stage to be issued for this thread's x
  // and g rows (stages are issued in order).
  Px xnext;
  xnext.m = m_begin + xrow0;
  xnext.y = xnext.m % HW / W;
  xnext.xw = xnext.m % W;

  // The register path's loads: raw bf16 quads, widened when stored, or
  // elements.
  using V = std::conditional_t<kMode == kQuad, uint2, float>;
  auto load = [&](const T* src) -> V {
    if constexpr (kMode == kQuad) {
      return src != nullptr ? __ldg(reinterpret_cast<const uint2*>(src))
                            : make_uint2(0u, 0u);
    } else {
      return src != nullptr ? to_f32(*src) : 0.f;
    }
  };
  auto put = [&](float* dst, V v) {
    if constexpr (kMode == kQuad) {
      *reinterpret_cast<float4*>(dst) = widen4(v);
    } else {
      *dst = v;
    }
  };
  // Stage st into slot st % kWsRing: by cp.async, or loaded and stored
  // (stages are issued in order).
  auto issue = [&](int st) {
    float* as = a_s + (st % kWsRing) * kWsPx * KT;
    float* gs = g_s + (st % kWsRing) * kWsPx * NT;
    Px c = xnext;
#pragma unroll
    for (int j = 0; j < kXItems; ++j) {
      if (j > 0) step(c, kXStep);
      const T* src = x_src(c);
      float* dst = as + (xrow0 + j * kXStep) * KT + xcol;
      if constexpr (kMode == kAsync) {
        cp_async16(dst, src != nullptr ? src : x, src != nullptr);
      } else {
        put(dst, load(src));
        // At most 4 loads in flight: the 64 sums hold the registers.
        if (j % 4 == 3) asm volatile("" ::: "memory");
      }
    }
    // g's rows: the stage's pixels grow0 + j * kGStep.
    const int gm = xnext.m - xrow0 + grow0;
    step(xnext, kWsPx);
#pragma unroll
    for (int j = 0; j < kGItems; ++j) {
      const int m = gm + j * kGStep;
      const T* src =
          m < m_end && n_ok ? g + (long long)m * Cout + n : nullptr;
      float* dst = gs + (grow0 + j * kGStep) * NT + gcol;
      if constexpr (kMode == kAsync) {
        cp_async16(dst, src != nullptr ? src : g, src != nullptr);
      } else {
        put(dst, load(src));
        if (j % 4 == 3) asm volatile("" ::: "memory");
      }
    }
  };

  const int pg = tid / kCopy;
  const int lt = tid % kCopy;
  const int tx = lt % (NT / 8);  // columns 4tx .. and NT/2 + 4tx ..
  const int ty = lt / (NT / 8);  // rows 4ty .. and KT/2 + 4ty ..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // cp.async keeps three stages in flight; the register path loads the
  // next one before the products (into a slot no thread reads now).
  constexpr int kAhead = kMode == kAsync ? kWsRing - 1 : 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < stages) issue(s);
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kAhead - 1>();
    // Stage st is visible; every thread is done with stage st - 1, whose
    // slot the next copy refills.
    __syncthreads();
    if (st + kAhead < stages) issue(st + kAhead);
    cp_async_commit();
    const float* as = a_s + (st % kWsRing) * kWsPx * KT + pg * kGrpPx * KT;
    const float* gs =
        g_s + (st % kWsRing) * kWsPx * NT + pg * kGrpPx * NT;
    // The register path unrolls less: its staging holds more registers.
#pragma unroll(kMode == kAsync ? kGrpPx : 2)
    for (int p = 0; p < kGrpPx; ++p) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + p * KT + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + p * KT + KT / 2 + 4 * ty);
      const float4 g0 =
          *reinterpret_cast<const float4*>(gs + p * NT + 4 * tx);
      const float4 g1 =
          *reinterpret_cast<const float4*>(gs + p * NT + NT / 2 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the ring is free

  // The copies' partials: copies 1 .. PG - 1 to shared memory, copy 0 adds
  // them in order.
  auto tile_at = [&](float* base, int i, int h) {
    const int row = (i < 4 ? 4 * ty + i : KT / 2 + 4 * ty + i - 4);
    return base + row * NT + NT / 2 * h + 4 * tx;
  };
  if (pg > 0) {
    float* mine = ws_smem + (pg - 1) * KT * NT;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(tile_at(mine, i, h)) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
  }
  __syncthreads();
  const bool direct = gridDim.y == 1;
  if (pg == 0) {
#pragma unroll 1
    for (int c = 1; c < PG; ++c) {
      float* theirs = ws_smem + (c - 1) * KT * NT;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              tile_at(theirs, i, h));
          acc[i][4 * h] += v.x;
          acc[i][4 * h + 1] += v.y;
          acc[i][4 * h + 2] += v.z;
          acc[i][4 * h + 3] += v.w;
        }
        // Two loads in flight at a time: the 64 sums hold the registers.
        asm volatile("" ::: "memory");
      }
    }
    float* dst = direct ? dw : part + (long long)blockIdx.y * K * Cout;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = k0 + (i < 4 ? 4 * ty + i : KT / 2 + 4 * ty + i - 4);
      if (kk >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nn = n0 + NT / 2 * h + 4 * tx;
        if (nn >= Cout) continue;
        float* row = dst + (long long)kk * Cout + nn;
        if (Cout % 4 == 0) {  // 16-byte aligned: 4 whole columns
          *reinterpret_cast<float4*>(row) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (nn + e < Cout) row[e] = acc[i][4 * h + e];
          }
        }
      }
    }
  }
  if (direct) return;

  // Every partial is written before any block sums. Block i sums its
  // slice of dW over the splits in order s = 0, 1, ...
  cg::this_grid().sync();
  const long long size = (long long)K * Cout;
  const int splits = gridDim.y;
  const long long blocks = (long long)gridDim.x * gridDim.y;
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (size % 4 == 0) {
    const long long units = size / 4;
    const long long per = (units + blocks - 1) / blocks;
    const long long end = min(blk * per + per, units);
    const float4* src = reinterpret_cast<const float4*>(part);
    for (long long u = blk * per + tid; u < end; u += kWsThreads) {
      // kWsSumBatch loads in flight, added in order of s.
      float4 s = __ldcg(src + u);
      for (int s0 = 1; s0 < splits; s0 += kWsSumBatch) {
        float4 v[kWsSumBatch];
#pragma unroll
        for (int k = 0; k < kWsSumBatch; ++k) {
          if (s0 + k < splits) v[k] = __ldcg(src + (s0 + k) * units + u);
        }
#pragma unroll
        for (int k = 0; k < kWsSumBatch; ++k) {
          if (s0 + k < splits) {
            s.x += v[k].x;
            s.y += v[k].y;
            s.z += v[k].z;
            s.w += v[k].w;
          }
        }
      }
      reinterpret_cast<float4*>(dw)[u] = s;
    }
  } else {
    const long long per = (size + blocks - 1) / blocks;
    const long long end = min(blk * per + per, size);
    for (long long u = blk * per + tid; u < end; u += kWsThreads) {
      float s = __ldcg(part + u);
      for (int s0 = 1; s0 < splits; s0 += kWsSumBatch) {
        float v[kWsSumBatch];
#pragma unroll
        for (int k = 0; k < kWsSumBatch; ++k) {
          if (s0 + k < splits) v[k] = __ldcg(part + (s0 + k) * size + u);
        }
#pragma unroll
        for (int k = 0; k < kWsSumBatch; ++k) {
          if (s0 + k < splits) s += v[k];
        }
      }
      dw[u] = s;
    }
  }
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
//   blocks of NT = 64 channels (128-byte swizzle), NT = 32 (64-byte
//   swizzle) or NT = 16 (32-byte swizzle), each a region of 9*Cin rows.
//   NT (tc_plan): 64 where Cout % 64 == 0, else 32 where Cout % 32 == 0
//   and that plan fits a block's shared memory, else 16.
// * The input halo of a tile, 10 x (TW+2) x Cin, is one set of 4-D TMA
//   boxes at (y0-1, x0-1): the boxes' out-of-bounds elements are zeros, so
//   SAME padding and ragged H and W need no branch. Channels go in chunks
//   of CW = 64, 32 or 16 (swizzle 128, 64 or 32 bytes: one pixel of a chunk
//   is one swizzle row). Two halo stages, one mbarrier each: the load of
//   the next tile runs under the products of this one.
// * With a halo operand the 10 rows come in boxes that never overlap
//   (load_rows_with_halo): row -1 from the halo's row 0 (or x's row y0-1),
//   rows y0 .. y0+7 as one 8-row box, row y0+8 from x or, where it is row
//   H, the halo's row 1; a ragged last tile row by row (row H from the
//   halo, the rows past it zeros beyond the tensor). One box's zero fill
//   would race another's data in the same bytes. The boxes after the
//   first land 128-byte but not 1 KB aligned; TMA swizzles the absolute
//   address, as the descriptors read it (below). Rows of 16-channel
//   chunks are padded to 128 bytes (TcPlan::pitch) and come row by row.
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
//   commit group, fp32 sums in registers. Each column block is a full pass
//   over the halo and ends in its own wait, epilogue and store, so a
//   'model' rank's Cout 32 takes one 32-channel block and not two of 16:
//   the halo (A, 2 KB a k-step) is read from shared memory once, with
//   1.5 KB of operands a 16K MACs where N = 16 took 2.5 KB (about 12
//   clocks of shared memory against 20, inferred from the operand sizes),
//   and the tensor cores wait through one epilogue a block, not two. The loop is unrolled at compile
//   time for Cin = 16, 32 and 64 (KS = Cin/16 = 1, 2, 4): in a runtime
//   loop ptxas waits for each wgmma before issuing the next. Other widths
//   take that slower runtime loop (KS = 0).
// * Two warpgroups: warpgroup w owns blocks w, w + 2, ... of the tile.
// * Epilogue: round once to bf16, write the 8 x 8 x NT block into a
//   staging buffer in shared memory with the output tensor map's swizzle,
//   and store it with one TMA store, which clips what lies outside the
//   image. Storing the fragments directly, 4 bytes a lane, took a third
//   of the tile's time.
// * fp32 output (OutT = float; the column-parallel dx partials of a bf16
//   step under a 'model' axis, summed across ranks before one rounding):
//   the fp32 sums are staged unrounded. A pixel of 64 fp32 channels is
//   256 bytes, past TMA's 128-byte swizzle span, so the block is staged
//   and stored as NT / OB boxes of OB = min(NT, 32) channels (rows of at
//   most 128 bytes, swizzled by their width), one TMA store each. The
//   staging buffer doubles to 8 x 8 x NT x 4 bytes a warpgroup (at NT 32 one
//   box of 32 channels, 8 KB). Bound by
//   the fp32 bytes written: at (128, 16, 16, 32) -> 64, 2.1 MB of bf16 in
//   and 8.4 MB out, 3.1 us at 3.35 TB/s.
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

// Output channels of one TMA store box of a K1 block: rows of at most
// 128 bytes (TMA's widest swizzle), so all NT in bf16 and 32 in fp32.
__host__ __device__ constexpr int out_box(int nt, int out_size) {
  return nt < 128 / out_size ? nt : 128 / out_size;
}

// Shared-memory plan of one launch; mirrors ops/conv3x3.py::_tc_smem_bytes.
struct TcPlan {
  int tw, halo_w, halo_h;
  int cw;              // channels per halo chunk (64, 32 or 16)
  int n_chunks;        // Cin / cw
  int pitch;           // bytes from one halo row of a chunk to the next
  int chunk_bytes;     // one chunk of one stage, 1 KB aligned
  int stage_bytes;     // n_chunks * chunk_bytes
  int nt;              // output channels per wgmma (64, 32 or 16)
  int w_region_bytes;  // 9*Cin rows of nt channels, 1 KB aligned
  int w_bytes;         // Cout / nt regions
  int ob;              // output channels of one store box (rows <= 128 B)
  int out_bytes;       // one warpgroup's 8 x 8 x nt staging buffer
  int smem_bytes;      // weights + 2 stages + 2 staging + 1 KB to align
};

// The plan at `nt` output channels a column block. out_size: bytes of an
// output element, 2 (bf16) or 4 (fp32). With a halo operand the stage's
// rows come in separate TMA boxes, each of which must land 128-byte
// aligned: rows of 16-channel chunks (an odd number of 64-byte halves) are
// padded to the next 128 bytes (ops/conv3x3.py::_tc_smem_bytes with
// `halo`). The tensor-core rule (uses_tensor_cores) does not count that
// padding; the launcher refuses a halo plan that does not fit.
TcPlan tc_plan_at(int Cin, int Cout, int tw, int out_size, bool halo,
                  int nt) {
  TcPlan p;
  p.tw = tw;
  p.halo_w = tw + 2;
  p.halo_h = kTcTileRows + 2;
  p.cw = Cin % 64 == 0 ? 64 : (Cin % 32 == 0 ? 32 : 16);
  p.n_chunks = Cin / p.cw;
  p.pitch = p.halo_w * p.cw * 2;
  if (halo) p.pitch = (p.pitch + 127) / 128 * 128;
  p.chunk_bytes = round1k(p.halo_h * p.pitch);
  p.stage_bytes = p.n_chunks * p.chunk_bytes;
  p.nt = nt;
  p.w_region_bytes = round1k(9 * Cin * p.nt * 2);
  p.w_bytes = (Cout / p.nt) * p.w_region_bytes;
  p.ob = out_box(p.nt, out_size);
  p.out_bytes = round1k(64 * p.nt * out_size);
  p.smem_bytes = p.w_bytes + 2 * p.stage_bytes + 2 * p.out_bytes + 1024;
  return p;
}

// The NT rule (mirrored by ops/conv3x3.py::tc_nt): 64 where Cout % 64 ==
// 0; else 32 where Cout % 32 == 0 and that plan (with this call's halo
// padding) fits a block's shared memory; else 16, the plan every such call
// took before NT 32, so no call leaves the tensor cores. `nt` other than 0
// asks for that column block instead (a comparison of plans).
TcPlan tc_plan(int Cin, int Cout, int tw, int out_size, bool halo,
               int nt = 0) {
  if (nt == 0) {
    nt = Cout % 64 == 0 ? 64 : 16;
    if (Cout % 64 != 0 && Cout % 32 == 0 &&
        tc_plan_at(Cin, Cout, tw, out_size, halo, 32).smem_bytes <=
            kTcMaxSmem) {
      nt = 32;
    }
  }
  return tc_plan_at(Cin, Cout, tw, out_size, halo, nt);
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

// The 10 input rows y0 - 1 .. y0 + 8 of a tile of a map with a halo
// operand (a 'space' rank's rows), into one stage chunk of 10 rows
// `pitch` bytes apart at dst, channels from c, pixels from xs, image b.
// Row -1 comes from the halo's row 0 and row H from its row 1; rows of x
// from x8 (a box of 8 rows, where the rows are `dense`: pitch is the
// box's row) or x1 (one row), and rows past H + 1 from x1 beyond the
// tensor, so zeros. Every stage row is written by exactly one box (two
// boxes writing one row would race: a box's zero fill too), and the boxes
// land 10 rows of bytes, as the one 10-row box without a halo.
__device__ __forceinline__ void load_rows_with_halo(
    uint32_t dst, const CUtensorMap* x8, const CUtensorMap* x1,
    const CUtensorMap* hm, uint32_t bar, int pitch, bool dense, int c,
    int xs, int y0, int b, int H) {
  if (y0 == 0) {
    tma_load_4d(dst, hm, bar, c, xs, 0, b);
  } else {
    tma_load_4d(dst, x1, bar, c, xs, y0 - 1, b);
  }
  if (dense && y0 + kTcTileRows <= H) {
    tma_load_4d(dst + pitch, x8, bar, c, xs, y0, b);
    const uint32_t last = dst + (kTcTileRows + 1) * pitch;
    if (y0 + kTcTileRows == H) {
      tma_load_4d(last, hm, bar, c, xs, 1, b);
    } else {
      tma_load_4d(last, x1, bar, c, xs, y0 + kTcTileRows, b);
    }
    return;
  }
  // A ragged last tile, or padded rows: row by row.
  for (int r = 1; r < kTcTileRows + 2; ++r) {
    const int y = y0 - 1 + r;
    if (y == H) {
      tma_load_4d(dst + r * pitch, hm, bar, c, xs, 1, b);
    } else {
      tma_load_4d(dst + r * pitch, x1, bar, c, xs, y, b);
    }
  }
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

// D (64 x 32) += A (64 x 16) . B (16 x 32): a 'model' rank's Cout 32 in
// one column block (B under the 64-byte swizzle).
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n32k16<0, 1>(d, a, b);
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

template <int NT, int KS, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv3x3_fwd_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap x1_map,
                          const __grid_constant__ CUtensorMap h_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap out_map, int B,
                          int H, int W, int Cin, int Cout, TcPlan p,
                          bool has_halo) {
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
      if (has_halo) {
        load_rows_with_halo(dst + c * p.chunk_bytes, &x_map, &x1_map, &h_map,
                            bar, p.pitch, p.pitch == p.halo_w * cwb,
                            c * p.cw, x0 - 1, y0, b, H);
      } else {
        tma_load_4d(dst + c * p.chunk_bytes, &x_map, bar, c * p.cw, x0 - 1,
                    y0 - 1, b);
      }
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
  const uint32_t row_step = p.pitch >> 4;
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
        constexpr int OB = out_box(NT, sizeof(OutT));
        constexpr int kBoxBytes = 64 * OB * (int)sizeof(OutT);
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          const int pixel = (2 * warp + half_row) * 8 + g;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const float lo = acc[4 * j + 2 * half_row];
            const float hi = acc[4 * j + 2 * half_row + 1];
            const int c = 8 * j + 2 * t4;
            const uint32_t addr =
                out_stage + (c / OB) * kBoxBytes +
                swizzle((pixel * OB + c % OB) * (int)sizeof(OutT),
                        OB * (int)sizeof(OutT));
            if constexpr (sizeof(OutT) == 2) {
              __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
              asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                           "r"(*reinterpret_cast<uint32_t*>(&v))
                           : "memory");
            } else {
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr),
                           "f"(lo), "f"(hi)
                           : "memory");
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        warpgroup_sync(wg);
        if (leader) {
#pragma unroll
          for (int box = 0; box < NT / OB; ++box) {
            tma_store_4d(&out_map, out_stage + box * kBoxBytes,
                         nb * NT + box * OB, x0 + blk * 8, y0, b);
          }
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

// A bf16 (elem 2) or fp32 (elem 4) NHWC tensor (B, H, W, C) as a TMA
// map with box (box_c, box_w, box_h, 1), swizzled by box_c * elem bytes.
CUresult encode_nhwc(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int B, int H, int W, int C, int box_c, int box_w,
                     int box_h, int elem = 2) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * elem,
                                 (cuuint64_t)W * C * elem,
                                 (cuuint64_t)H * W * C * elem};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map,
                elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(box_c * elem),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---------------------------------------------------------------------------
// Tensor-core K2 (bf16): dW (9*Cin, Cout) = patches^T . g, fp32 sums.
//
// Orientation. One wgmma.m64nNTk16 per (tap, 16 pixels): M = 64 input
// channels (A: the halo, shifted by the tap), N = NT output channels (B:
// the cotangent tile), K = 16 pixels. Both operands are read straight from
// the TMA tiles by descriptor, MN-major (channels are the contiguous axis,
// one pixel is one swizzle row; the instruction's transpose flags say so).
// NT is 64 where Cout % 64 == 0 (a 128-byte g row) and 32 otherwise (a
// 64-byte g row under the 64-byte swizzle: a 'model' rank's Cout 32 at
// width 64). Rule: Cin % 64 == 0 and Cout % 32 == 0; a wider conv has
// (Cin/64) * (Cout/NT) channel pairs, each its own blocks.
//
// * Tiles are 8 image rows by TW = 8, 16 or 32 pixels, as for K1. A K-step
//   is two groups of 8 pixels, each 8 consecutive pixels of one image row:
//   8 consecutive swizzle rows of the g tile and, for tap (dy, dx), of the
//   halo, starting dy halo rows and dx pixels on. The descriptor's stride
//   byte offset is the distance between the two groups: 8 pixels (the next
//   8 of the same row, TW >= 16) or one halo row (the next image row,
//   TW = 8, for the halo; 8 pixels for g). As for K1, the start address is
//   not 1 KB aligned and the base offset stays 0.
// * A block owns one tap row dy of one channel pair over a run of tiles;
//   its three warpgroups own dx = 0, 1, 2, one 64 x NT fp32 accumulator
//   (NT / 2 registers) each. So a block's partial is 48 KB at NT = 64 (24
//   KB at 32), not the 147 KB of all 9 taps: writing the partials to L2
//   and reading them back cost more than the products when a block held
//   all 9 taps (PERF.md §6).
// * The halo (10 x (TW+2) x 64) and the g tile (8 x TW x NT) come by 4-D
//   TMA into 2-kWgMaxStages stages (the wrapper's plan says how many); the
//   box elements outside the image are zeros, so SAME padding and ragged
//   tiles (g = 0 there) need no branch. With a halo operand the halo's
//   rows come as in K1 (load_rows_with_halo); g keeps its own rows. A tile's TW/2 wgmmas go out back
//   to back in one commit group (unrolled by TW), and the next tile's group
//   goes out before this one is waited for.
// * Reduction across blocks, in the same launch, deterministic. The launch
//   is cooperative (every block resident at once): block (pair, dy, s)
//   writes its partial (staged in shared memory, 16-byte stores) to
//   scratch[s]; cooperative groups' grid sync; then every block sums a
//   fixed slice of dW over s in a fixed tree (q threads a unit, each a
//   fixed range of s in order, then the q sums in order). No atomics on
//   the data, and the plan (T, S, q, stages) is a function of the shape
//   alone, so two calls are bit-equal.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // three warpgroups, one per tap column dx
constexpr int kWgMaxStages = 6;
// One block's partial: the 3 taps of its row, 64 x NT fp32 each, in
// 16-byte units; a channel pair's partial is 3 of them (9 taps).
__host__ __device__ constexpr int wg_row_units(int nt) {
  return 3 * 64 * nt / 4;
}

// Shared-memory plan of the tensor-core K2: at most 231,424 bytes (three
// stages of 8 x 32 tiles at NT = 64), so it fits at every width.
struct WgPlan {
  int tw, halo_w, halo_h;
  int nt;           // output channels of a block's wgmma, 64 or 32
  int halo_bytes;   // one 64-channel halo, 1 KB aligned
  int stage_bytes;  // halo + the NT-channel g tile, each 1 KB aligned
  int stages;       // 2 to kWgMaxStages
  int smem_bytes;   // the stages or the staged partial, + 1 KB to align
};

// `stages` 0 takes as many as fit, up to 4; else exactly `stages`, which
// must fit (stages 0 if it does not).
WgPlan wg_plan(int tw, int nt, int stages) {
  WgPlan p;
  p.tw = tw;
  p.nt = nt;
  p.halo_w = tw + 2;
  p.halo_h = kTcTileRows + 2;
  p.halo_bytes = round1k(p.halo_h * p.halo_w * 128);
  p.stage_bytes = p.halo_bytes + round1k(kTcTileRows * tw * nt * 2);
  const int fit = (kTcMaxSmem - 1024) / p.stage_bytes;
  p.stages = stages == 0 ? std::max(2, std::min(4, fit))
             : (stages >= 2 && stages <= std::min(kWgMaxStages, fit))
                 ? stages
                 : 0;
  p.smem_bytes =
      std::max(p.stages * p.stage_bytes, wg_row_units(nt) * 16) + 1024;
  return p;
}

template <int NT>
__device__ __forceinline__ void wgrad_mma(float (&acc)[NT / 2], uint64_t a,
                                          uint64_t b) {
  if constexpr (NT == 64) {
    wgmma_m64n64k16<1, 1>(acc, a, b);
  } else {
    wgmma_m64n32k16<1, 1>(acc, a, b);
  }
}

// The products of one tile for one tap: halo_tap addresses halo pixel
// (dy, dx) of the stage, g_tile the cotangent tile, both MN-major
// (transpose flags 1, 1). The descriptor encoding is the one of
// k_major_desc (128-byte swizzle for the halo, NT * 2 bytes for g);
// descriptors step by adding to their start address in 16-byte units (8
// a halo pixel, NT / 8 a g pixel).
template <int TW, int NT>
__device__ __forceinline__ void wgrad_tile_products(float (&acc)[NT / 2],
                                                    uint32_t halo_tap,
                                                    uint32_t g_tile) {
  constexpr int halo_w = TW + 2;
  constexpr int g_px = NT * 2;  // bytes of one pixel of the g tile
  // Second group of 8 pixels: the next 8 of the row, or the next row.
  constexpr uint32_t a_sbo = TW == 8 ? halo_w * 128 : 1024;
  const uint64_t a0 = k_major_desc(halo_tap, a_sbo, 1);
  const uint64_t b0 = k_major_desc(g_tile, 8 * g_px, NT == 64 ? 1 : 2);
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
    wgrad_mma<NT>(acc, a0 + (py * halo_w + px) * 8,
                  b0 + (py * TW + px) * (g_px / 16));
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

template <int TW, int NT>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv3x3_wgrad_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap x1_map,
                            const __grid_constant__ CUtensorMap h_map,
                            const __grid_constant__ CUtensorMap g_map,
                            float* __restrict__ scratch,
                            float* __restrict__ dw, int B, int H, int W,
                            int Cin, int Cout, int splits,
                            int tiles_per_split, WgPlan p, bool has_halo) {
  // 16-byte units of a partial row (64 x NT fp32 per tap, 3 taps), of a
  // channel pair's 9 taps, and of one dW row segment of NT channels.
  constexpr int kRowUnits = wg_row_units(NT);
  constexpr int kPairUnits = 3 * kRowUnits;
  constexpr int kUnits = NT / 4;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kWgMaxStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x;
  // Block (pair, dy, split): tap row dy of channel pair (mb, nb) over the
  // tiles of run `split`.
  const int split = blockIdx.x % splits;
  const int dy = (blockIdx.x / splits) % 3;
  const int pair = blockIdx.x / splits / 3;
  const int n_blocks = Cout / NT;  // output-channel blocks
  const int mb = pair / n_blocks;  // input-channel block
  const int nb = pair % n_blocks;  // output-channel block

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_img = tiles_x * ((H + kTcTileRows - 1) / kTcTileRows);
  const int n_tiles = B * tiles_img;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n = max(t_end - t_begin, 0);
  const uint32_t stage_tx =
      p.halo_h * p.halo_w * 128 + kTcTileRows * TW * NT * 2;

  auto load_tile = [&](int i, int stage) {
    const int tile = t_begin + i;
    const int b = tile / tiles_img;
    const int r = tile - b * tiles_img;
    const int y0 = (r / tiles_x) * kTcTileRows;
    const int x0 = (r % tiles_x) * TW;
    const uint32_t bar = smem_u32(&bars[stage]);
    const uint32_t dst = base + stage * p.stage_bytes;
    mbar_expect_tx(bar, stage_tx);
    if (has_halo) {
      load_rows_with_halo(dst, &x_map, &x1_map, &h_map, bar, p.halo_w * 128,
                          true, mb * 64, x0 - 1, y0, b, H);
    } else {
      tma_load_4d(dst, &x_map, bar, mb * 64, x0 - 1, y0 - 1, b);
    }
    tma_load_4d(dst + p.halo_bytes, &g_map, bar, nb * NT, x0, y0, b);
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
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  // One commit group a tile, and the next tile's group goes out before
  // this one is waited for: the tensor cores do not drain between tiles.
  fence_operands(acc);
  wgmma_fence();
  for (int i = 0; i < n; ++i) {
    const int stage = i % p.stages;
    mbar_wait(smem_u32(&bars[stage]), (i / p.stages) & 1);
    const uint32_t halo = base + stage * p.stage_bytes;
    wgrad_tile_products<TW, NT>(acc, halo + (dy * p.halo_w + dx) * 128,
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
  // kUnits)] of 64 x NT fp32, then copied out whole with 16-byte stores
  // to taps dy*3 .. dy*3+2 of its pair's region of scratch[split].
  // Fragment of a thread: rows ci = 16 * warp + g and + 8, output channels
  // 8j + 2t and 8j + 2t + 1. The XOR puts the 8 rows of a store in 8
  // distinct bank groups.
  float4* staged = reinterpret_cast<float4*>(smem_raw +
                                             (base - smem_u32(smem_raw)));
  {
    const int warp = (tid % 128) / 32;
    const int g = (tid % 32) / 4;
    const int t4 = tid % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = warp * 16 + g + 8 * half;
      float* row = reinterpret_cast<float*>(staged + dx * 64 * kUnits +
                                            ci * kUnits);
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int unit = (2 * j + t4 / 2) ^ (ci % kUnits);
        *reinterpret_cast<float2*>(row + 4 * unit + 2 * (t4 % 2)) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
  __syncthreads();
  const int pairs = (Cin / 64) * n_blocks;
  {
    float4* part = reinterpret_cast<float4*>(scratch) +
                   (long long)(split * pairs + pair) * kPairUnits +
                   dy * kRowUnits;
    for (int i = tid; i < kRowUnits; i += kWgThreads) part[i] = staged[i];
  }

  // Every partial is written before any block sums.
  cg::this_grid().sync();

  // This block's slice of the partials' units [c0, c0 + cols), summed over
  // the splits: q threads a unit, thread r over splits [r*S/q, (r+1)*S/q),
  // then the q sums in order of r; each sum goes to its place in dW.
  const long long n4 = (long long)pairs * kPairUnits;
  const long long per = (n4 + gridDim.x - 1) / gridDim.x;
  const long long c0 = blockIdx.x * per;
  const int cols = (int)max(min(c0 + per, n4) - c0, 0LL);
  const float4* src = reinterpret_cast<const float4*>(scratch);
  float4* out = reinterpret_cast<float4*>(dw);
  // dW's unit of partial unit e: pair, tap, row ci, swizzled unit.
  auto dw_unit = [&](long long e) {
    const int pr = (int)(e / kPairUnits);
    const int rem = (int)(e - (long long)pr * kPairUnits);
    const int tap = rem / (64 * kUnits);
    const int ci = (rem % (64 * kUnits)) / kUnits;
    const int unit = (rem % kUnits) ^ (ci % kUnits);
    const int row = tap * Cin + (pr / n_blocks) * 64 + ci;
    return ((long long)row * Cout + (pr % n_blocks) * NT) / 4 + unit;
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

using TcKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                          CUtensorMap, int, int, int, int, int, TcPlan, bool);

template <int NT, typename OutT>
TcKernel tc_kernel(int Cin) {
  switch (Cin) {
    case 16: return conv3x3_fwd_tc_kernel<NT, 1, OutT>;
    case 32: return conv3x3_fwd_tc_kernel<NT, 2, OutT>;
    case 64: return conv3x3_fwd_tc_kernel<NT, 4, OutT>;
    default: return conv3x3_fwd_tc_kernel<NT, 0, OutT>;
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

// The input's tensor maps, boxes of `cw` channels by `halo_w` pixels: x
// (B, H, W, C) in boxes of 10 rows (x8_map) without a halo operand; with
// one, x in boxes of 8 rows (x8_map) and of one (x1_map), and the halo
// (B, 2, W, C) in boxes of one row (h_map). Without a halo the last two
// are copies of the first, unread.
CUresult encode_input(EncodeTiled encode, CUtensorMap* x8_map,
                      CUtensorMap* x1_map, CUtensorMap* h_map, const void* x,
                      const void* halo, int B, int H, int W, int C, int cw,
                      int halo_w) {
  CUresult res = encode_nhwc(encode, x8_map, x, B, H, W, C, cw, halo_w,
                             halo == nullptr ? kTcTileRows + 2 : kTcTileRows);
  if (res != CUDA_SUCCESS || halo == nullptr) {
    *x1_map = *h_map = *x8_map;
    return res;
  }
  res = encode_nhwc(encode, x1_map, x, B, H, W, C, cw, halo_w, 1);
  if (res != CUDA_SUCCESS) return res;
  return encode_nhwc(encode, h_map, halo, B, 2, W, C, cw, halo_w, 1);
}

// The kernel of column blocks NT for Cin's products and this output type.
template <typename OutT>
TcKernel tc_kernel_for(int nt, int Cin) {
  return nt == 64   ? tc_kernel<64, OutT>(Cin)
         : nt == 32 ? tc_kernel<32, OutT>(Cin)
                    : tc_kernel<16, OutT>(Cin);
}

// out_size: 2 for a bf16 output, 4 for fp32 (the sums unrounded). nt: 0
// for tc_plan's rule, else 64, 32 or 16 dividing Cout.
int launch_fwd_tc(const void* x, const void* halo, const void* w, void* out,
                  int B, int H, int W, int Cin, int Cout, int tw,
                  int out_size, int nt, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(halo) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (!aligned || Cin % 16 || Cout % 16 || Cout > 256 ||
      (tw != 8 && tw != 16 && tw != 32) ||
      (nt != 0 && nt != 16 && nt != 32 && nt != 64) ||
      (nt != 0 && Cout % nt)) {
    return (int)cudaErrorInvalidValue;
  }
  const TcPlan p = tc_plan(Cin, Cout, tw, out_size, halo != nullptr, nt);
  if (p.smem_bytes > kTcMaxSmem) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTcMapError;

  CUtensorMap x_map, x1_map, h_map, w_map, out_map;
  CUresult res = encode_input(encode, &x_map, &x1_map, &h_map, x, halo, B, H,
                              W, Cin, p.cw, p.halo_w);
  if (res == CUDA_SUCCESS) {
    res = encode_nhwc(encode, &out_map, out, B, H, W, Cout, p.ob, 8, 8,
                      out_size);
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
  const TcKernel kernel = out_size == 4
                              ? tc_kernel_for<float>(p.nt, Cin)
                              : tc_kernel_for<__nv_bfloat16>(p.nt, Cin);
  const cudaError_t attr =
      allow_max_smem(reinterpret_cast<const void*>(kernel), kTcMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, kTcThreads, p.smem_bytes, stream>>>(
      x_map, x1_map, h_map, w_map, out_map, B, H, W, Cin, Cout, p,
      halo != nullptr);
  return 0;
}

using WgKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                          float*, float*, int, int, int, int, int, int, int,
                          WgPlan, bool);

template <int NT>
WgKernel wg_kernel(int tw) {
  return tw == 8    ? conv3x3_wgrad_tc_kernel<8, NT>
         : tw == 16 ? conv3x3_wgrad_tc_kernel<16, NT>
                    : conv3x3_wgrad_tc_kernel<32, NT>;
}

int launch_wgrad_tc(const void* x, const void* halo, const void* g,
                    float* scratch, float* dw, int B, int H, int W, int Cin,
                    int Cout, int tw, int splits, int tiles_per_split,
                    int stages, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(halo) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(scratch) |
                         reinterpret_cast<uintptr_t>(dw)) & 15) == 0;
  const int nt = Cout % 64 == 0 ? 64 : 32;
  const int tiles = B * ((H + kTcTileRows - 1) / kTcTileRows) *
                    ((W + tw - 1) / tw);
  const int grid = (Cin / 64) * (Cout / nt) * 3 * splits;
  if (!aligned || Cin % 64 || Cout % 32 || (tw != 8 && tw != 16 && tw != 32) ||
      splits < 1 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < tiles || grid > sm_count()) {
    return (int)cudaErrorInvalidValue;
  }
  const WgPlan p = wg_plan(tw, nt, stages);
  if (p.stages == 0) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTcMapError;
  CUtensorMap x_map, x1_map, h_map, g_map;
  CUresult res = encode_input(encode, &x_map, &x1_map, &h_map, x, halo, B, H,
                              W, Cin, 64, p.halo_w);
  if (res == CUDA_SUCCESS) {
    res = encode_nhwc(encode, &g_map, g, B, H, W, Cout, nt, tw, kTcTileRows);
  }
  if (res != CUDA_SUCCESS) return kTcMapError + (int)res;

  const WgKernel kernel = nt == 64 ? wg_kernel<64>(tw) : wg_kernel<32>(tw);
  const cudaError_t attr =
      allow_max_smem(reinterpret_cast<const void*>(kernel), kTcMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  // Cooperative: the launch fails rather than run blocks that could not
  // all be resident, which the grid sync needs.
  bool has_halo = halo != nullptr;
  void* args[] = {&x_map, &x1_map, &h_map, &g_map, &scratch, &dw, &B, &H,
                  &W, &Cin, &Cout, &splits, &tiles_per_split,
                  const_cast<WgPlan*>(&p), &has_halo};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kWgThreads),
      args, p.smem_bytes, stream);
}

// Blocks of `kernel` an SM holds with `smem` bytes each, asked once a
// kernel and process (each SIMT K2 kernel has one size): the query costs
// host time on every launch of a host-bound step. -1 if it fails.
int resident_per_sm(const void* kernel, int threads, int smem) {
  static std::atomic<const void*> keys[32] = {};
  static std::atomic<int> counts[32] = {};
  for (int i = 0; i < 32; ++i) {
    const void* key = keys[i].load();
    if (key == kernel) return counts[i].load();
    if (key != nullptr) continue;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem) != cudaSuccess) {
      return -1;
    }
    counts[i].store(n);
    keys[i].store(kernel);
    return n;
  }
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kernel, threads, smem) == cudaSuccess ? n : -1;
}

unsigned int ceil_div(long long a, long long b) {
  return (unsigned int)((a + b - 1) / b);
}

// The SIMT kernels by copy mode and tile: K1 by output channels a block
// (16 or 32), K2 by the rows x columns of a dW tile (64 x 64, 128 x 64
// or 64 x 128).
template <typename T, int kMode>
auto simt_fwd_kernel(int bn) {
  return bn == 32 ? conv3x3_fwd_simt_kernel<T, kMode, 2>
                  : conv3x3_fwd_simt_kernel<T, kMode, 1>;
}

template <typename T, int kMode>
auto simt_wgrad_kernel(int kt, int nt) {
  return kt == 128   ? conv3x3_wgrad_simt_kernel<T, kMode, 128, 64>
         : nt == 128 ? conv3x3_wgrad_simt_kernel<T, kMode, 64, 128>
                     : conv3x3_wgrad_simt_kernel<T, kMode, 64, 64>;
}

}  // namespace

// K1, SIMT: x (B,H,W,Cin), halo (B,2,W,Cin) or null, w (9*Cin, Cout), out
// (B,H,W,Cout); one dtype; the halo 16-byte aligned. A block takes a tile
// of bn (16 or 32) output channels and steps_per_block row steps of one
// 16-column strip (ops/conv3x3.py::simt_plan); one launch a slab of input
// channels (simt_slab), each after the first adding to the output, which
// needs fp32. Returns cudaErrorInvalidValue for a plan outside that or a
// misaligned halo, else the launches' error.
extern "C" int odek_conv3x3_fwd(const void* x, const void* halo,
                                const void* w, void* out, int B, int H,
                                int W, int Cin, int Cout, int bn,
                                int steps_per_block, int dtype,
                                void* stream) {
  if ((bn != 16 && bn != 32) || steps_per_block < 1 ||
      reinterpret_cast<uintptr_t>(halo) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int slab = simt_slab(Cin, bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    if (slab < Cin && !std::is_same_v<T, float>) {
      return (int)cudaErrorInvalidValue;
    }
    // 16-byte cp.async (fp32) or 8-byte loads (bf16) of channel quads
    // where channels come in fours and the pointers are aligned.
    const bool quads = Cin % 4 == 0 && Cout % 4 == 0 && aligned4<T>(x) &&
                       aligned4<T>(w);  // the halo is 16-byte aligned
    auto kernel = simt_fwd_kernel<T, kElem>(bn);
    if constexpr (std::is_same_v<T, float>) {
      if (quads) kernel = simt_fwd_kernel<T, kAsync>(bn);
    } else {
      if (quads) kernel = simt_fwd_kernel<T, kQuad>(bn);
    }
    const cudaError_t attr =
        allow_max_smem(reinterpret_cast<const void*>(kernel), kSimtMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    for (int c0 = 0; c0 < Cin; c0 += slab) {
      const int cs = std::min(slab, Cin - c0);
      const int sr = kSimtGroups / simt_split(cs);
      const long long blocks =
          (long long)B * ceil_div(W, kSimtTileW) *
          ceil_div(ceil_div(H, sr), steps_per_block) * ceil_div(Cout, bn);
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      kernel<<<(unsigned int)blocks, kSimtThreads, simt_smem_bytes(cs, bn),
               st>>>(static_cast<const T*>(x), static_cast<const T*>(halo),
                     static_cast<const T*>(w), static_cast<T*>(out), B, H, W,
                     Cin, Cout, c0, cs, steps_per_block, c0 > 0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  });
}

// K1, tensor cores: as odek_conv3x3_fwd (the halo too) for bf16 x and w
// with Cin % 16 == 0, Cout % 16 == 0, Cout <= 256, 16-byte aligned
// pointers and output
// tiles 8 rows high and tile_w (8, 16 or 32) wide; out is bf16
// (out_dtype 1, rounded once) or fp32 (out_dtype 0, the fp32 sums); nt 0
// takes tc_plan's column blocks, 16, 32 or 64 (dividing Cout) those.
// Returns cudaErrorInvalidValue for arguments outside that, 10000 + the
// CUresult if a tensor map is refused, else cudaGetLastError().
extern "C" int odek_conv3x3_fwd_tc(const void* x, const void* halo,
                                   const void* w, void* out, int B, int H,
                                   int W, int Cin, int Cout, int tile_w,
                                   int dtype, int out_dtype, int nt,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  const int out_size = out_dtype == 0 ? 4 : 2;
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    if constexpr (std::is_same_v<decltype(tag), __nv_bfloat16>) {
      return launch_fwd_tc(x, halo, w, out, B, H, W, Cin, Cout, tile_w,
                           out_size, nt, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
}

// K2, SIMT: x (B,H,W,Cin), halo (B,2,W,Cin) or null (16-byte aligned), g
// (B,H,W,Cout) of one dtype; dw (9*Cin, Cout) fp32. Tiles of kt rows of
// dW by nt channels (64 x 64, 128 x 64 or 64 x 128); pixels [s*px_per_split,
// (s+1)*px_per_split) of the B*H*W go to split s
// (ops/conv3x3.py::wgrad_simt_plan): px_per_split a multiple of 16, every
// split non-empty, together covering every pixel. With splits > 1 the
// partials go to scratch (splits, 9*Cin, Cout) fp32 and the same,
// cooperative, launch sums them in order after a grid sync (every block
// resident, or the launch is refused); with one split scratch is unused.
// Returns cudaErrorInvalidValue for a plan outside that, else the
// launch's error.
extern "C" int odek_conv3x3_wgrad(const void* x, const void* halo,
                                  const void* g, void* scratch, void* dw,
                                  int B, int H, int W, int Cin, int Cout,
                                  int kt, int nt, int splits,
                                  long long px_per_split, int dtype,
                                  void* stream) {
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL || reinterpret_cast<uintptr_t>(halo) % 16 ||
      !((kt == 64 && nt == 64) || (kt == 128 && nt == 64) ||
        (kt == 64 && nt == 128)) ||
      splits < 1 || splits > 65535 ||
      px_per_split < 1 || px_per_split % kWsPx ||
      (long long)splits * px_per_split < M ||
      (long long)(splits - 1) * px_per_split >= M ||
      (splits > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(ceil_div(9 * Cin, kt) * ceil_div(Cout, nt), splits);
  const int smem = wgrad_simt_smem_bytes(kt, nt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const bool quads = Cin % 4 == 0 && Cout % 4 == 0 && aligned4<T>(x) &&
                       aligned4<T>(g);  // the halo is 16-byte aligned
    auto kernel = simt_wgrad_kernel<T, kElem>(kt, nt);
    if constexpr (std::is_same_v<T, float>) {
      if (quads) kernel = simt_wgrad_kernel<T, kAsync>(kt, nt);
    } else {
      if (quads) kernel = simt_wgrad_kernel<T, kQuad>(kt, nt);
    }
    const cudaError_t attr =
        allow_max_smem(reinterpret_cast<const void*>(kernel), kSimtMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    const T* xp = static_cast<const T*>(x);
    const T* hp = static_cast<const T*>(halo);
    const T* gp = static_cast<const T*>(g);
    float* part = static_cast<float*>(scratch);
    float* out = static_cast<float*>(dw);
    int b = B, h = H, w = W, cin = Cin, cout = Cout;
    int px = (int)px_per_split;
    if (splits == 1) {
      kernel<<<grid, kWsThreads, smem, st>>>(xp, hp, gp, part, out, b, h, w,
                                              cin, cout, px);
      return 0;
    }
    // Cooperative: the launch fails rather than run blocks that could not
    // all be resident, which the grid sync needs.
    const int per_sm = resident_per_sm(reinterpret_cast<const void*>(kernel),
                                       kWsThreads, smem);
    if (per_sm < 0) return (int)cudaErrorInvalidValue;
    if ((long long)per_sm * sm_count() < (long long)grid.x * grid.y) {
      return (int)cudaErrorInvalidValue;
    }
    void* args[] = {&xp, &hp, &gp, &part, &out, &b, &h, &w, &cin, &cout,
                    &px};
    return (int)cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), grid, dim3(kWsThreads), args,
        smem, st);
  });
}

// K2, tensor cores: as odek_conv3x3_wgrad (the halo too) for bf16 with
// Cin % 64 == 0,
// Cout % 32 == 0 (output-channel blocks of NT = 64 where Cout % 64 == 0,
// else 32), 16-byte aligned pointers, tiles 8 rows high and tile_w (8, 16
// or 32) wide, `splits` partials of `tiles_per_split` tiles each
// (covering every tile), (Cin/64) * (Cout/NT) * 3 * splits blocks at most
// one per SM, and `stages` TMA stages (0: as many as fit, up to 4; else 2
// to 6 that fit). One cooperative launch. Returns cudaErrorInvalidValue
// for arguments outside that, 10000 + the CUresult if a tensor map is
// refused, else the launch's error.
extern "C" int odek_conv3x3_wgrad_tc(const void* x, const void* halo,
                                     const void* g, void* scratch, void* dw,
                                     int B, int H, int W, int Cin, int Cout,
                                     int tile_w, int splits,
                                     int tiles_per_split, int stages,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    if constexpr (std::is_same_v<decltype(tag), __nv_bfloat16>) {
      return launch_wgrad_tc(x, halo, g, static_cast<float*>(scratch),
                             static_cast<float*>(dw), B, H, W, Cin, Cout,
                             tile_w, splits, tiles_per_split, stages, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
}
