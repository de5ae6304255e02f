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
// highres trainer's features (8, 40, 56, 256), d = 20, stride 2, fp32, the
// 4.7 M in-map (pixel, displacement) pairs are 2.43 GFLOP: operations,
// 36.24 us at the 67 TFLOP/s of the fp32 units. Read window by window,
// every feature pixel comes from L2 once for each of the up to 441 output
// pixels whose window covers it, about 4.7 GB a call: the first SIMT
// K5-K7, which did so, took 636-1015 us there (PERF.md). The SIMT K5-K7
// below stage each feature pixel in shared memory once a tile and reuse
// it from registers; what holds them now is shared-memory and issue
// bandwidth (about 12-20% of the fp32 rate at highres).
//
// K5, K6 and K7 have two kernels each; ops/correlation.py::tc_plan picks
// one.
//
// * corr_fwd_tc_kernel, corr_bwd_f1_tc_kernel and corr_bwd_f2_tc_kernel
//   (bf16, H*W <= 64, C = 64, 128 or 256, 16-byte aligned features): one
//   sample a block, the pixel-pair products on the tensor cores (section
//   "Tensor-core K5-K7" below). The bench shape takes them: K5, K6 and
//   K7 about 13.3, 10.5 and 10.4 us a call alone there, against the first
//   SIMT kernels' 96, 89 and 103 (H100, PERF.md).
// * The SIMT kernels (everything else, fp32 included, so fp32 stays strict
//   fp32 FFMA on the CUDA cores), with tiles from
//   ops/correlation.py::simt_plan (section "SIMT K5-K7" below):
//   K5 (corr_fwd_simt_kernel): parity classes; a tile of 2 rows of f1
//       cells and its partner rows staged 32 channels at a time,
//       double-buffered by cp.async; each thread keeps 2 rows x 4 cells x
//       8 partners of sums in registers over all channels (8 + 8 float4
//       loads for 256 FFMAs); only pairs in the map are computed; the
//       block's outputs, zeros included, are staged and written a pixel's
//       run at a time. On maps of at most 32 cells a class,
//       corr_fwd_pairs_kernel takes every (cell, partner) pair instead.
//   K6 (corr_bwd_f1_simt_kernel): a gather per parity class: a tile of
//       f1 cells walks its halo of f2 partner rows from the first to the
//       last, each row's f2 channels and the cotangent entries the tile
//       needs staged by cp.async, double-buffered (bf16 f2 stays bf16 in
//       shared memory, 16 bytes a copy, and is widened on the read); each
//       thread keeps a 4-cell x 16-channel micro-tile (a float4 of the
//       pair matrix and 16 channels of f2 for 64 FFMAs). Every output adds
//       its displacements in increasing i, as correlation_bwd_f1_plain
//       does. On maps of at most 32 cells a class,
//       corr_bwd_f1_pairs_kernel walks a whole class's partners in the
//       same order.
//   K7 (corr_bwd_f2_simt_kernel): the TPU kernel scatters into overlapping
//       windows of the padded f2, which needs atomics on a GPU. Here it is
//       a gather: a tile of f2 cells walks its halo of source rows from
//       the last to the first, each row's f1 and cotangent entries staged
//       by cp.async, double-buffered; each thread keeps a 4-cell x
//       16-channel micro-tile (one float4 of the pair matrix and four of
//       f1 for 64 FFMAs). Every output adds its displacements in
//       increasing i, as correlation_bwd_f2_plain does. No atomics, so the
//       result is bit-reproducible, and the padded border that the TPU
//       kernel computes and slices away is never computed. On maps of at
//       most 32 cells a class, corr_bwd_f2_pairs_kernel walks a whole
//       class's sources in the same order.
// All the kernels accumulate in fp32 in a fixed order and round once to
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
using odek::warpgroup_sync;
using odek::wgmma_commit;
using odek::wgmma_fence;
using odek::wgmma_m64n64k16;
using odek::wgmma_wait_all;

struct CorrShape {
  int B, H, W, C, d, stride, n;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed cp.async groups are in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// SIMT K5-K7: parity classes, shared-memory halo tiles, register
// micro-tiles.
//
// Parity classes. Every offset i*stride - d is congruent to -d modulo the
// stride, so along one axis the pixels r, r + stride, r + 2*stride, ...
// (class r, `cells` of them) meet only the pixels r2, r2 + stride, ... of
// class r2 = (r - d) mod stride: cell a of class r and displacement i meet
// cell a + k + i of class r2, k = (r - d - r2) / stride. Within a pair of
// classes the correlation is a stride-1 one of n consecutive offsets on a
// dense (H/stride) x (W/stride) grid: 20 x 28 cells and offsets -10..10 at
// the highres trainer's (40, 56) features, d = 20, stride 2. A tile of
// class cells and its halo of partner cells are then dense rectangles.
//
// K5 and K7 stage fp32 in shared memory (bf16 inputs are widened on the
// way); K6 keeps bf16 features as bf16 there, copied 16 bytes at a time,
// and widens them on the read. All multiply and add with FFMA in fp32 (no
// tensor cores, no TF32), sum each output in one fixed order with no
// atomics, divide by C once and round once to the input dtype.
// ops/correlation.py::simt_plan picks the tiles and the launch.
// ---------------------------------------------------------------------------

// One axis of a parity class: cells of class r in a map `size` wide, and
// the class r2 of their partners, offset k and cells.
struct ClassAxis {
  int r, cells, r2, k, cells2;
};

__host__ __device__ __forceinline__ int class_cells(int r, int size,
                                                    int stride) {
  return r < size ? (size - r + stride - 1) / stride : 0;
}

__device__ __forceinline__ ClassAxis class_axis(int r, int size,
                                                const CorrShape& s) {
  ClassAxis a;
  a.r = r;
  a.cells = class_cells(r, size, s.stride);
  a.r2 = ((r - s.d) % s.stride + s.stride) % s.stride;
  a.k = (r - s.d - a.r2) / s.stride;  // exact
  a.cells2 = class_cells(a.r2, size, s.stride);
  return a;
}

__host__ __device__ __forceinline__ int div_up(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

constexpr int kSimtR = 4;            // output cells a micro-tile, along x
constexpr int kSimtMaxThreads = 256;
constexpr int kSmemBytes = 232448;   // the H100's most a block can use
constexpr int kFwdThreads = 192;  // K5's tiles: most threads a block
constexpr int kFwdRows = 2;  // K5: f1 rows of a tile; they share a partner row
constexpr int kFwdQ = 8;     // K5: partner cells a micro-tile
constexpr int kFwdCK = 32;   // K5: channels a chunk
constexpr int kFwdCKP = 36;  // K5: a staged pixel's pitch in floats
constexpr int kPairCells = 32;  // K5: most cells of a class for the pair view
constexpr int kPairQ = 4;    // K5, pair view: partner cells a thread
constexpr int kBwdS = 16;    // K6, K7: channels a micro-tile

// K5's tile: kFwdRows x tx cells of an f1 class (tx a multiple of kSimtR)
// and ny consecutive displacement rows.
struct FwdTile {
  int tx, ny;
};

// K5's pair view: `units` (sample, class) units a block, ck channels a
// stage.
struct PairTile {
  int units, ck;
};

// K6's and K7's tile: ty x tx cells of an f1 (K6) or f2 (K7) class and
// 16 * ncg channels.
struct BwdTile {
  int ty, tx, ncg;
};

// K5's partner rows and columns a block stages, at most: the tile's
// rows' and columns' partners, within the largest class.
__host__ __device__ __forceinline__ int fwd_halo_rows(const FwdTile& t,
                                                      const CorrShape& s) {
  return imin(kFwdRows + t.ny - 1, div_up(s.H, s.stride));
}
__host__ __device__ __forceinline__ int fwd_halo_cols(const FwdTile& t,
                                                      const CorrShape& s) {
  return imin(t.tx + s.n - 1, div_up(s.W, s.stride));
}

// A staged partner row's slots: its columns, and kFwdQ - 1 more that a
// micro-tile reads past the last one (values it never writes out).
__host__ __device__ __forceinline__ int fwd_row_slots(const FwdTile& t,
                                                      const CorrShape& s) {
  return fwd_halo_cols(t, s) + kFwdQ - 1;
}

// Partner chunks of kFwdQ a micro-tile's 4 cells can need.
__host__ __device__ __forceinline__ int fwd_chunks(const FwdTile& t,
                                                   const CorrShape& s) {
  return div_up(imin(s.n + kSimtR - 1, fwd_halo_cols(t, s)), kFwdQ);
}

// Pixel slots of one K5 stage: the f1 tile (kFwdRows x tx) and the
// partner rows; kFwdCKP floats a slot.
__host__ __device__ __forceinline__ long long fwd_slots(const FwdTile& t,
                                                        const CorrShape& s) {
  return (long long)kFwdRows * t.tx +
         (long long)fwd_halo_rows(t, s) * fwd_row_slots(t, s);
}

// K5's dynamic shared memory in floats: two stages, or the block's staged
// outputs, the larger.
__host__ __device__ __forceinline__ long long fwd_smem_floats(
    const FwdTile& t, const CorrShape& s) {
  const long long stages = 2LL * kFwdCKP * fwd_slots(t, s);
  const long long staged_out = (long long)kFwdRows * t.tx * t.ny * s.n;
  return stages > staged_out ? stages : staged_out;
}

// K5's micro-tiles a block: (partner row, 4 cells, partner chunk).
__host__ __device__ __forceinline__ long long fwd_jobs(const FwdTile& t,
                                                       const CorrShape& s) {
  return (long long)fwd_halo_rows(t, s) * (t.tx / kSimtR) * fwd_chunks(t, s);
}

// K5's pair view: cells of the largest class, padded to a float4, and one
// channel of a unit's stage (f1's cells, then the partners').
__host__ __device__ __forceinline__ int pair_cells(const CorrShape& s) {
  return div_up(s.H, s.stride) * div_up(s.W, s.stride);
}
__host__ __device__ __forceinline__ int pair_plane(const CorrShape& s) {
  return 2 * div_up(pair_cells(s), 4) * 4 + 4;
}

// One K6 or K7 stage in bytes: a halo row of features (tx + n - 1
// pixels, 16 * ncg channels of `size` bytes: K7 widens bf16 to fp32, K6
// keeps it) and the tile's fp32 pair matrix, (ty, tx + n - 1, tx). A
// multiple of 16.
__host__ __device__ __forceinline__ long long bwd_stage_bytes(
    const BwdTile& t, int n, int size) {
  const long long hw = (long long)t.tx + n - 1;
  return hw * 16 * t.ncg * size + 4LL * t.ty * hw * t.tx;
}

// Channels [c0, c0 + width) of `count` pixels into shared memory: pixel j
// from src + j*step (src at channel c0) to dst + slot(j)*pitch elements of
// D (fp32, or T itself); channels at or past c_end (C - c0) are zeros.
// kVec (D = T, C and width multiples of a 16-byte unit's elements, 16-byte
// aligned): one 16-byte cp.async a unit; else a 4-byte cp.async a float
// (fp32), or a load, widened to fp32 where D is, and a store (bf16). Every
// thread of the block takes part.
template <typename T, bool kVec, typename D, typename Slot>
__device__ __forceinline__ void stage_pixels(D* dst, int pitch, const T* src,
                                             long long step, int count,
                                             int width, int c_end,
                                             Slot slot) {
  static_assert(!kVec || std::is_same_v<T, D>, "16-byte copies do not widen");
  constexpr int kUnit = kVec ? 16 / (int)sizeof(D) : 1;  // elements a copy
  const int per = width / kUnit;
  for (int e = threadIdx.x; e < count * per; e += blockDim.x) {
    const int j = e / per;
    const int c = kUnit * (e - j * per);
    D* to = dst + slot(j) * pitch + c;
    if (c >= c_end) {
      if constexpr (kVec) {
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        *to = from_f32<D>(0.f);
      }
    } else if constexpr (kVec) {
      cp_async16(smem_u32(to), src + j * step + c);
    } else if constexpr (std::is_same_v<T, float>) {
      cp_async4(smem_u32(to), src + j * step + c);
    } else if constexpr (std::is_same_v<D, float>) {
      *to = to_f32(src[j * step + c]);
    } else {
      *to = src[j * step + c];
    }
  }
}

// `count` floats (count % 4 == 0, 16-byte aligned) of shared memory to 0.
__device__ __forceinline__ void zero_shared(float* p, int count) {
  for (int i = 4 * threadIdx.x; i < count; i += 4 * blockDim.x) {
    *reinterpret_cast<float4*>(p + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One element of a K5 pair-view stage: fp32 by a 4-byte cp.async, bf16
// widened.
template <typename T>
__device__ __forceinline__ void stage_elem(float* dst, const T* src) {
  if constexpr (std::is_same_v<T, float>) {
    cp_async4(smem_u32(dst), src);
  } else {
    *dst = to_f32(*src);
  }
}

// K5's channels [c0, c0 + kFwdCK) into one stage at buf, pixel-major,
// kFwdCKP floats a pixel (the 4-float pad puts neighbouring pixels' float4
// of a channel quad in different banks): the tile's f1 cells of row r at
// slots r*tx + (xl % 4) * (tx / 4) + xl / 4 (so the 4-cell groups of
// neighbouring threads are neighbouring slots), then partner row hr's
// cells at kFwdRows*tx + hr*row_slots + column. Only cells in the map;
// channels at or past C are zeros.
template <typename T, bool kVec>
__device__ __forceinline__ void fwd_stage(float* buf, const T* f1,
                                          const T* f2, const CorrShape& s,
                                          const FwdTile& t,
                                          const ClassAxis& ay,
                                          const ClassAxis& ax, int y0, int x0,
                                          int pr_lo, int nh, int pc_lo,
                                          int nw, long long b, int c0) {
  const int row_slots = fwd_row_slots(t, s);
  const int quarter = t.tx / kSimtR;
  const long long step = (long long)s.stride * s.C;
  const int xn = imin(t.tx, ax.cells - x0);
  for (int r = 0; r < kFwdRows && y0 + r < ay.cells; ++r) {
    const long long pix = (b * s.H + ay.r + s.stride * (y0 + r)) * s.W +
                          ax.r + s.stride * x0;
    stage_pixels<T, kVec>(buf, kFwdCKP, f1 + pix * s.C + c0, step, xn, kFwdCK,
                          s.C - c0, [&](int j) {
                            return r * t.tx + (j % kSimtR) * quarter +
                                   j / kSimtR;
                          });
  }
  for (int hr = 0; hr < nh; ++hr) {
    const long long pix = (b * s.H + ay.r2 + s.stride * (pr_lo + hr)) * s.W +
                          ax.r2 + s.stride * pc_lo;
    const int first = kFwdRows * t.tx + hr * row_slots;
    stage_pixels<T, kVec>(buf, kFwdCKP, f2 + pix * s.C + c0, step, nw, kFwdCK,
                          s.C - c0, [&](int j) { return first + j; });
  }
}

// K5, SIMT: f1, f2 (B, H, W, C) -> out (B, H, W, n*n). Grid (stride^2 x
// ytiles x xtiles x displacement groups, B), fwd_jobs threads or more;
// fwd_smem_floats floats of dynamic shared memory.
//
// A block takes kFwdRows x tx cells of one f1 class and displacement rows
// [iy0, iy0 + ny). Their partners lie in the partner rows [pr_lo, pr_hi]
// and columns [pc_lo, pc_hi] of the partner class, clipped to the map;
// those rows, and the tile, are staged kFwdCK channels at a time,
// pixel-major and double-buffered by 16-byte cp.async. A thread takes one
// partner row, 4 cells of each tile row and kFwdQ consecutive partners
// from the first that those cells' windows reach: for each 4 channels it
// loads a float4 of f1 for each of its kFwdRows x 4 cells and one for each
// partner, for 2 x 4 x 8 x 4 FFMAs (the partner row is shared by the tile
// rows, each at its own displacement row). Sums stay in registers over
// all channels. Pairs outside the map are not computed; their outputs are
// the zeros the block stages before it scatters its sums, then each
// pixel's run of ny*n outputs is written coalesced.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 2)
    corr_fwd_simt_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                         T* __restrict__ out, CorrShape s, FwdTile t) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int ytiles = div_up(div_up(s.H, s.stride), kFwdRows);
  const int xtiles = div_up(div_up(s.W, s.stride), t.tx);
  const int dgroups = div_up(s.n, t.ny);
  int bx = blockIdx.x;
  const int dg = bx % dgroups;
  bx /= dgroups;
  const int xt = bx % xtiles;
  bx /= xtiles;
  const int yt = bx % ytiles;
  const int cls = bx / ytiles;
  const ClassAxis ay = class_axis(cls / s.stride, s.H, s);
  const ClassAxis ax = class_axis(cls % s.stride, s.W, s);
  const int y0 = yt * kFwdRows, x0 = xt * t.tx;
  if (y0 >= ay.cells || x0 >= ax.cells) return;  // the whole block
  const long long b = blockIdx.y;
  const int iy0 = dg * t.ny;
  const int ny = imin(t.ny, s.n - iy0);
  const int pr_lo = max(y0 + ay.k + iy0, 0);
  const int pr_hi = imin(y0 + kFwdRows - 1 + ay.k + iy0 + ny - 1,
                         ay.cells2 - 1);
  const int pc_lo = max(x0 + ax.k, 0);
  const int pc_hi = imin(x0 + t.tx - 1 + ax.k + s.n - 1, ax.cells2 - 1);
  const int nh = pr_hi - pr_lo + 1, nw = pc_hi - pc_lo + 1;
  const int nch = fwd_chunks(t, s);
  const int nxg = t.tx / kSimtR;

  // This thread's micro-tile: partner row pr_lo + hr, cells xa..xa+3,
  // partners start..start+7 (those up to `last` exist).
  const int ch = threadIdx.x % nch;
  const int xg = (threadIdx.x / nch) % nxg;
  const int hr = threadIdx.x / (nch * nxg);
  const int xa = x0 + kSimtR * xg;
  const int start = max(xa + ax.k, pc_lo) + kFwdQ * ch;
  const int last = imin(xa + kSimtR - 1 + ax.k + s.n - 1, pc_hi);
  // Tile rows r whose displacement row pr - y - k is ours. Kept rolled:
  // unrolled, CUDA 12.8's ptxas at -O3 miscompiled this kernel (most
  // outputs left at zero; right at -O0 and with kFwdRows = 3).
  int rows = 0;
#pragma unroll 1
  for (int r = 0; r < kFwdRows; ++r) {
    const int iy = pr_lo + hr - (y0 + r) - ay.k;
    if (y0 + r < ay.cells && iy >= iy0 && iy < iy0 + ny) rows |= 1 << r;
  }
  const bool active = hr < nh && nw > 0 && xa < ax.cells && start <= last &&
                      rows != 0;
  // Slots of this thread's cells (row r, cell p at f1o + r*tx + p*nxg) and
  // first partner.
  const int f1o = xg;
  const int f2o = kFwdRows * t.tx + hr * fwd_row_slots(t, s) + start - pc_lo;

  float acc[kFwdRows][kSimtR][kFwdQ];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
    for (int p = 0; p < kSimtR; ++p)
#pragma unroll
      for (int q = 0; q < kFwdQ; ++q) acc[r][p][q] = 0.f;

  if (__syncthreads_or(active)) {
    const int chunks = div_up(s.C, kFwdCK);
    const long long stage = kFwdCKP * fwd_slots(t, s);
    fwd_stage<T, kVec>(smem, f1, f2, s, t, ay, ax, y0, x0, pr_lo, nh, pc_lo,
                       nw, b, 0);
    cp_async_commit();
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        fwd_stage<T, kVec>(smem + ((k + 1) & 1) * stage, f1, f2, s, t, ay,
                           ax, y0, x0, pr_lo, nh, pc_lo, nw, b,
                           (k + 1) * kFwdCK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const float* buf = smem + (k & 1) * stage;
        const int quads = div_up(imin(kFwdCK, s.C - k * kFwdCK), 4);
        for (int c4 = 0; c4 < quads; ++c4) {
          const float* pa = buf + f1o * kFwdCKP + 4 * c4;
          const float* pb = buf + f2o * kFwdCKP + 4 * c4;
          float4 a[kFwdRows][kSimtR];
#pragma unroll
          for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
            for (int p = 0; p < kSimtR; ++p)
              a[r][p] = *reinterpret_cast<const float4*>(
                  pa + (r * t.tx + p * nxg) * kFwdCKP);
#pragma unroll
          for (int q = 0; q < kFwdQ; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(pb + q * kFwdCKP);
            // Channel by channel, the 8 sums of a channel one after the
            // other: no FFMA waits on the one before it.
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
              for (int p = 0; p < kSimtR; ++p)
                acc[r][p][q] = fmaf(a[r][p].x, v.x, acc[r][p][q]);
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
              for (int p = 0; p < kSimtR; ++p)
                acc[r][p][q] = fmaf(a[r][p].y, v.y, acc[r][p][q]);
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
              for (int p = 0; p < kSimtR; ++p)
                acc[r][p][q] = fmaf(a[r][p].z, v.z, acc[r][p][q]);
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
              for (int p = 0; p < kSimtR; ++p)
                acc[r][p][q] = fmaf(a[r][p].w, v.w, acc[r][p][q]);
          }
        }
      }
      __syncthreads();
    }
  }

  // The block's outputs in shared memory, zeros first: cell r*tx + xl,
  // its run of ny*n outputs from displacement iy0*n on.
  const int run = ny * s.n;
  const int staged = kFwdRows * t.tx * run;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  if (active) {
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      if (!(rows >> r & 1)) continue;
      const int iy = pr_lo + hr - (y0 + r) - ay.k;
#pragma unroll
      for (int p = 0; p < kSimtR; ++p) {
        const int xl = kSimtR * xg + p;
        if (x0 + xl >= ax.cells) continue;
        float* o = smem + (r * t.tx + xl) * run + (iy - iy0) * s.n;
#pragma unroll
        for (int q = 0; q < kFwdQ; ++q) {
          const int ix = start + q - (x0 + xl) - ax.k;
          if (start + q <= last && ix >= 0 && ix < s.n) {
            o[ix] = acc[r][p][q] / (float)s.C;
          }
        }
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int pl = threadIdx.x / 32; pl < kFwdRows * t.tx;
       pl += blockDim.x / 32) {
    const int y = y0 + pl / t.tx, x = x0 + pl % t.tx;
    if (y >= ay.cells || x >= ax.cells) continue;
    const long long pix = (b * s.H + ay.r + s.stride * y) * s.W + ax.r +
                          s.stride * x;
    T* dst = out + pix * s.n * s.n + (long long)iy0 * s.n;
    const float* src = smem + pl * run;
    for (int k = lane; k < run; k += 32) dst[k] = from_f32<T>(src[k]);
  }
}

// K5, SIMT, on maps whose classes have at most kPairCells cells (the
// S3VAE labels' and the FlowNetC trainers' 8 x 8 features: 4 x 4 cells a
// class): the pair view, every (cell, partner) pair of a (sample, class)
// unit. Grid (ceil(B * stride^2 / units)), a unit's threads a cell by
// kPairQ partners; `units` x ck x pair_plane floats of dynamic shared
// memory, ck channels a stage. A thread loads one f1 value and a float4
// of partners a channel for 4 FFMAs; the units' outputs are zeroed, then
// each pair whose window lies in the map writes its mean.
template <typename T>
__global__ void __launch_bounds__(kSimtMaxThreads)
    corr_fwd_pairs_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                          T* __restrict__ out, CorrShape s, PairTile t) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int cells = pair_cells(s);
  const int np4 = div_up(cells, 4) * 4;
  const int plane = pair_plane(s);
  const int groups = np4 / kPairQ;
  const int per_unit = cells * groups;
  const int classes = s.stride * s.stride;
  const int units_total = s.B * classes;  // below 2^31 (the launcher)
  const int u0 = blockIdx.x * t.units;
  const int nd = s.n * s.n;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;

  // Zeros first: every output of the block's units.
  for (int ul = 0; ul < t.units && u0 + ul < units_total; ++ul) {
    const int cls = (u0 + ul) % classes;
    const ClassAxis ay = class_axis(cls / s.stride, s.H, s);
    const ClassAxis ax = class_axis(cls % s.stride, s.W, s);
    const long long row0 = (long long)((u0 + ul) / classes) * s.H;
    for (int p = warp; p < ay.cells * ax.cells; p += warps) {
      const long long pix = (row0 + ay.r + s.stride * (p / ax.cells)) * s.W +
                            ax.r + s.stride * (p % ax.cells);
      for (int k = lane; k < nd; k += 32) out[pix * nd + k] = from_f32<T>(0.f);
    }
  }

  const int ul = threadIdx.x / per_unit;
  const int p = threadIdx.x % per_unit / groups;
  const int qg = threadIdx.x % groups;
  const int u = u0 + ul;
  const bool mine = ul < t.units && u < units_total;
  const int cls = mine ? u % classes : 0;
  const ClassAxis ay = class_axis(cls / s.stride, s.H, s);
  const ClassAxis ax = class_axis(cls % s.stride, s.W, s);
  const bool active = mine && p < ay.cells * ax.cells &&
                      kPairQ * qg < ay.cells2 * ax.cells2;
  float acc[kPairQ] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < s.C; c0 += t.ck) {
    const int ck = imin(t.ck, s.C - c0);
    __syncthreads();  // the previous stage is read
    // Stage each unit: a warp a cell (f1's, then the partners'), a lane a
    // channel.
    for (int vl = 0; vl < t.units && u0 + vl < units_total; ++vl) {
      const int vcls = (u0 + vl) % classes;
      const ClassAxis vy = class_axis(vcls / s.stride, s.H, s);
      const ClassAxis vx = class_axis(vcls % s.stride, s.W, s);
      const long long row0 = (long long)((u0 + vl) / classes) * s.H;
      const int n1 = vy.cells * vx.cells;
      float* base = smem + vl * ck * plane;
      for (int cell = warp; cell < n1 + vy.cells2 * vx.cells2;
           cell += warps) {
        const bool second = cell >= n1;
        const int j = second ? cell - n1 : cell;
        const int cx = second ? vx.cells2 : vx.cells;
        const long long pix =
            (row0 + (second ? vy.r2 : vy.r) + s.stride * (j / cx)) * s.W +
            (second ? vx.r2 : vx.r) + s.stride * (j % cx);
        const T* src = (second ? f2 : f1) + pix * s.C + c0;
        float* dst = base + (second ? np4 : 0) + j;
        for (int cc = lane; cc < ck; cc += 32) {
          stage_elem(dst + cc * plane, src + cc);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      const float* pl = smem + ul * ck * plane;
      for (int cc = 0; cc < ck; ++cc, pl += plane) {
        const float a = pl[p];
        const float4 v =
            *reinterpret_cast<const float4*>(pl + np4 + kPairQ * qg);
        acc[0] = fmaf(a, v.x, acc[0]);
        acc[1] = fmaf(a, v.y, acc[1]);
        acc[2] = fmaf(a, v.z, acc[2]);
        acc[3] = fmaf(a, v.w, acc[3]);
      }
    }
  }
  __syncthreads();  // the zeros are written before the sums
  if (!active) return;
  const int y = ay.r + s.stride * (p / ax.cells);
  const int x = ax.r + s.stride * (p % ax.cells);
  const long long pix = ((long long)(u / classes) * s.H + y) * s.W + x;
#pragma unroll
  for (int j = 0; j < kPairQ; ++j) {
    const int q = kPairQ * qg + j;
    if (q >= ay.cells2 * ax.cells2) break;
    const int iy = (ay.r2 + s.stride * (q / ax.cells2) - y + s.d) / s.stride;
    const int ix = (ax.r2 + s.stride * (q % ax.cells2) - x + s.d) / s.stride;
    if (iy >= 0 && iy < s.n && ix >= 0 && ix < s.n) {
      out[pix * nd + iy * s.n + ix] = from_f32<T>(acc[j] / (float)s.C);
    }
  }
}

// One 16-byte unit of a staged feature pixel, widened to fp32: 4 fp32 or
// 8 bf16 channels.
__device__ __forceinline__ void load_unit(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p,
                                          float (&v)[8]) {
  // A bf16 value is the upper half of its fp32 value; element 0 is the
  // low half of the first word.
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// A K6 or K7 thread's kP outputs, pix_step pixels apart (the first
// `cells` of them in the map), channels c0 + kUnit*cg + kUnit*ncg*u + e
// (e < kUnit) from acc[p][kUnit*u + e], divided by C and rounded once:
// 16 bytes a store where kVec (C a multiple of kUnit, 16-byte aligned),
// else an element a store within C.
template <typename T, bool kVec, int kUnit, int kP>
__device__ __forceinline__ void store_micro_tile(
    T* out, const float (&acc)[kP][kBwdS], long long pix0,
    long long pix_step, int cells, const CorrShape& s, int c0, int cg,
    int ncg) {
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (p >= cells) continue;
    T* o = out + (pix0 + p * pix_step) * s.C;
#pragma unroll
    for (int u = 0; u < kBwdS / kUnit; ++u) {
      const int c = c0 + kUnit * cg + kUnit * ncg * u;
      if constexpr (kVec) {
        if (c < s.C) {
          alignas(16) T v[kUnit];
#pragma unroll
          for (int e = 0; e < kUnit; ++e) {
            v[e] = from_f32<T>(acc[p][kUnit * u + e] / (float)s.C);
          }
          *reinterpret_cast<uint4*>(o + c) =
              *reinterpret_cast<const uint4*>(v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          if (c + e < s.C) {
            o[c + e] = from_f32<T>(acc[p][kUnit * u + e] / (float)s.C);
          }
        }
      }
    }
  }
}

// K7's halo row hr (source row py0 + hr) into one stage at buf: f1's
// channels [c0, c0 + 16*ncg) of the halo columns in the map at pixel hx
// (pitch 16*ncg), then M[tyl][hx][qxl] = g[source (hr, hx), iy*n + ix]
// with iy = tyl + n-1 - hr, ix = qxl + n-1 - hx, for the tile rows tyl
// whose iy is a displacement row and every (hx, ix) whose qxl lies in the
// tile. Entries of M off that band are left as they are (zeros).
template <typename T, bool kVec>
__device__ __forceinline__ void bwd_stage(float* buf, const T* g, const T* f1,
                                          const CorrShape& s,
                                          const BwdTile& t,
                                          const ClassAxis& ay,
                                          const ClassAxis& ax, int qy0,
                                          int qx0, int py0, int px0,
                                          int hx_lo, int hx_hi, int hr,
                                          long long b, int c0) {
  const int hw = t.tx + s.n - 1;
  const int cs = 16 * t.ncg;
  const int nd = s.n * s.n;
  const long long row = (b * s.H + ay.r + s.stride * (py0 + hr)) * s.W;
  stage_pixels<T, kVec>(
      buf + hx_lo * cs, cs,
      f1 + (row + ax.r + s.stride * (px0 + hx_lo)) * s.C + c0,
      (long long)s.stride * s.C, hx_hi - hx_lo + 1, cs, s.C - c0,
      [](int j) { return j; });
  float* m = buf + hw * cs;
  const int nhx = hx_hi - hx_lo + 1;
  const int lane = threadIdx.x % 32;
  const int q_end = min(t.tx, ax.cells2 - qx0);  // tile columns in the map
  // A warp a (tile row, halo column), a lane a displacement column; the
  // pair (tyl, hx) steps by the warps, without a division a step.
  const int warps = blockDim.x / 32;
  int tyl = threadIdx.x / 32 / nhx;
  int hx = hx_lo + threadIdx.x / 32 % nhx;
  for (; tyl < t.ty; hx += warps) {
    while (hx > hx_hi) {
      hx -= nhx;
      ++tyl;
    }
    if (tyl >= t.ty) break;
    const int iy = tyl + s.n - 1 - hr;
    if (iy < 0 || iy >= s.n || qy0 + tyl >= ay.cells2) continue;
    const int ix_lo = max(0, s.n - 1 - hx);
    const int ix_hi = min(s.n - 1, s.n - 1 - hx + q_end - 1);
    const T* src =
        g + (row + ax.r + s.stride * (px0 + hx)) * nd + (long long)iy * s.n;
    float* dst = m + (tyl * hw + hx) * t.tx + hx - (s.n - 1);
    for (int ix = ix_lo + lane; ix <= ix_hi; ix += 32) {
      if constexpr (std::is_same_v<T, float>) {
        cp_async4(smem_u32(dst + ix), src + ix);
      } else {
        dst[ix] = to_f32(src[ix]);
      }
    }
  }
}

// K7, SIMT: g (B, H, W, n*n), f1 (B, H, W, C) -> gf2 (B, H, W, C). Grid
// (stride^2 x ytiles x xtiles x channel slices, B); 2 *
// bwd_stage_bytes(t, n, 4) bytes of dynamic shared memory.
//
// A block takes ty x tx cells of one f2 class and 16*ncg channels. Its
// sources are the (ty + n - 1) x (tx + n - 1) halo of the f1 class whose
// displacements reach the tile. The block walks the halo rows from the
// last to the first, double-buffered: each row's f1 channels and the
// cotangent entries that map into the tile (the pair matrix M) are staged
// by cp.async. A thread keeps a micro-tile of kSimtR outputs along x by
// kBwdS channels; for each source pixel of its window, from the last to
// the first, it loads a float4 of M and four float4s of f1 for 64 FFMAs.
// Every output so adds its displacements in increasing i, as the plain
// version does, and an entry of M off an output's band is an exact zero:
// a product of two bf16 values is exact in fp32, so the bf16 kernel is
// bit-equal to correlation_bwd_f2_plain. No atomics; one fixed order.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSimtMaxThreads, 2)
    corr_bwd_f2_simt_kernel(const T* __restrict__ g,
                            const T* __restrict__ f1, T* __restrict__ gf2,
                            CorrShape s, BwdTile t) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int cs = 16 * t.ncg;
  const int ytiles = div_up(div_up(s.H, s.stride), t.ty);
  const int xtiles = div_up(div_up(s.W, s.stride), t.tx);
  const int slices = div_up(s.C, cs);
  int bx = blockIdx.x;
  const int sl = bx % slices;
  bx /= slices;
  const int xt = bx % xtiles;
  bx /= xtiles;
  const int yt = bx % ytiles;
  const int cls = bx / ytiles;
  // The source classes (r) whose partners (r2) are this f2 class.
  const ClassAxis ay = class_axis((cls / s.stride + s.d) % s.stride, s.H, s);
  const ClassAxis ax = class_axis((cls % s.stride + s.d) % s.stride, s.W, s);
  const int qy0 = yt * t.ty, qx0 = xt * t.tx;
  if (qy0 >= ay.cells2 || qx0 >= ax.cells2) return;  // the whole block
  const long long b = blockIdx.y;
  const int c0 = sl * cs;
  const int hw = t.tx + s.n - 1;
  // Halo (hr, hx) is source cell (py0 + hr, px0 + hx); tile cell (tyl, qxl)
  // meets it at displacement (tyl + n-1 - hr, qxl + n-1 - hx).
  const int py0 = qy0 - ay.k - (s.n - 1);
  const int px0 = qx0 - ax.k - (s.n - 1);
  const int hr_lo = max(0, -py0);
  const int hr_hi = min(t.ty + s.n - 2, ay.cells - 1 - py0);
  const int hx_lo = max(0, -px0);
  const int hx_hi = min(hw - 1, ax.cells - 1 - px0);

  const int cg = threadIdx.x % t.ncg;
  const int qxg = (threadIdx.x / t.ncg) % (t.tx / kSimtR);
  const int tyl = threadIdx.x / (t.ncg * (t.tx / kSimtR));
  const int q0 = kSimtR * qxg;
  const bool mine = tyl < t.ty && qy0 + tyl < ay.cells2 &&
                    qx0 + q0 < ax.cells2;
  // The sources of this thread's outputs: halo columns [q0, q0 + n + 2].
  const int my_lo = max(q0, hx_lo);
  const int my_hi = min(q0 + s.n + kSimtR - 2, hx_hi);

  float acc[kSimtR][kBwdS];
#pragma unroll
  for (int p = 0; p < kSimtR; ++p)
#pragma unroll
    for (int c = 0; c < kBwdS; ++c) acc[p][c] = 0.f;

  if (hr_lo <= hr_hi && hx_lo <= hx_hi) {
    const int stage = (int)bwd_stage_bytes(t, s.n, 4) / 4;  // floats
    zero_shared(smem, 2 * stage);
    __syncthreads();
    bwd_stage<T, kVec>(smem, g, f1, s, t, ay, ax, qy0, qx0, py0, px0, hx_lo,
                       hx_hi, hr_hi, b, c0);
    cp_async_commit();
    for (int hr = hr_hi, k = 0; hr >= hr_lo; --hr, ++k) {
      if (hr > hr_lo) {
        bwd_stage<T, kVec>(smem + ((k + 1) & 1) * stage, g, f1, s, t, ay, ax,
                           qy0, qx0, py0, px0, hx_lo, hx_hi, hr - 1, b, c0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int iy = tyl + s.n - 1 - hr;
      if (mine && iy >= 0 && iy < s.n) {
        const float* buf = smem + (k & 1) * stage;
        const float* fs = buf + 4 * cg;
        const float* ms = buf + hw * cs + tyl * hw * t.tx + q0;
        for (int hx = my_hi; hx >= my_lo; --hx) {
          const float4 mv = *reinterpret_cast<const float4*>(ms + hx * t.tx);
          const float mp[kSimtR] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int u = 0; u < kBwdS / 4; ++u) {
            const float4 fv =
                *reinterpret_cast<const float4*>(fs + hx * cs + 4 * t.ncg * u);
#pragma unroll
            for (int p = 0; p < kSimtR; ++p) {
              acc[p][4 * u] = fmaf(mp[p], fv.x, acc[p][4 * u]);
              acc[p][4 * u + 1] = fmaf(mp[p], fv.y, acc[p][4 * u + 1]);
              acc[p][4 * u + 2] = fmaf(mp[p], fv.z, acc[p][4 * u + 2]);
              acc[p][4 * u + 3] = fmaf(mp[p], fv.w, acc[p][4 * u + 3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (!mine) return;
  const long long pix0 = (b * s.H + ay.r2 + s.stride * (qy0 + tyl)) * s.W +
                         ax.r2 + s.stride * (qx0 + q0);
  store_micro_tile<T, kVec, 4>(gf2, acc, pix0, s.stride,
                               ax.cells2 - qx0 - q0, s, c0, cg, t.ncg);
}

// K7, SIMT, on maps whose classes have at most kPairCells cells: the pair
// view. Grid (stride^2 x channel slices, B), a block a (sample, f2 class,
// 16 * ncg channels) unit, a thread an output cell by kBwdS channels;
// 4 * (cells * 16 * ncg + cells * cells) bytes of dynamic shared memory.
// The block stages the source class's f1 channels and the pair matrix
// M[q][p] = g[p, i] for each (output cell q, source cell p) pair at
// displacement i (zeros elsewhere); each thread walks the sources from the
// last to the first, a float of M and four float4s of f1 for 64 FFMAs.
// Every output so adds its displacements in increasing i, as
// correlation_bwd_f2_plain does: the bf16 kernel is bit-equal to it.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSimtMaxThreads)
    corr_bwd_f2_pairs_kernel(const T* __restrict__ g,
                             const T* __restrict__ f1, T* __restrict__ gf2,
                             CorrShape s, int ncg) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int cs = 16 * ncg;
  const int cells = pair_cells(s);
  const int slices = div_up(s.C, cs);
  const int sl = blockIdx.x % slices;
  const int cls = blockIdx.x / slices;
  const ClassAxis ay = class_axis((cls / s.stride + s.d) % s.stride, s.H, s);
  const ClassAxis ax = class_axis((cls % s.stride + s.d) % s.stride, s.W, s);
  const int np = ay.cells * ax.cells;     // sources
  const int nq = ay.cells2 * ax.cells2;   // outputs
  if (nq == 0) return;
  const long long b = blockIdx.y;
  const int c0 = sl * cs;
  const int nd = s.n * s.n;
  float* fs = smem;                 // [np][cs]
  float* m = smem + cells * cs;     // [nq][cells]
  for (int i = threadIdx.x; i < nq * cells; i += blockDim.x) m[i] = 0.f;
  __syncthreads();
  // The sources' channels, a class row at a time, and M at each pair in
  // the window.
  for (int py = 0; py < ay.cells; ++py) {
    const long long pix = (b * s.H + ay.r + s.stride * py) * s.W + ax.r;
    stage_pixels<T, kVec>(fs + py * ax.cells * cs, cs, f1 + pix * s.C + c0,
                          (long long)s.stride * s.C, ax.cells, cs, s.C - c0,
                          [](int j) { return j; });
  }
  for (int e = threadIdx.x; e < nq * np; e += blockDim.x) {
    const int q = e / np, p = e % np;
    const int y = ay.r + s.stride * (p / ax.cells);
    const int x = ax.r + s.stride * (p % ax.cells);
    const int iy = (ay.r2 + s.stride * (q / ax.cells2) - y + s.d) / s.stride;
    const int ix = (ax.r2 + s.stride * (q % ax.cells2) - x + s.d) / s.stride;
    if (iy < 0 || iy >= s.n || ix < 0 || ix >= s.n) continue;
    const T* src = g + ((b * s.H + y) * s.W + x) * nd + iy * s.n + ix;
    if constexpr (std::is_same_v<T, float>) {
      cp_async4(smem_u32(m + q * cells + p), src);
    } else {
      m[q * cells + p] = to_f32(*src);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cg = threadIdx.x % ncg;
  const int q = threadIdx.x / ncg;
  if (q >= nq) return;
  float acc[1][kBwdS];
#pragma unroll
  for (int c = 0; c < kBwdS; ++c) acc[0][c] = 0.f;
  const float* mq = m + q * cells;
  for (int p = np - 1; p >= 0; --p) {
    const float mv = mq[p];
    const float* fp = fs + p * cs + 4 * cg;
#pragma unroll
    for (int u = 0; u < kBwdS / 4; ++u) {
      const float4 fv = *reinterpret_cast<const float4*>(fp + 4 * ncg * u);
      acc[0][4 * u] = fmaf(mv, fv.x, acc[0][4 * u]);
      acc[0][4 * u + 1] = fmaf(mv, fv.y, acc[0][4 * u + 1]);
      acc[0][4 * u + 2] = fmaf(mv, fv.z, acc[0][4 * u + 2]);
      acc[0][4 * u + 3] = fmaf(mv, fv.w, acc[0][4 * u + 3]);
    }
  }
  const long long pix = (b * s.H + ay.r2 + s.stride * (q / ax.cells2)) * s.W +
                        ax.r2 + s.stride * (q % ax.cells2);
  store_micro_tile<T, kVec, 4>(gf2, acc, pix, 0, 1, s, c0, cg, ncg);
}

// K6's halo row hr (partner row py0 + hr of the partner class) into one
// stage: f2's channels [c0, c0 + 16*ncg) of the halo columns in the map at
// fs + hx * 16*ncg (in T), then the pair matrix M[tyl][hx][qxl] =
// g[tile cell (tyl, qxl), iy*n + ix] at m, iy = hr - tyl, ix = hx - qxl,
// for the tile rows whose iy is a displacement row and every (qxl, ix)
// whose hx lies in [hx_lo, hx_hi]: a cell's run of n cotangent entries for
// displacement row iy, contiguous in g. Entries of M off that band are
// left as they are (zeros).
template <typename T, bool kVec>
__device__ __forceinline__ void bwd_f1_stage(T* fs, float* m, const T* g,
                                             const T* f2, const CorrShape& s,
                                             const BwdTile& t,
                                             const ClassAxis& ay,
                                             const ClassAxis& ax, int qy0,
                                             int qx0, int py0, int px0,
                                             int hx_lo, int hx_hi, int hr,
                                             long long b, int c0) {
  const int hw = t.tx + s.n - 1;
  const int cs = 16 * t.ncg;
  const int nd = s.n * s.n;
  const long long row2 = (b * s.H + ay.r2 + s.stride * (py0 + hr)) * s.W;
  stage_pixels<T, kVec>(
      fs + hx_lo * cs, cs,
      f2 + (row2 + ax.r2 + s.stride * (px0 + hx_lo)) * s.C + c0,
      (long long)s.stride * s.C, hx_hi - hx_lo + 1, cs, s.C - c0,
      [](int j) { return j; });
  const int ncell = imin(t.ty, ay.cells - qy0) * imin(t.tx, ax.cells - qx0);
  const int q_end = imin(t.tx, ax.cells - qx0);  // tile columns in the map
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  // A warp a tile cell, a lane a displacement column; bf16 is loaded and
  // widened by the threads, kBatch cells' loads in flight before their
  // stores (fp32 goes by cp.async).
  constexpr int kBatch = std::is_same_v<T, float> ? 1 : 4;
  for (int cell0 = threadIdx.x / 32; cell0 < ncell;
       cell0 += kBatch * warps) {
    for (int ix0 = 0; ix0 < s.n; ix0 += 32) {
      float v[kBatch];
      int at[kBatch];  // M's entry, or -1
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        at[k] = -1;
        const int cell = cell0 + k * warps;
        const int tyl = cell / q_end;
        const int qxl = cell - tyl * q_end;
        const int iy = hr - tyl;
        const int ix = ix0 + lane;
        if (cell >= ncell || iy < 0 || iy >= s.n || ix >= s.n ||
            qxl + ix < hx_lo || qxl + ix > hx_hi) {
          continue;
        }
        const T* src = g + ((b * s.H + ay.r + s.stride * (qy0 + tyl)) * s.W +
                            ax.r + s.stride * (qx0 + qxl)) * nd +
                       (long long)iy * s.n + ix;
        at[k] = (tyl * hw + qxl + ix) * t.tx + qxl;  // hx = qxl + ix
        if constexpr (std::is_same_v<T, float>) {
          cp_async4(smem_u32(m + at[k]), src);
        } else {
          v[k] = to_f32(*src);
        }
      }
      if constexpr (!std::is_same_v<T, float>) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (at[k] >= 0) m[at[k]] = v[k];
        }
      }
    }
  }
}

// K6, SIMT: g (B, H, W, n*n), f2 (B, H, W, C) -> gf1 (B, H, W, C). Grid
// (stride^2 x ytiles x xtiles x channel slices, B); 2 *
// bwd_stage_bytes(t, n, sizeof(T)) bytes of dynamic shared memory.
//
// A block takes ty x tx cells of one f1 class and 16*ncg channels. Their
// partners are the (ty + n - 1) x (tx + n - 1) halo of the partner class
// from cell (py0, px0) on: tile cell (tyl, qxl) meets halo cell (hr, hx)
// at displacement (hr - tyl, hx - qxl). The block walks the halo rows
// from the first to the last, double-buffered: each row's f2 channels and
// the cotangent entries that meet it (the pair matrix M) are staged by
// cp.async (bf16 f2 as bf16, 16 bytes a copy where aligned; bf16 g widened
// by the threads). A thread keeps a micro-tile of kSimtR outputs along x
// by kBwdS channels; for each partner of its window, from the first to
// the last, it loads a float4 of M and 16 channels of f2 (four float4s, or
// two 16-byte units of bf16 widened in registers) for 64 FFMAs. Every
// output so adds its displacements in increasing i, as the plain version
// does, and an entry of M off an output's band is an exact zero: a
// product of two bf16 values is exact in fp32, so the bf16 kernel is
// bit-equal to correlation_bwd_f1_plain. Outputs with no partner in the
// map are written as zeros. No atomics; one fixed order.
//
// On the H100 (ptxas, CUDA 12.8, -O3): 126-128 registers a thread, no
// spills but for the bf16 kernel with 16-byte copies (8 bytes, in the
// staging of g: four cells' loads in flight ran faster on the card than
// two, which spill nothing). At the highres and FlyingChairs maps the
// plan's 4 x 16 cells by 256 channels take 92,160 bytes of shared memory
// (fp32) or 55,296 (bf16) and 256 threads: two blocks an SM.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSimtMaxThreads, 2)
    corr_bwd_f1_simt_kernel(const T* __restrict__ g,
                            const T* __restrict__ f2, T* __restrict__ gf1,
                            CorrShape s, BwdTile t) {
  constexpr int kUnit = 16 / (int)sizeof(T);  // channels a 16-byte unit
  extern __shared__ float4 smem_f4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f4);
  const int cs = 16 * t.ncg;
  const int ytiles = div_up(div_up(s.H, s.stride), t.ty);
  const int xtiles = div_up(div_up(s.W, s.stride), t.tx);
  const int slices = div_up(s.C, cs);
  int bx = blockIdx.x;
  const int sl = bx % slices;
  bx /= slices;
  const int xt = bx % xtiles;
  bx /= xtiles;
  const int yt = bx % ytiles;
  const int cls = bx / ytiles;
  const ClassAxis ay = class_axis(cls / s.stride, s.H, s);
  const ClassAxis ax = class_axis(cls % s.stride, s.W, s);
  const int qy0 = yt * t.ty, qx0 = xt * t.tx;
  if (qy0 >= ay.cells || qx0 >= ax.cells) return;  // the whole block
  const long long b = blockIdx.y;
  const int c0 = sl * cs;
  const int hw = t.tx + s.n - 1;
  const int rows = imin(t.ty, ay.cells - qy0);
  const int q_end = imin(t.tx, ax.cells - qx0);
  const int py0 = qy0 + ay.k, px0 = qx0 + ax.k;
  // The halo rows and columns in the map that some tile cell meets.
  const int hr_lo = max(0, -py0);
  const int hr_hi = min(rows + s.n - 2, ay.cells2 - 1 - py0);
  const int hx_lo = max(0, -px0);
  const int hx_hi = min(q_end + s.n - 2, ax.cells2 - 1 - px0);

  const int cg = threadIdx.x % t.ncg;
  const int qxg = (threadIdx.x / t.ncg) % (t.tx / kSimtR);
  const int tyl = threadIdx.x / (t.ncg * (t.tx / kSimtR));
  const int q0 = kSimtR * qxg;
  const bool mine = tyl < rows && q0 < q_end;
  // The partners of this thread's outputs: halo columns [q0, q0 + n + 2].
  const int my_lo = max(q0, hx_lo);
  const int my_hi = min(q0 + s.n + kSimtR - 2, hx_hi);

  float acc[kSimtR][kBwdS];
#pragma unroll
  for (int p = 0; p < kSimtR; ++p)
#pragma unroll
    for (int c = 0; c < kBwdS; ++c) acc[p][c] = 0.f;

  if (hr_lo <= hr_hi && hx_lo <= hx_hi) {
    const int stage = (int)bwd_stage_bytes(t, s.n, sizeof(T));
    const int m_off = hw * cs * (int)sizeof(T);
    zero_shared(reinterpret_cast<float*>(smem), 2 * stage / 4);
    __syncthreads();
    bwd_f1_stage<T, kVec>(reinterpret_cast<T*>(smem),
                          reinterpret_cast<float*>(smem + m_off), g, f2, s, t,
                          ay, ax, qy0, qx0, py0, px0, hx_lo, hx_hi, hr_lo, b,
                          c0);
    cp_async_commit();
    for (int hr = hr_lo, k = 0; hr <= hr_hi; ++hr, ++k) {
      if (hr < hr_hi) {
        unsigned char* next = smem + ((k + 1) & 1) * stage;
        bwd_f1_stage<T, kVec>(reinterpret_cast<T*>(next),
                              reinterpret_cast<float*>(next + m_off), g, f2,
                              s, t, ay, ax, qy0, qx0, py0, px0, hx_lo, hx_hi,
                              hr + 1, b, c0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int iy = hr - tyl;
      if (mine && iy >= 0 && iy < s.n) {
        const unsigned char* buf = smem + (k & 1) * stage;
        const T* fs = reinterpret_cast<const T*>(buf) + kUnit * cg;
        const float* ms = reinterpret_cast<const float*>(buf + m_off) +
                          tyl * hw * t.tx + q0;
        for (int hx = my_lo; hx <= my_hi; ++hx) {
          const float4 mv = *reinterpret_cast<const float4*>(ms + hx * t.tx);
          const float mp[kSimtR] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int u = 0; u < kBwdS / kUnit; ++u) {
            float v[kUnit];
            load_unit(fs + hx * cs + kUnit * t.ncg * u, v);
#pragma unroll
            for (int p = 0; p < kSimtR; ++p)
#pragma unroll
              for (int e = 0; e < kUnit; ++e)
                acc[p][kUnit * u + e] =
                    fmaf(mp[p], v[e], acc[p][kUnit * u + e]);
          }
        }
      }
      __syncthreads();
    }
  }

  if (!mine) return;
  const long long pix0 = (b * s.H + ay.r + s.stride * (qy0 + tyl)) * s.W +
                         ax.r + s.stride * (qx0 + q0);
  store_micro_tile<T, kVec, kUnit>(gf1, acc, pix0, s.stride, q_end - q0, s,
                                   c0, cg, t.ncg);
}

// K6, SIMT, on maps whose classes have at most kPairCells cells: the pair
// view. Grid (stride^2 x channel slices, B), a block a (sample, f1 class,
// 16 * ncg channels) unit, a thread an output cell by kBwdS channels;
// cells * (16 * ncg * sizeof(T) + 4 * cells) bytes of dynamic shared
// memory. The block stages the partner class's f2 channels (as the tiles
// do: bf16 stays bf16) and the pair matrix M[p][q] = g[p, i] for each
// (output cell p, partner cell q) pair at displacement i (zeros
// elsewhere); each thread walks the partners from the first to the last,
// a float of M and 16 channels of f2 for 16 FFMAs. Every output so adds
// its displacements in increasing i, as correlation_bwd_f1_plain does: the
// bf16 kernel is bit-equal to it. On the H100: 40-48 registers, no
// spills; at the trainers' 8 x 8 maps 128 threads and 9,216 bytes (fp32)
// or 5,120 (bf16) of shared memory a block.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSimtMaxThreads)
    corr_bwd_f1_pairs_kernel(const T* __restrict__ g,
                             const T* __restrict__ f2, T* __restrict__ gf1,
                             CorrShape s, int ncg) {
  constexpr int kUnit = 16 / (int)sizeof(T);  // channels a 16-byte unit
  extern __shared__ float4 smem_f4[];
  const int cs = 16 * ncg;
  const int cells = pair_cells(s);
  const int slices = div_up(s.C, cs);
  const int sl = blockIdx.x % slices;
  const int cls = blockIdx.x / slices;
  const ClassAxis ay = class_axis(cls / s.stride, s.H, s);
  const ClassAxis ax = class_axis(cls % s.stride, s.W, s);
  const int np = ay.cells * ax.cells;     // outputs
  const int nq = ay.cells2 * ax.cells2;   // partners
  if (np == 0) return;
  const long long b = blockIdx.y;
  const int c0 = sl * cs;
  const int nd = s.n * s.n;
  T* fs = reinterpret_cast<T*>(smem_f4);  // [nq][cs]
  float* m = reinterpret_cast<float*>(fs + cells * cs);  // [np][cells]
  for (int i = threadIdx.x; i < np * cells; i += blockDim.x) m[i] = 0.f;
  __syncthreads();
  // The partners' channels, a class row at a time, and M at each pair in
  // the window.
  for (int qy = 0; qy < ay.cells2; ++qy) {
    const long long pix = (b * s.H + ay.r2 + s.stride * qy) * s.W + ax.r2;
    stage_pixels<T, kVec>(fs + qy * ax.cells2 * cs, cs, f2 + pix * s.C + c0,
                          (long long)s.stride * s.C, ax.cells2, cs, s.C - c0,
                          [](int j) { return j; });
  }
  for (int e = threadIdx.x; e < np * nq; e += blockDim.x) {
    const int p = e / nq, q = e % nq;
    const int y = ay.r + s.stride * (p / ax.cells);
    const int x = ax.r + s.stride * (p % ax.cells);
    const int iy = (ay.r2 + s.stride * (q / ax.cells2) - y + s.d) / s.stride;
    const int ix = (ax.r2 + s.stride * (q % ax.cells2) - x + s.d) / s.stride;
    if (iy < 0 || iy >= s.n || ix < 0 || ix >= s.n) continue;
    const T* src = g + ((b * s.H + y) * s.W + x) * nd + iy * s.n + ix;
    if constexpr (std::is_same_v<T, float>) {
      cp_async4(smem_u32(m + p * cells + q), src);
    } else {
      m[p * cells + q] = to_f32(*src);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cg = threadIdx.x % ncg;
  const int p = threadIdx.x / ncg;
  if (p >= np) return;
  float acc[1][kBwdS];
#pragma unroll
  for (int c = 0; c < kBwdS; ++c) acc[0][c] = 0.f;
  const float* mp = m + p * cells;
  for (int q = 0; q < nq; ++q) {
    const float mv = mp[q];
    const T* fq = fs + q * cs + kUnit * cg;
#pragma unroll
    for (int u = 0; u < kBwdS / kUnit; ++u) {
      float v[kUnit];
      load_unit(fq + kUnit * ncg * u, v);
#pragma unroll
      for (int e = 0; e < kUnit; ++e) {
        acc[0][kUnit * u + e] = fmaf(mv, v[e], acc[0][kUnit * u + e]);
      }
    }
  }
  const long long pix = (b * s.H + ay.r + s.stride * (p / ax.cells)) * s.W +
                        ax.r + s.stride * (p % ax.cells);
  store_micro_tile<T, kVec, kUnit>(gf1, acc, pix, 0, 1, s, c0, cg, ncg);
}

CorrShape make_shape(int B, int H, int W, int C, int d, int stride) {
  return CorrShape{B, H, W, C, d, stride, 2 * d / stride + 1};
}

// What the SIMT K5-K7 index by: a shape the map and the stride make
// sense of, a tile of at least one row and a positive multiple of kSimtR
// columns, and 32..256 threads in whole warps (grid.y = B: at most 65535).
bool simt_tile_ok(const CorrShape& s, int ty, int tx, int threads) {
  return s.B >= 1 && s.B <= 65535 && s.H >= 1 && s.W >= 1 && s.C >= 1 &&
         s.d >= 0 && s.stride >= 1 && ty >= 1 && tx >= kSimtR &&
         tx % kSimtR == 0 && threads >= 32 && threads <= kSimtMaxThreads &&
         threads % 32 == 0;
}

// Blocks of a SIMT K5, K6 or K7 launch along x: stride^2 classes x tiles x
// `groups` (displacement groups or channel slices); 0 past CUDA's limit.
unsigned int simt_blocks(const CorrShape& s, int ty, int tx, int groups) {
  const long long n = (long long)s.stride * s.stride *
                      div_up(div_up(s.H, s.stride), ty) *
                      div_up(div_up(s.W, s.stride), tx) * groups;
  return n <= 0x7fffffffLL ? (unsigned int)n : 0u;
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

// K5, SIMT: f1, f2 (B, H, W, C) -> out (B, H, W, n*n) in tiles of
// kFwdRows x tx cells by ny displacement rows, `threads` a block
// (ops/correlation.py::simt_plan). Returns cudaErrorInvalidValue for a
// tile outside simt_tile_ok's bounds, else the launch's error.
extern "C" int odek_correlation_fwd(const void* f1, const void* f2, void* out,
                                    int B, int H, int W, int C, int d,
                                    int stride, int tx, int ny, int threads,
                                    int dtype, void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  const FwdTile t{tx, ny};
  if (!simt_tile_ok(s, 1, tx, threads) || ny < 1 ||
      fwd_jobs(t, s) > threads || threads > kFwdThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = fwd_smem_floats(t, s) * 4;
  const unsigned int blocks =
      simt_blocks(s, kFwdRows, tx, div_up(s.n, ny));
  if (smem > kSmemBytes || blocks == 0) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(f1) |
                                   reinterpret_cast<uintptr_t>(f2)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    auto launch = [&](auto kernel) -> int {
      const cudaError_t attr = allow_max_smem(
          reinterpret_cast<const void*>(kernel), kSmemBytes);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<dim3(blocks, B), threads, smem, st>>>(
          static_cast<const T*>(f1), static_cast<const T*>(f2),
          static_cast<T*>(out), s, t);
      return 0;
    };
    if constexpr (std::is_same_v<T, float>) {
      return vec ? launch(corr_fwd_simt_kernel<float, true>)
                 : launch(corr_fwd_simt_kernel<float, false>);
    } else {
      return launch(corr_fwd_simt_kernel<T, false>);
    }
  });
}

// K5, SIMT, pair view (classes of at most kPairCells cells): `units`
// (sample, class) units a block, ck channels a stage, `threads` a block
// (ops/correlation.py::simt_plan). Returns cudaErrorInvalidValue outside
// those bounds, else the launch's error.
extern "C" int odek_correlation_fwd_pairs(const void* f1, const void* f2,
                                          void* out, int B, int H, int W,
                                          int C, int d, int stride, int units,
                                          int ck, int threads, int dtype,
                                          void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  const PairTile t{units, ck};
  const int cells = pair_cells(s);
  if (!simt_tile_ok(s, 1, kSimtR, threads) || cells > kPairCells ||
      units < 1 || ck < 1 || ck > C ||
      (long long)units * cells * div_up(cells, kPairQ) > threads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = 4LL * units * ck * pair_plane(s);
  const long long total = (long long)B * stride * stride;
  if (smem > kSmemBytes || total > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (total + units - 1) / units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const auto kernel = corr_fwd_pairs_kernel<T>;
    const cudaError_t attr =
        allow_max_smem(reinterpret_cast<const void*>(kernel), kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    kernel<<<(unsigned int)blocks, threads, smem, st>>>(
        static_cast<const T*>(f1), static_cast<const T*>(f2),
        static_cast<T*>(out), s, t);
    return 0;
  });
}

// K6, SIMT: g (B, H, W, n*n), f2 (B, H, W, C) -> gf1 (B, H, W, C) in tiles
// of ty x tx cells by 16*ncg channels, `threads` a block
// (ops/correlation.py::simt_plan). Returns cudaErrorInvalidValue for a
// tile outside simt_tile_ok's bounds or shared memory, else the launch's
// error.
extern "C" int odek_correlation_bwd_f1(const void* g, const void* f2,
                                       void* gf1, int B, int H, int W, int C,
                                       int d, int stride, int ty, int tx,
                                       int ncg, int threads, int dtype,
                                       void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  const BwdTile t{ty, tx, ncg};
  if (!simt_tile_ok(s, ty, tx, threads) || ncg < 1 ||
      (long long)ty * (tx / kSimtR) * ncg > threads) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = simt_blocks(s, ty, tx, div_up(C, 16 * ncg));
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(f2) |
                         reinterpret_cast<uintptr_t>(gf1)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const long long smem = 2 * bwd_stage_bytes(t, s.n, sizeof(T));
    if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel) -> int {
      const cudaError_t attr = allow_max_smem(
          reinterpret_cast<const void*>(kernel), kSmemBytes);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<dim3(blocks, B), threads, smem, st>>>(
          static_cast<const T*>(g), static_cast<const T*>(f2),
          static_cast<T*>(gf1), s, t);
      return 0;
    };
    // 16-byte copies and stores where a pixel's channels come in whole
    // 16-byte units.
    return aligned && C % (16 / (int)sizeof(T)) == 0
               ? launch(corr_bwd_f1_simt_kernel<T, true>)
               : launch(corr_bwd_f1_simt_kernel<T, false>);
  });
}

// K6, SIMT, pair view (classes of at most kPairCells cells): 16 * ncg
// channels a block, `threads` a block (ops/correlation.py::simt_plan).
// Returns cudaErrorInvalidValue outside those bounds, else the launch's
// error.
extern "C" int odek_correlation_bwd_f1_pairs(const void* g, const void* f2,
                                             void* gf1, int B, int H, int W,
                                             int C, int d, int stride,
                                             int ncg, int threads, int dtype,
                                             void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  const int cells = pair_cells(s);
  if (!simt_tile_ok(s, 1, kSimtR, threads) || cells > kPairCells ||
      ncg < 1 || (long long)cells * ncg > threads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)stride * stride * div_up(C, 16 * ncg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(f2) |
                         reinterpret_cast<uintptr_t>(gf1)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const long long smem =
        (long long)cells * (16LL * ncg * (int)sizeof(T) + 4LL * cells);
    if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel) -> int {
      const cudaError_t attr = allow_max_smem(
          reinterpret_cast<const void*>(kernel), kSmemBytes);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<dim3((unsigned int)blocks, B), threads, smem, st>>>(
          static_cast<const T*>(g), static_cast<const T*>(f2),
          static_cast<T*>(gf1), s, ncg);
      return 0;
    };
    return aligned && C % (16 / (int)sizeof(T)) == 0
               ? launch(corr_bwd_f1_pairs_kernel<T, true>)
               : launch(corr_bwd_f1_pairs_kernel<T, false>);
  });
}

// K7, SIMT: g (B, H, W, n*n), f1 (B, H, W, C) -> gf2 (B, H, W, C) in tiles
// of ty x tx cells by 16*ncg channels, `threads` a block
// (ops/correlation.py::simt_plan). Returns cudaErrorInvalidValue for a
// tile outside simt_tile_ok's bounds, else the launch's error.
extern "C" int odek_correlation_bwd_f2(const void* g, const void* f1,
                                       void* gf2, int B, int H, int W, int C,
                                       int d, int stride, int ty, int tx,
                                       int ncg, int threads, int dtype,
                                       void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  const BwdTile t{ty, tx, ncg};
  if (!simt_tile_ok(s, ty, tx, threads) || ncg < 1 ||
      (long long)ty * (tx / kSimtR) * ncg > threads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = 2 * bwd_stage_bytes(t, s.n, 4);
  const unsigned int blocks = simt_blocks(s, ty, tx, div_up(C, 16 * ncg));
  if (smem > kSmemBytes || blocks == 0) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(f1) |
                                   reinterpret_cast<uintptr_t>(gf2)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    auto launch = [&](auto kernel) -> int {
      const cudaError_t attr = allow_max_smem(
          reinterpret_cast<const void*>(kernel), kSmemBytes);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<dim3(blocks, B), threads, smem, st>>>(
          static_cast<const T*>(g), static_cast<const T*>(f1),
          static_cast<T*>(gf2), s, t);
      return 0;
    };
    if constexpr (std::is_same_v<T, float>) {
      return vec ? launch(corr_bwd_f2_simt_kernel<float, true>)
                 : launch(corr_bwd_f2_simt_kernel<float, false>);
    } else {
      return launch(corr_bwd_f2_simt_kernel<T, false>);
    }
  });
}

// K7, SIMT, pair view (classes of at most kPairCells cells): 16 * ncg
// channels a block, `threads` a block (ops/correlation.py::simt_plan).
// Returns cudaErrorInvalidValue outside those bounds, else the launch's
// error.
extern "C" int odek_correlation_bwd_f2_pairs(const void* g, const void* f1,
                                             void* gf2, int B, int H, int W,
                                             int C, int d, int stride,
                                             int ncg, int threads, int dtype,
                                             void* stream) {
  const CorrShape s = make_shape(B, H, W, C, d, stride);
  const int cells = pair_cells(s);
  if (!simt_tile_ok(s, 1, kSimtR, threads) || cells > kPairCells ||
      ncg < 1 || (long long)cells * ncg > threads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = 4LL * cells * (16LL * ncg + cells);
  const long long blocks = (long long)stride * stride * div_up(C, 16 * ncg);
  if (smem > kSmemBytes || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(f1) |
                                   reinterpret_cast<uintptr_t>(gf2)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    auto launch = [&](auto kernel) -> int {
      const cudaError_t attr = allow_max_smem(
          reinterpret_cast<const void*>(kernel), kSmemBytes);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<dim3((unsigned int)blocks, B), threads, smem, st>>>(
          static_cast<const T*>(g), static_cast<const T*>(f1),
          static_cast<T*>(gf2), s, ncg);
      return 0;
    };
    if constexpr (std::is_same_v<T, float>) {
      return vec ? launch(corr_bwd_f2_pairs_kernel<float, true>)
                 : launch(corr_bwd_f2_pairs_kernel<float, false>);
    } else {
      return launch(corr_bwd_f2_pairs_kernel<T, false>);
    }
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

// K6, tensor cores: g, f2 -> gf1 as odek_correlation_bwd_f1, with no tile,
// for bf16 under K5's rule (g needs no alignment: it is read by element).
extern "C" int odek_correlation_bwd_f1_tc(const void* g, const void* f2,
                                          void* gf1, int B, int H, int W,
                                          int C, int d, int stride, int dtype,
                                          void* stream) {
  return launch_bwd_tc(corr_bwd_f1_tc_kernel, g, f2, gf1,
                       make_shape(B, H, W, C, d, stride), dtype,
                       static_cast<cudaStream_t>(stream));
}

// K7, tensor cores: g, f1 -> gf2 as odek_correlation_bwd_f2, with no tile,
// for bf16 under K5's rule.
extern "C" int odek_correlation_bwd_f2_tc(const void* g, const void* f1,
                                          void* gf2, int B, int H, int W,
                                          int C, int d, int stride, int dtype,
                                          void* stream) {
  return launch_bwd_tc(corr_bwd_f2_tc_kernel, g, f1, gf2,
                       make_shape(B, H, W, C, d, stride), dtype,
                       static_cast<cudaStream_t>(stream));
}
