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
// and its last C are r, so at G = 4 groups 0-1 feed z and groups 2-3 r*h;
// a group may straddle the split (2C = 96, G = 3). r*h and the blend are
// formed in fp32 and rounded once to the output dtype, as the Pallas
// kernels do.
//
// What bounds them on the H100: device-memory bandwidth. Each element is
// a handful of flops, so the cost is the bytes moved: K3 at the flagship
// shape (gates (128,16,16,128), h (128,16,16,64), bf16) reads 12.6 MB and
// writes 8.4 MB (6.3 us at 3.35 TB/s), K4 reads 12.6 MB and writes 4.2 MB
// (5.0 us).
//
// Each has two kernels; ops/gru_gates.py::sample_plan picks one.
//
// * gru_{gates,blend}_sample_kernel (the rule: channels and groups in
//   whole 16-byte vectors, 16-byte aligned inputs, a sample in at most 8
//   blocks' shared memory). One block owns one sample, so every group's
//   moments are taken on chip and each input is read from device memory
//   once: at the flagship, 128 blocks of 96 KB (bf16; 192 KB in fp32 at
//   B = 8), one wave on 132 SMs. One thread issues 1-D bulk copies
//   (cp.async.bulk, no tensor map to encode on the host) of the sample
//   into shared memory at the start: the normalised input in four chunks
//   of pixels, each completing on its own mbarrier so the moments of the
//   first chunk are taken while the rest arrives, and the other inputs (h;
//   z and h) on a fifth, waited for only by the epilogue. A thread owns
//   one 16-byte vector slot of a pixel (8 bf16 or 4 fp32 channels, all in
//   one group) over every P-th pixel, so its group and its channels'
//   scale and bias are fixed: fp32 s1 and s2 in registers, then each
//   group's sum over its threads by one warp in a fixed order (and across
//   the cluster's blocks in rank order), so two calls are bit-equal. The
//   epilogue takes a_c = scale_c * rstd_g and b_c = bias_c - mean_g * a_c
//   once, then costs one FMA, the activation and for r*h or the blend a
//   product in fp32 an element, and stores 16-byte vectors. Where a sample
//   does not fit one block's 227 KB, its pixels are split over a cluster
//   of up to 8 blocks, and the groups' partial sums are added through
//   distributed shared memory.
//
//   With one block an SM, the epilogue's instructions are what the bytes
//   leave: K3 applies its sigmoid to 32K elements a block, and with
//   accurate expf and an IEEE division it took 10.8-11.0 us a call. Its
//   sigmoid is __fdividef(1, 1 + __expf(-y)) (relative error a few fp32
//   ulps for |y| < 10): 7.6 us, the same 1.8e-7 fp32 max abs against the
//   plain version, and 9.5e-6 of bf16 outputs one ulp off the fp64
//   formula against 8.6e-6. K4 keeps the accurate tanhf (6.1 us). Alone
//   at the flagship shape, K3 7.6 us and K4 6.1 us against bounds of 6.26
//   and 5.01 (H100 80GB HBM3, 700 W; PERF.md).
// * gru_{gates,blend}_kernel (everything else): one block per (sample,
//   group); pass 1 takes the moments with a deterministic block reduction,
//   pass 2 reads the group again (from L2) to normalise and write, one
//   element a thread at a time.
//
// The moments-in variants (the frame height split over a 'space' mesh
// axis, ode_rl_torch/parallel/sp.py): a sample's (H, W, C/G) moments
// span the ranks of a line, so a group's statistics cannot be taken on
// one card. They replace the same Pallas kernels, in three steps:
//
// * gru_moments_kernel: one block per (sample, group) takes fp32 s1 =
//   sum x and s2 = sum x^2 over this rank's rows, in the fixed order of
//   the two-pass kernel's group_moments (a strided sum a thread, then
//   block_sum2), so two calls are bit-equal; it writes (B, G, 2) floats.
// * gru_moments_vec_kernel: the same sums where channels and groups are
//   whole 16-byte vectors and the input 16-byte aligned
//   (ops/gru_gates.py::moments_plan; every other call takes
//   gru_moments_kernel). The scalar pass read a group's 8 KB strip with
//   2-byte loads, a 32-bit division an element and a dependent chain of
//   adds a thread: 6.7 us on the 4.2 MB of gates at the flagship's 'space'
//   slice, a fifth of the memory rate. Here a block owns a sample (split
//   over a cluster of up to 8 blocks where it has more than 8 passes of
//   the block's pixels), and a thread one 16-byte vector slot of its
//   pixels, so its group is fixed and its s1 and s2 sit in registers: it
//   issues 8 read-only vector loads before its first add, then the groups'
//   sums are added in the one-sample kernel's fixed order
//   (sample_group_sums: slots, then groups by one warp, then the cluster's
//   blocks in rank order), and G float2 are stored a sample, no atomics.
//   The order differs from the scalar pass's, so do the bits.
// * the wrapper all-reduces those B*G*2 floats over 'space' (a
//   collective off the card: what the one-sample kernel adds across a
//   cluster's blocks through distributed shared memory now crosses
//   ranks).
// * gru_{gates,blend}_mom_kernel: the epilogue on the global moments, an
//   element a thread over the grid: mean = s1 / n and rstd =
//   rsqrt(max(s2 / n - mean^2, 0) + eps) with n the group's elements over
//   the whole height, a_c = scale_c * rstd and b_c = bias_c - mean * a_c,
//   one FMA, the activation (the one-sample kernel's: __fdividef(1, 1 +
//   __expf(-y)) for the sigmoid, tanhf), and r*h or the blend in fp32,
//   rounded once, as the one-sample kernel forms them.
// * gru_{gates,blend}_mom_vec_kernel: the epilogues where channels and
//   groups are whole 16-byte vectors and the inputs 16-byte aligned
//   (ops/gru_gates.py::mom_vec_plan; every other call takes the scalar
//   kernel). The scalar kernels spent their time on instructions, not
//   bytes: two 64-bit divisions, the group's statistics from the moments
//   (two loads, a division, a rsqrtf, scale and bias) and 2-byte loads and
//   a store at every element, 3.7-5x their bytes at the flagship's 'space'
//   slice (K3 15.57-16.60 us against 3.13, K4 9.3-9.7 against 2.50; H100
//   80GB HBM3, 700 W). Here a block owns a run of pixels of one sample: it
//   first takes a_c and b_c of the normalised input's channels once into
//   shared memory (affine_to_shared, through affine_from_moments, which
//   the scalar kernels share, so the bits are the same), while each
//   thread's first 16-byte vectors (K3: gates, 8 bf16 or 4 fp32 channels
//   all in z or all in r, and h; K4: cand, z and h) are in flight. A
//   thread keeps one vector slot of a pixel, so its channels' a_c and b_c
//   sit in registers; then an element costs one FMA, the activation and,
//   for r, the product with h, or for K4 the blend (blend_value, which the
//   scalar K4 shares), in fp32, rounded once, stored as 16-byte vectors.
//   Index arithmetic is 32-bit within a sample.
//
// Bound by bytes as K3 and K4 are: the moments pass reads the normalised
// input once more than the one-sample kernel (at the flagship's 'space'
// slice, gates (128, 8, 16, 128) bf16: 4.2 MB, cand 2.1 MB), the epilogue
// what K3 or K4 reads and writes.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using odek::allow_max_smem;
using odek::block_sum2;
using odek::from_f32;
using odek::mbar_expect_tx;
using odek::mbar_init;
using odek::mbar_wait;
using odek::smem_u32;
using odek::to_f32;
using odek::warp_sum;

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

// ---------------------------------------------------------------------------
// One-sample K3 and K4.
// ---------------------------------------------------------------------------

constexpr int kSampleMaxThreads = 512;
constexpr int kSampleChunks = 4;   // mbarriers of the normalised input
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kMaxRanks = 8;        // a portable cluster

// Shared memory of one block; mirrors ops/gru_gates.py::sample_plan. `px`
// pixels of the normalised input (2C channels for K3, C for K4) and of the
// other inputs (C for K3's h, 2C for K4's z and h): 3C channels a pixel
// either way. Then the threads' partial moments (float2 each), the
// groups' sums and statistics (float2 each), and the mbarriers.
__host__ __device__ constexpr int sample_smem_bytes(int px, int C, int elem,
                                                    int threads, int G) {
  return px * 3 * C * elem + threads * 8 + G * 16 + (kSampleChunks + 1) * 8;
}

// 16 bytes of T as fp32, and back (rounded to nearest even).
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const float4& q,
                                                float (&v)[N]) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    unpack(*reinterpret_cast<const float4*>(p), v);
  }
  // The 16 bytes as loaded through the read-only data path, unpacked where
  // they are used: four registers a vector in flight, not N.
  using Raw = float4;
  static __device__ __forceinline__ Raw ldg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& q,
                                                float (&v)[N]) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  using Raw = uint4;
  static __device__ __forceinline__ Raw ldg(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[N]) {
    uint4 q;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory, completing
// on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A barrier over the cluster where a sample spans `ranks` > 1 blocks,
// else over the block.
__device__ __forceinline__ void sample_sync(int ranks) {
  if (ranks > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Each group's moments over a sample, from every thread's partial (s1, s2):
// thread t keeps vector slot t % V of its pixels (kVec channels, all in
// one group of nj vectors), blockDim.x a multiple of 32 and of V. One warp
// a group adds its slots of every row in a fixed order into sums[g], then
// thread g < G adds the `ranks` blocks' sums[g] in rank order (through
// distributed shared memory in a cluster), so two calls are bit-equal.
// `part` holds blockDim.x float2, `sums` G. Returns group threadIdx.x's
// (s1, s2) on the threads below G. The caller ends with sample_sync(ranks)
// before a block exits or reuses sums, so the others' reads are done.
__device__ __forceinline__ float2 sample_group_sums(float s1, float s2,
                                                   float2* part, float2* sums,
                                                   int V, int nj, int G,
                                                   int ranks) {
  part[threadIdx.x] = make_float2(s1, s2);
  __syncthreads();
  const int P = blockDim.x / V;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int gg = warp; gg < G; gg += blockDim.x / 32) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = lane; i < nj * P; i += 32) {
      const float2 q = part[gg * nj + i % nj + V * (i / nj)];
      t1 += q.x;
      t2 += q.y;
    }
    t1 = warp_sum(t1);
    t2 = warp_sum(t2);
    if (lane == 0) sums[gg] = make_float2(t1, t2);
  }
  sample_sync(ranks);
  float t1 = 0.f, t2 = 0.f;
  if (threadIdx.x < G) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int r = 0; r < ranks; ++r) {
      const float2 q = ranks > 1
                           ? *cluster.map_shared_rank(&sums[threadIdx.x], r)
                           : sums[threadIdx.x];
      t1 += q.x;
      t2 += q.y;
    }
  }
  return make_float2(t1, t2);
}

struct SampleArgs {
  const void* x;   // normalised input: gates (B, HW, 2C) or cand (B, HW, C)
  const void* e1;  // K3's h or K4's z, (B, HW, C)
  const void* e2;  // K4's h
  const float* scale;
  const float* bias;
  void* out1;  // K3's z or K4's blend
  void* out2;  // K3's r*h
  int HW, C, G;
  int ranks;        // blocks a sample (a cluster where more than 1)
  int px_per_rank;  // block r owns pixels [r*px_per_rank, ...) of its sample
  float eps;
};

// Grid: B * ranks blocks, block b * ranks + r owning rank r's pixels of
// sample b; blockDim.x a multiple of 32 and of the vectors a pixel.
template <typename T, bool kBlend>
__device__ __forceinline__ void gru_tail_sample(const SampleArgs& a) {
  using V16 = Vec16<T>;
  constexpr int kVec = V16::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  const int Ct = kBlend ? C : 2 * C;  // channels of the normalised input
  const int V = Ct / kVec;            // its vectors a pixel
  const int P = blockDim.x / V;       // pixels in flight
  const int cs = Ct / a.G;
  const int rank = blockIdx.x % a.ranks;
  const int b = blockIdx.x / a.ranks;
  const int p0 = rank * a.px_per_rank;
  const int np = min(a.px_per_rank, a.HW - p0);
  const long long pix0 = (long long)b * a.HW + p0;

  T* xs = reinterpret_cast<T*>(smem);
  T* e1s = xs + (long long)a.px_per_rank * Ct;
  T* e2s = e1s + (long long)a.px_per_rank * C;
  float2* part =
      reinterpret_cast<float2*>(e1s + (long long)(kBlend ? 2 : 1) *
                                          a.px_per_rank * C);
  float2* sums = part + blockDim.x;
  float2* stats = sums + a.G;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + a.G);

  // Chunks of the normalised input: whole multiples of P pixels, so each
  // thread's pixels cross into a chunk at the same step.
  int chunk = (np + kSampleChunks - 1) / kSampleChunks;
  chunk = (chunk + P - 1) / P * P;
  const int n_chunks = (np + chunk - 1) / chunk;

  if (threadIdx.x == 0) {
    for (int i = 0; i <= kSampleChunks; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const T* x = static_cast<const T*>(a.x) + pix0 * Ct;
    for (int k = 0; k < n_chunks; ++k) {
      const uint32_t bar = smem_u32(&bars[k]);
      const uint32_t bytes = min(chunk, np - k * chunk) * Ct * sizeof(T);
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(xs + (long long)k * chunk * Ct),
                x + (long long)k * chunk * Ct, bytes, bar);
    }
    const uint32_t bar = smem_u32(&bars[kSampleChunks]);
    const uint32_t bytes = np * C * sizeof(T);
    mbar_expect_tx(bar, (kBlend ? 2 : 1) * bytes);
    bulk_load(smem_u32(e1s), static_cast<const T*>(a.e1) + pix0 * C, bytes,
              bar);
    if (kBlend) {
      bulk_load(smem_u32(e2s), static_cast<const T*>(a.e2) + pix0 * C, bytes,
                bar);
    }
  }

  // This thread's vector slot and its first pixel; its group, scale and
  // bias are fixed.
  const int slot = threadIdx.x % V;
  const int row = threadIdx.x / V;
  const int c0 = slot * kVec;
  const int g = c0 / cs;
  float sc[kVec], bi[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    sc[e] = __ldg(a.scale + c0 + e);
    bi[e] = __ldg(a.bias + c0 + e);
  }

  float s1 = 0.f, s2 = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    mbar_wait(smem_u32(&bars[k]), 0);
    const int end = min(np, (k + 1) * chunk);
    for (int p = k * chunk + row; p < end; p += P) {
      float v[kVec];
      V16::load(xs + (long long)p * Ct + c0, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s1 += v[e];
        s2 = fmaf(v[e], v[e], s2);
      }
    }
  }
  // The sample's sums of each group, then its mean and rstd.
  const float2 tot =
      sample_group_sums(s1, s2, part, sums, V, cs / kVec, a.G, a.ranks);
  if (threadIdx.x < a.G) {
    const float n = (float)a.HW * cs;
    const float mean = tot.x / n;
    const float var = fmaxf(tot.y / n - mean * mean, 0.f);
    stats[threadIdx.x] = make_float2(mean, rsqrtf(var + a.eps));
  }
  // Also keeps every block alive until the others have read its sums.
  sample_sync(a.ranks);

  const float2 st = stats[g];
  float ca[kVec], cb[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    ca[e] = sc[e] * st.y;
    cb[e] = fmaf(-st.x, ca[e], bi[e]);
  }
  mbar_wait(smem_u32(&bars[kSampleChunks]), 0);
  T* out1 = static_cast<T*>(a.out1) + pix0 * C;
  T* out2 = kBlend ? nullptr : static_cast<T*>(a.out2) + pix0 * C;
  for (int p = row; p < np; p += P) {
    float v[kVec];
    V16::load(xs + (long long)p * Ct + c0, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = fmaf(v[e], ca[e], cb[e]);
    const long long o = (long long)p * C;
    if constexpr (kBlend) {
      float zv[kVec], hv[kVec];
      V16::load(e1s + o + c0, zv);
      V16::load(e2s + o + c0, hv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[e] = (1.f - zv[e]) * hv[e] + zv[e] * tanhf(v[e]);
      }
      V16::store(out1 + o + c0, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[e] = __fdividef(1.f, 1.f + __expf(-v[e]));
      }
      if (c0 < C) {
        V16::store(out1 + o + c0, v);
      } else {
        float hv[kVec];
        V16::load(e1s + o + c0 - C, hv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] *= hv[e];
        V16::store(out2 + o + c0 - C, v);
      }
    }
  }
}

// Two entry points, so a profile tells K3 from K4 by name.
template <typename T>
__global__ void __launch_bounds__(kSampleMaxThreads)
    gru_gates_sample_kernel(SampleArgs a) {
  gru_tail_sample<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kSampleMaxThreads)
    gru_blend_sample_kernel(SampleArgs a) {
  gru_tail_sample<T, true>(a);
}

template <typename T, bool kBlend>
int launch_sample(const SampleArgs& a, int B, int threads,
                  cudaStream_t stream) {
  constexpr int kVec = Vec16<T>::N;
  const int Ct = kBlend ? a.C : 2 * a.C;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.e1) |
        reinterpret_cast<uintptr_t>(a.e2) |
        reinterpret_cast<uintptr_t>(a.out1) |
        reinterpret_cast<uintptr_t>(a.out2)) & 15) == 0;
  if (!aligned || B < 1 || a.C < 1 || a.C % kVec || a.G < 1 || Ct % a.G ||
      (Ct / a.G) % kVec || threads < 32 || threads % 32 ||
      threads > kSampleMaxThreads || threads % (Ct / kVec) || a.ranks < 1 ||
      a.ranks > kMaxRanks || a.px_per_rank < 1 ||
      (long long)a.ranks * a.px_per_rank < a.HW ||
      (long long)(a.ranks - 1) * a.px_per_rank >= a.HW ||
      (long long)B * a.ranks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem =
      sample_smem_bytes(a.px_per_rank, a.C, sizeof(T), threads, a.G);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  void (*kernel)(SampleArgs) =
      kBlend ? gru_blend_sample_kernel<T> : gru_gates_sample_kernel<T>;
  const cudaError_t attr =
      allow_max_smem(reinterpret_cast<const void*>(kernel), kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.ranks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = a.ranks > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

// ---------------------------------------------------------------------------
// Moments-in K3 and K4 (the 'space' axis).
// ---------------------------------------------------------------------------

// x (B, HW, Ct) -> mom (B, G, 2): s1, s2 of group g of sample b; grid (B, G).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_moments_kernel(const T* __restrict__ x, float* __restrict__ mom,
                       int HW, int Ct, int G) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int cs = Ct / G;
  const int n = HW * cs;
  const T* xs = x + (long long)b * HW * Ct;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / cs;
    const int c = g * cs + i - p * cs;
    const float v = to_f32(xs[(long long)p * Ct + c]);
    s1 += v;
    s2 += v * v;
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    mom[((long long)b * G + g) * 2] = s1;
    mom[((long long)b * G + g) * 2 + 1] = s2;
  }
}

// The vector moments pass: vectors a thread loads before its first add,
// and its largest block.
constexpr int kMomentsPer = 8;
constexpr int kMomentsMaxThreads = 1024;

// x (B, HW, Ct) -> mom (B, G, 2) as gru_moments_kernel, where channels and
// groups are whole 16-byte vectors; grid B * ranks blocks (a cluster where
// ranks > 1), block b * ranks + r owning pixels [r * px_per_rank, ...) of
// sample b. Thread t keeps vector slot t % V (V = Ct / kVec) of pixels
// t / V + k * P (P = blockDim.x / V), so its group is fixed and its s1 and
// s2 sit in registers; it loads kMomentsPer vectors, read-only, before it
// adds them in pixel order, then each element's x and x^2. The groups'
// sums follow sample_group_sums' fixed order, so two calls are bit-equal;
// that order is not gru_moments_kernel's, so the two kernels' bits differ.
// Offsets within a sample fit 32 bits (checked). Dynamic shared memory:
// blockDim.x + G float2.
template <typename T>
__global__ void __launch_bounds__(kMomentsMaxThreads)
    gru_moments_vec_kernel(const T* __restrict__ x, float* __restrict__ mom,
                           int HW, int Ct, int G, int ranks,
                           int px_per_rank) {
  using V16 = Vec16<T>;
  constexpr int kVec = V16::N;
  extern __shared__ float2 msum[];
  const int V = Ct / kVec;
  const int P = blockDim.x / V;
  const int rank = blockIdx.x % ranks;
  const int b = blockIdx.x / ranks;
  const int end = min(HW, (rank + 1) * px_per_rank);
  const T* xs = x + (long long)b * HW * Ct + (threadIdx.x % V) * kVec;
  float s1 = 0.f, s2 = 0.f;
  for (int p = rank * px_per_rank + threadIdx.x / V; p < end;
       p += kMomentsPer * P) {
    typename V16::Raw raw[kMomentsPer];
#pragma unroll
    for (int j = 0; j < kMomentsPer; ++j) {
      if (p + j * P < end) raw[j] = V16::ldg(xs + (p + j * P) * Ct);
    }
#pragma unroll
    for (int j = 0; j < kMomentsPer; ++j) {
      if (p + j * P < end) {
        float v[kVec];
        V16::unpack(raw[j], v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s1 += v[e];
          s2 = fmaf(v[e], v[e], s2);
        }
      }
    }
  }
  const float2 tot = sample_group_sums(s1, s2, msum, msum + blockDim.x, V,
                                       Ct / G / kVec, G, ranks);
  if (rank == 0 && threadIdx.x < G) {
    reinterpret_cast<float2*>(mom)[(long long)b * G + threadIdx.x] = tot;
  }
  // Keeps every block of a cluster alive until rank 0 has read its sums.
  if (ranks > 1) cg::this_cluster().sync();
}

// a = scale * rstd and b = bias - mean * a of a channel whose group's
// moments (s1, s2) sum `count` elements: the normalised value is fmaf(v,
// a, b). One function for both epilogues of K3, so their bits agree.
__device__ __forceinline__ void affine_from_moments(float s1, float s2,
                                                    float scale, float bias,
                                                    float count, float eps,
                                                    float& a, float& b) {
  const float mean = s1 / count;
  const float var = fmaxf(s2 / count - mean * mean, 0.f);
  a = scale * rsqrtf(var + eps);
  b = fmaf(-mean, a, bias);
}

// Element c of a pixel of sample b, normalised from the moments of its
// group over `count` elements.
__device__ __forceinline__ float norm_from_moments(
    float v, const float* __restrict__ mom, const float* __restrict__ scale,
    const float* __restrict__ bias, int b, int c, int cs, int G, float count,
    float eps) {
  const int g = c / cs;
  float a, sh;
  affine_from_moments(mom[((long long)b * G + g) * 2],
                      mom[((long long)b * G + g) * 2 + 1], scale[c], bias[c],
                      count, eps, a, sh);
  return fmaf(v, a, sh);
}

// a_c then b_c of one sample's ct channels into affine[0, 2 * ct), from
// its groups' moments ms (G, 2) over `count` elements a group of cs
// channels; the block's threads stride over the channels. The vector
// epilogues take them once a block.
__device__ __forceinline__ void affine_to_shared(
    const float* __restrict__ ms, const float* __restrict__ scale,
    const float* __restrict__ bias, int ct, int cs, float count, float eps,
    float* affine) {
  for (int c = threadIdx.x; c < ct; c += blockDim.x) {
    const int g = c / cs;
    affine_from_moments(ms[2 * g], ms[2 * g + 1], scale[c], bias[c], count,
                        eps, affine[c], affine[ct + c]);
  }
}

// K4's blend (1 - z) * h + z * c in fp32, one rounding order for both
// moments-in K4 kernels, so that their bits agree.
__device__ __forceinline__ float blend_value(float z, float h, float c) {
  return fmaf(z, c, (1.f - z) * h);
}

// gates (B, HW, 2C), h (B, HW, C), mom (B, G, 2) -> z, rh (B, HW, C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_gates_mom_kernel(const T* __restrict__ gates, const T* __restrict__ h,
                         const float* __restrict__ mom,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ z,
                         T* __restrict__ rh, long long total, int HW, int C,
                         int G, float count, float eps) {
  const int C2 = 2 * C;
  const int cs = C2 / G;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / C2;
    const int c = (int)(i - p * C2);
    const int b = (int)(p / HW);
    const float y = norm_from_moments(to_f32(gates[i]), mom, scale, bias, b,
                                      c, cs, G, count, eps);
    const float sig = __fdividef(1.f, 1.f + __expf(-y));
    if (c < C) {
      z[p * C + c] = from_f32<T>(sig);
    } else {
      const long long o = p * C + (c - C);
      rh[o] = from_f32<T>(sig * to_f32(h[o]));
    }
  }
}

// Vectors a thread of the vector K3 epilogue keeps in flight.
constexpr int kMomVecPerThread = 2;
constexpr int kMomVecMaxThreads = 1024;
// Its a_c and b_c (16 bytes a channel of h) within the shared memory a
// block has without opting in: C <= 3072.
constexpr int kMomVecMaxSmem = 48 * 1024;

// gates (B, HW, 2C), h (B, HW, C), mom (B, G, 2) -> z, rh (B, HW, C), as
// gru_gates_mom_kernel; grid (pixel runs, B), block (k, b) owning pixels
// [k * R * kMomVecPerThread, ...) of sample b with R = blockDim.x / V
// pixels a pass, V = 2C / kVec the vectors a pixel (blockDim.x a multiple
// of V). Dynamic shared memory: a_c then b_c, 2C floats each.
template <typename T>
__global__ void __launch_bounds__(kMomVecMaxThreads)
    gru_gates_mom_vec_kernel(const T* __restrict__ gates,
                             const T* __restrict__ h,
                             const float* __restrict__ mom,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ z, T* __restrict__ rh, int HW,
                             int C, int G, float count, float eps) {
  using V16 = Vec16<T>;
  constexpr int kVec = V16::N;
  constexpr int kPer = kMomVecPerThread;
  extern __shared__ float affine[];
  const int C2 = 2 * C;
  const int V = C2 / kVec;
  const int rows = blockDim.x / V;
  const int slot = threadIdx.x % V;
  const int c0 = slot * kVec;
  const bool is_r = c0 >= C;
  const int oc = is_r ? c0 - C : c0;  // channel of z or rh
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * rows * kPer + threadIdx.x / V;
  // This sample's tensors; offsets within a sample fit 32 bits (checked).
  const T* gs = gates + (long long)b * HW * C2;
  const T* hs = h + (long long)b * HW * C;
  T* out = (is_r ? rh : z) + (long long)b * HW * C;

  // This thread's vectors, in flight while the block takes a_c and b_c.
  float v[kPer][kVec], hv[kPer][kVec];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j * rows;
    if (p < HW) {
      V16::load(gs + p * C2 + c0, v[j]);
      if (is_r) V16::load(hs + p * C + oc, hv[j]);
    }
  }
  affine_to_shared(mom + (long long)b * G * 2, scale, bias, C2, C2 / G,
                   count, eps, affine);
  __syncthreads();
  float ca[kVec], cb[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    ca[e] = affine[c0 + e];
    cb[e] = affine[C2 + c0 + e];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j * rows;
    if (p >= HW) break;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float y = fmaf(v[j][e], ca[e], cb[e]);
      v[j][e] = __fdividef(1.f, 1.f + __expf(-y));
      if (is_r) v[j][e] *= hv[j][e];
    }
    V16::store(out + p * C + oc, v[j]);
  }
}

// cand, z, h (B, HW, C), mom (B, G, 2) -> out (B, HW, C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_blend_mom_kernel(const T* __restrict__ cand, const T* __restrict__ z,
                         const T* __restrict__ h,
                         const float* __restrict__ mom,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ out,
                         long long total, int HW, int C, int G, float count,
                         float eps) {
  const int cs = C / G;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / C;
    const int c = (int)(i - p * C);
    const int b = (int)(p / HW);
    const float y = norm_from_moments(to_f32(cand[i]), mom, scale, bias, b,
                                      c, cs, G, count, eps);
    const float zv = to_f32(z[i]);
    const float hv = to_f32(h[i]);
    out[i] = from_f32<T>(blend_value(zv, hv, tanhf(y)));
  }
}

// At most 512 threads a block of the vector K4 epilogue: its three inputs'
// vectors in flight and each channel's a_c and b_c take more than the 64
// registers a thread that 1024 would leave (bf16 spilled there).
constexpr int kBlendMomVecMaxThreads = 512;

// cand, z, h (B, HW, C), mom (B, G, 2) -> out (B, HW, C), as
// gru_blend_mom_kernel; the grid and block of gru_gates_mom_vec_kernel with
// V = C / kVec vectors a pixel. Dynamic shared memory: a_c then b_c, C
// floats each.
template <typename T>
__global__ void __launch_bounds__(kBlendMomVecMaxThreads)
    gru_blend_mom_vec_kernel(const T* __restrict__ cand,
                             const T* __restrict__ z,
                             const T* __restrict__ h,
                             const float* __restrict__ mom,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int HW, int C, int G,
                             float count, float eps) {
  using V16 = Vec16<T>;
  constexpr int kVec = V16::N;
  constexpr int kPer = kMomVecPerThread;
  extern __shared__ float affine[];
  const int V = C / kVec;
  const int rows = blockDim.x / V;
  const int c0 = (threadIdx.x % V) * kVec;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * rows * kPer + threadIdx.x / V;
  // This sample's tensors; offsets within a sample fit 32 bits (checked).
  const long long base = (long long)b * HW * C + c0;
  const T* xs = cand + base;
  const T* zs = z + base;
  const T* hs = h + base;
  T* os = out + base;

  // This thread's vectors, in flight while the block takes a_c and b_c.
  typename V16::Raw qc[kPer], qz[kPer], qh[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j * rows;
    if (p < HW) {
      qc[j] = V16::ldg(xs + p * C);
      qz[j] = V16::ldg(zs + p * C);
      qh[j] = V16::ldg(hs + p * C);
    }
  }
  affine_to_shared(mom + (long long)b * G * 2, scale, bias, C, C / G, count,
                   eps, affine);
  __syncthreads();
  float ca[kVec], cb[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    ca[e] = affine[c0 + e];
    cb[e] = affine[C + c0 + e];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j * rows;
    if (p >= HW) break;
    float v[kVec], zv[kVec], hv[kVec];
    V16::unpack(qc[j], v);
    V16::unpack(qz[j], zv);
    V16::unpack(qh[j], hv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[e] = blend_value(zv[e], hv[e], tanhf(fmaf(v[e], ca[e], cb[e])));
    }
    V16::store(os + p * C, v);
  }
}

// Blocks of an elementwise epilogue: enough to fill the card a few times
// over, each thread then striding over the rest.
inline int epilogue_blocks(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

// Moments of the normalised input of K3 (Ct = 2C) or K4 (Ct = C): mom
// (B, G, 2) fp32 (s1, s2) over this rank's HW pixels; grid (B, G).
extern "C" int odek_gru_moments(const void* x, void* mom, int B, int HW,
                                int Ct, int G, int dtype, void* stream) {
  if (B < 1 || HW < 1 || G < 1 || Ct % G || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    gru_moments_kernel<T><<<dim3(B, G), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(mom), HW, Ct, G);
  });
}

// The vector moments pass: as odek_gru_moments with `threads` a block (a
// multiple of 32 and of the 16-byte vectors a pixel, at most 1024), each
// sample split over `ranks` blocks (a cluster where more than 1, at most
// 8) of `px_per_rank` pixels each, the last one non-empty; for channels and
// groups in whole 16-byte vectors, x 16-byte aligned and a sample's HW * Ct
// elements within 32 bits (ops/gru_gates.py::moments_plan). Returns
// cudaErrorInvalidValue for arguments outside that, else the launch's
// error.
extern "C" int odek_gru_moments_vec(const void* x, void* mom, int B, int HW,
                                    int Ct, int G, int threads, int ranks,
                                    int px_per_rank, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    constexpr int kVec = Vec16<T>::N;
    const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                         (reinterpret_cast<uintptr_t>(mom) & 7) == 0;
    if (!aligned || B < 1 || HW < 1 || Ct < 1 || Ct % kVec || G < 1 ||
        Ct % G || (Ct / G) % kVec || threads < 32 || threads % 32 ||
        threads > kMomentsMaxThreads || threads % (Ct / kVec) ||
        ranks < 1 || ranks > kMaxRanks || px_per_rank < 1 ||
        (long long)ranks * px_per_rank < HW ||
        (long long)(ranks - 1) * px_per_rank >= HW ||
        (long long)HW * Ct > 0x7fffffffLL ||
        (long long)B * ranks > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * ranks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (threads + G) * sizeof(float2);
    cfg.stream = st;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = ranks;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = ranks > 1 ? 1 : 0;
    return (int)cudaLaunchKernelEx(&cfg, gru_moments_vec_kernel<T>,
                                   static_cast<const T*>(x),
                                   static_cast<float*>(mom), HW, Ct, G,
                                   ranks, px_per_rank);
  });
}

// Moments-in K3: as odek_gru_gates, the GroupNorm statistics from mom
// (B, G, 2), the moments summed over `count` elements a group.
extern "C" int odek_gru_gates_mom(const void* gates, const void* h,
                                  const void* mom, const void* scale,
                                  const void* bias, void* z, void* rh, int B,
                                  int HW, int C, int G, float count,
                                  float eps, int dtype, void* stream) {
  if (B < 1 || HW < 1 || C < 1 || G < 1 || (2 * C) % G || count < 1.f) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)B * HW * 2 * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    gru_gates_mom_kernel<T><<<epilogue_blocks(total), kThreads, 0, st>>>(
        static_cast<const T*>(gates), static_cast<const T*>(h),
        static_cast<const float*>(mom), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(z),
        static_cast<T*>(rh), total, HW, C, G, count, eps);
  });
}

// Moments-in K3, the vector epilogue: as odek_gru_gates_mom with
// `threads` a block (a multiple of the 16-byte vectors a pixel of gates,
// at most 1024), for channels and groups in whole 16-byte vectors, 16-byte
// aligned tensors, B <= 65535, C <= 3072 and a sample's 2C * HW elements
// within 32 bits (ops/gru_gates.py::mom_vec_plan). Returns
// cudaErrorInvalidValue for arguments outside that, else the launch's
// error.
extern "C" int odek_gru_gates_mom_vec(const void* gates, const void* h,
                                      const void* mom, const void* scale,
                                      const void* bias, void* z, void* rh,
                                      int B, int HW, int C, int G,
                                      float count, float eps, int threads,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    constexpr int kVec = Vec16<T>::N;
    const bool aligned = ((reinterpret_cast<uintptr_t>(gates) |
                           reinterpret_cast<uintptr_t>(h) |
                           reinterpret_cast<uintptr_t>(z) |
                           reinterpret_cast<uintptr_t>(rh)) & 15) == 0;
    const int V = 2 * C / kVec;
    if (!aligned || B < 1 || B > 65535 || HW < 1 || C < 1 || C % kVec ||
        G < 1 || (2 * C) % G || (2 * C / G) % kVec || count < 1.f ||
        threads < V || threads % V || threads > kMomVecMaxThreads ||
        2 * 2 * C * (int)sizeof(float) > kMomVecMaxSmem ||
        (long long)HW * 2 * C > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    const int px = threads / V * kMomVecPerThread;  // pixels a block
    const dim3 grid((HW + px - 1) / px, B);
    gru_gates_mom_vec_kernel<T><<<grid, threads, 2 * 2 * C * sizeof(float),
                                  st>>>(
        static_cast<const T*>(gates), static_cast<const T*>(h),
        static_cast<const float*>(mom), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(z),
        static_cast<T*>(rh), HW, C, G, count, eps);
    return 0;
  });
}

// Moments-in K4: as odek_gru_blend, the statistics from mom (B, G, 2).
extern "C" int odek_gru_blend_mom(const void* cand, const void* z,
                                  const void* h, const void* mom,
                                  const void* scale, const void* bias,
                                  void* out, int B, int HW, int C, int G,
                                  float count, float eps, int dtype,
                                  void* stream) {
  if (B < 1 || HW < 1 || C < 1 || G < 1 || C % G || count < 1.f) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)B * HW * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    gru_blend_mom_kernel<T><<<epilogue_blocks(total), kThreads, 0, st>>>(
        static_cast<const T*>(cand), static_cast<const T*>(z),
        static_cast<const T*>(h), static_cast<const float*>(mom),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(out), total, HW, C, G, count, eps);
  });
}

// Moments-in K4, the vector epilogue: as odek_gru_blend_mom with
// `threads` a block (a multiple of the 16-byte vectors a pixel, at most
// 512), for channels and groups in whole 16-byte vectors, 16-byte aligned
// tensors, B <= 65535, C <= 6144 and a sample's C * HW elements within 32
// bits (ops/gru_gates.py::mom_vec_plan with blend). Returns
// cudaErrorInvalidValue for arguments outside that, else the launch's
// error.
extern "C" int odek_gru_blend_mom_vec(const void* cand, const void* z,
                                      const void* h, const void* mom,
                                      const void* scale, const void* bias,
                                      void* out, int B, int HW, int C, int G,
                                      float count, float eps, int threads,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    constexpr int kVec = Vec16<T>::N;
    const bool aligned = ((reinterpret_cast<uintptr_t>(cand) |
                           reinterpret_cast<uintptr_t>(z) |
                           reinterpret_cast<uintptr_t>(h) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int V = C / kVec;
    if (!aligned || B < 1 || B > 65535 || HW < 1 || C < 1 || C % kVec ||
        G < 1 || C % G || (C / G) % kVec || count < 1.f || threads < V ||
        threads % V || threads > kBlendMomVecMaxThreads ||
        2 * C * (int)sizeof(float) > kMomVecMaxSmem ||
        (long long)HW * C > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    const int px = threads / V * kMomVecPerThread;  // pixels a block
    const dim3 grid((HW + px - 1) / px, B);
    gru_blend_mom_vec_kernel<T><<<grid, threads, 2 * C * sizeof(float),
                                  st>>>(
        static_cast<const T*>(cand), static_cast<const T*>(z),
        static_cast<const T*>(h), static_cast<const float*>(mom),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(out), HW, C, G, count, eps);
    return 0;
  });
}

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

// One-sample K3: as odek_gru_gates, with `threads` a block (a multiple of
// 32 and of the 16-byte vectors of a pixel of gates, at most 512), each
// sample split over `ranks` blocks (a cluster where more than 1, at most
// 8) of `px_per_rank` pixels each, the last one non-empty. Returns
// cudaErrorInvalidValue for arguments outside ops/gru_gates.py::
// sample_plan, else the launch's error.
extern "C" int odek_gru_gates_sample(const void* gates, const void* h,
                                     const void* scale, const void* bias,
                                     void* z, void* rh, int B, int HW, int C,
                                     int G, float eps, int threads, int ranks,
                                     int px_per_rank, int dtype,
                                     void* stream) {
  const SampleArgs a{gates, h, nullptr, static_cast<const float*>(scale),
                     static_cast<const float*>(bias), z, rh, HW, C, G, ranks,
                     px_per_rank, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    return launch_sample<decltype(tag), false>(a, B, threads, st);
  });
}

// One-sample K4: as odek_gru_blend, with the plan of odek_gru_gates_sample.
extern "C" int odek_gru_blend_sample(const void* cand, const void* z,
                                     const void* h, const void* scale,
                                     const void* bias, void* out, int B,
                                     int HW, int C, int G, float eps,
                                     int threads, int ranks, int px_per_rank,
                                     int dtype, void* stream) {
  const SampleArgs a{cand, z, h, static_cast<const float*>(scale),
                     static_cast<const float*>(bias), out, nullptr, HW, C, G,
                     ranks, px_per_rank, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return odek::launch_for_dtype(dtype, [&](auto tag) -> int {
    return launch_sample<decltype(tag), true>(a, B, threads, st);
  });
}
