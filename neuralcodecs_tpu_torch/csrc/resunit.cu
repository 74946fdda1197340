// The residual unit for Hopper (sm_90a), both forms, its products on the
// tensor cores in 3xTF32.
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/resunit.py:154
// (fused_residual_unit) in its depthwise form (depthwise=True, every SNAC
// preset: Wd [C, 1, 7]) and its dense form (depthwise=False,
// resunit.py:106-118, DAC: Wd [C, C, 7]). For x in torch's [B, C, T] layout
// it computes
//
//   out = x + b1 + W1 . snake(bd + dilconv_k7(snake(x, a1); Wd), a2)
//
// with a 7-tap conv of dilation d and zero padding 3d, then a C x C
// pointwise conv.
//
// What bounds it on the H100: the products. The TPU kernel ran them on the
// MXU as three bf16 passes (hi.hi + hi.lo + lo.hi); here they run on the
// tensor cores as three TF32 passes, a = a_big + a_small with a_big a
// rounded to TF32 (to nearest, ties away from zero): a_small.b_big +
// a_big.b_small + a_big.b_big, small terms first. The dropped small.small
// term is about 2^-22 of a product, so the sum stays f32-accurate.
// - Dense: 16 T C^2 flops a unit against 8 T C bytes of input and output;
//   bound by 3 x 16 T C^2 flops at 495 TFLOP/s.
// - Depthwise: the pointwise product is 2 T C^2 flops, 95% of the unit at
//   SNAC's widths; the 7 taps (14 T C flops) stay f32 FMAs on the CUDA
//   cores. Bound by bytes: x in and out once, 8 T C, beside y's 8 T C
//   more through device memory (below).
//
// Dense, three launches a unit:
//   K0 (snake_rows):          h = snake(x, a1), into out's buffer
//   K1 (resunit_gemm, CONV):  y = snake(bd + sum_k h[:, t + (k - 3) d] Wd_k, a2)
//   K2 (resunit_gemm):        out = x + b1 + W1 y
// Depthwise, two launches a unit:
//   K0d (depthwise_rows):     y = snake(bd + sum_k Wd_k h[:, t + (k - 3) d], a2),
//                             h = snake(x, a1), memory-bound
//   K2 (resunit_gemm):        out = x + b1 + W1 y, the same launch as above
// y goes through device memory as [B, C, T] (8 C T bytes a unit, ~1.3 ms a
// 10 s stream at 3.35 TB/s), which frees the SM of the y tile that capped
// the fused f32 designs at one block an SM (128 KB of y at C = 512 for a
// 64-step tile). y keeps torch's layout, so K2 reads it exactly as K1 reads
// h: both are one GEMM kernel with 7 taps or 1. snake(x) has its own
// memory-bound launch in the dense form: inside K1 each of the C / BN
// channel tiles would redo it over its halo'd window, and there its sines
// cost more than the products they feed.
//
// K0d: a block takes one row (b, c) and 1024 time steps; it stages snake(x)
// over the tile and its 3d halo in shared memory once (16-byte loads where
// T % 4 == 0, so each element costs one sinf), then each thread applies the
// 7 taps to 4 steps 256 apart from shared memory (conflict-free) and
// stores them, a warp filling 128 consecutive bytes. The grid is (B C rows,
// time tiles): C = 48 at T = 241 664 is 11 328 blocks.
//
// A GEMM block computes a tile of 128 time steps x BN output channels: two
// consumer warpgroups, each one wgmma.m64nBNk8 tile (time on M, output
// channels on N), and two producer warps.
// - A (activations) is the register operand. A tap's window is the input
//   shifted by k d time steps, never 8-row aligned, so it cannot be a
//   shared-memory descriptor; each thread reads its fragment from the
//   window [32 channels][128 + 6d steps] at offset k d and splits it into
//   big and small in registers. The window's row stride is 8 or 24 mod 32
//   words, so a warp's fragment reads hit 32 distinct banks.
// - B (weights) is the descriptor operand: a tap's [BN, 32] slab of Wd
//   re-laid [7, Cout, Cin] (or W1 [Cout, Cin]), K-major, 128-byte swizzled,
//   split into big and small once a call by the wrapper.
// - Producer warp 0 brings the weight slabs in by TMA into a ring of 4,
//   warp 1 the windows by TMA (its box starts on 16 bytes, so a window
//   starts up to 3 steps early) into a ring of 3, each stage guarded by
//   full / empty mbarriers. Where T % 4 != 0 the rows of h and y are not
//   16-byte aligned for TMA, and warp 1 copies the windows with cp.async.
// - Each k8 step is one commit group of 3 wgmmas; its fragments live in one
//   of two register sets, so the next step's loads and splits overlap the
//   tensor cores.
// - The tensor cores round a sum toward zero, so a running sum that keeps
//   its sign drifts with every wgmma added to it (past the 1e-4 tolerance
//   when one accumulator takes a whole unit). Each tap's 12 wgmmas go into a
//   partial sum from zero, whose sign varies from tap to tap, and the
//   accumulator adds it with a rounded f32 add.
// - The epilogue adds the bias and applies snake(., a2) (K1) or adds the
//   residual (K2) and stores [B, C, T]: each warp store fills whole 32-byte
//   sectors (8 consecutive time steps for 4 channels).
// Ragged C (masked channel tiles, zero-filled weights and windows), the
// ragged tail of T and the zero halo at both ends are handled in the
// kernel. The weight slab's 2D map over [taps * Cout, Cin] lets a ragged
// last channel tile read the next tap's rows; those accumulators are never
// stored. Tiles: BN = 64 for C <= 64, 96 for C = 96 and 192, else 128.
// Dilation up to 19 fits K1's TMA box; K0d and K2 take any. ptxas's
// register and spill report and the count of HGMMA instructions in each
// instantiation are printed by chip_smoke.py's build phase.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kSlab = 32;             // input channels a slab: one 128-byte row
constexpr int kStagesB = 4;           // weight ring
constexpr int kStagesW = 3;           // window ring
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 64;  // and two producer warps
constexpr int kBM = 128;              // time steps a block: an m64 tile a warpgroup
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxBox = 256;          // TMA box edge, elements

__device__ __forceinline__ float snake(float x, float a) {
  if (a == 0.f) return x;
  const float s = sinf(a * x);
  return x + (s * s) / a;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival on bar once every earlier cp.async of this thread has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// copy 4 bytes; with ok false, write a zero and read nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major [rows][32 f32] tile written by TMA with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), 1024-byte aligned
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint32_t a = smem_addr(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// a = big + small, exactly: big is a rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds) with its low 13 bits cleared, as
// ops/kernels/resunit.tf32_split rounds the weights; the tensor cores read
// small's top 19 bits
__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the window stride: room for len steps, 8 or 24 words mod 32
__host__ __device__ constexpr int window_stride(int len) {
  return ((len + 7) / 8 * 8) % 16 == 0 ? (len + 7) / 8 * 8 + 8 : (len + 7) / 8 * 8;
}

template <int BN>
constexpr size_t smem_bytes(int stride) {
  return 1024 + static_cast<size_t>(kStagesB) * 2 * BN * kSlab * 4 +
         static_cast<size_t>(kStagesW) * kSlab * stride * 4 + (2 * kStagesB + 2 * kStagesW) * 8;
}

// h = snake(x, a) over [B, C, T] (a [C]), four steps a thread
__global__ void __launch_bounds__(256)
snake_rows(const float* __restrict__ x, const float* __restrict__ alpha, float* __restrict__ h,
           int C, int T) {
  const int row = blockIdx.x;  // b * C + c
  const float a = alpha[row % C];
  const int t = (blockIdx.y * 256 + threadIdx.x) * 4;
  const size_t o = static_cast<size_t>(row) * T + t;
  if ((T & 3) == 0) {
    if (t < T) {
      float4 v = *reinterpret_cast<const float4*>(x + o);
      v = make_float4(snake(v.x, a), snake(v.y, a), snake(v.z, a), snake(v.w, a));
      *reinterpret_cast<float4*>(h + o) = v;
    }
  } else {
    for (int i = 0; i < 4 && t + i < T; ++i) h[o + i] = snake(x[o + i], a);
  }
}

constexpr int kDwTile = 1024;  // K0d: time steps a block, 4 a thread

// snake(x, a) with 1 / a given: K0d is bound by its instruction issue (two
// sinf an element), and a multiply by the channel's reciprocal costs less
// than a division (the two differ by at most an ulp of the sin^2 term)
__device__ __forceinline__ float snake_rcp(float x, float a, float inv_a) {
  if (a == 0.f) return x;
  const float s = sinf(a * x);
  return x + (s * s) * inv_a;
}

// K0d: y = snake(bd + sum_k wd[c, k] h[t + (k - 3) dil], a2), h = snake(x, a1)
// zero-padded, over [B, C, T]; a block takes row blockIdx.x = b C + c and
// steps [blockIdx.y kDwTile, + kDwTile). Dynamic shared memory: the window,
// kDwTile + 6 dil + 6 floats.
__global__ void __launch_bounds__(256)
depthwise_rows(const float* __restrict__ x, const float* __restrict__ a1,
               const float* __restrict__ wd, const float* __restrict__ bd,
               const float* __restrict__ a2, float* __restrict__ y, int C, int T, int dil) {
  extern __shared__ __align__(16) float win[];
  const int row = blockIdx.x;
  const int c = row % C;
  const int t0 = blockIdx.y * kDwTile;
  // the window starts on 4 steps (16 bytes) at or before t0 - 3 dil:
  // output t0 + j reads win[shift + j + k dil]
  const int ws = (t0 - 3 * dil) & ~3;
  const int shift = t0 - 3 * dil - ws;
  const int n4 = (kDwTile + 6 * dil + shift + 3) / 4;
  const float* xr = x + static_cast<size_t>(row) * T;
  const float alpha1 = a1[c], inv1 = 1.f / alpha1;
  for (int i = threadIdx.x; i < n4; i += 256) {
    const int t = ws + 4 * i;
    float4 v;
    if ((T & 3) == 0 && t >= 0 && t + 3 < T) {
      v = *reinterpret_cast<const float4*>(xr + t);
    } else {
      v.x = t >= 0 && t < T ? xr[t] : 0.f;
      v.y = t + 1 >= 0 && t + 1 < T ? xr[t + 1] : 0.f;
      v.z = t + 2 >= 0 && t + 2 < T ? xr[t + 2] : 0.f;
      v.w = t + 3 >= 0 && t + 3 < T ? xr[t + 3] : 0.f;
    }
    // snake(0) = 0: the zero padding stays zero
    *reinterpret_cast<float4*>(win + 4 * i) =
        make_float4(snake_rcp(v.x, alpha1, inv1), snake_rcp(v.y, alpha1, inv1),
                    snake_rcp(v.z, alpha1, inv1), snake_rcp(v.w, alpha1, inv1));
  }
  float w[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) w[k] = wd[c * 7 + k];
  const float bias = bd[c], alpha2 = a2[c], inv2 = 1.f / alpha2;
  __syncthreads();
  float* yr = y + static_cast<size_t>(row) * T;
#pragma unroll
  for (int e = 0; e < kDwTile / 256; ++e) {
    const int j = threadIdx.x + 256 * e;
    if (t0 + j < T) {
      const float* h = win + shift + j;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) acc = fmaf(w[k], h[k * dil], acc);
      yr[t0 + j] = snake_rcp(acc + bias, alpha2, inv2);
    }
  }
}

// CONV (K1): src = snake(x, a1), bias = bd, alpha = a2, dst = y.
// Else (K2): src = y, bias = b1, resid = x, dst = out; dil is unused.
// win_map is src's map when tma_windows, else unused.
template <int BN, bool CONV>
__global__ void __launch_bounds__(kThreads, 1)
resunit_gemm(const __grid_constant__ CUtensorMap w_big,
                   const __grid_constant__ CUtensorMap w_small,
                   const __grid_constant__ CUtensorMap win_map, int tma_windows,
                   const float* __restrict__ src, const float* __restrict__ bias,
                   const float* __restrict__ alpha, const float* __restrict__ resid,
                   float* __restrict__ dst, int C, int T, int dil, int stride) {
  using Mma = WgmmaTf32<BN>;
  constexpr int kTaps = CONV ? 7 : 1;
  constexpr uint32_t kTile = BN * kSlab * 4;  // bytes of one [BN][32] weight slab
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* b_tiles = base;  // [kStagesB][big, small][BN][32]
  float* win = reinterpret_cast<float*>(base + kStagesB * 2 * kTile);  // [kStagesW][32][stride]
  uint64_t* full_b = reinterpret_cast<uint64_t*>(win + kStagesW * kSlab * stride);
  uint64_t* empty_b = full_b + kStagesB;
  uint64_t* full_w = empty_b + kStagesB;
  uint64_t* empty_w = full_w + kStagesW;

  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int halo = CONV ? 3 * dil : 0;
  // a window starts at ts, t0 - halo rounded down to 4 steps (TMA's box must
  // start on 16 bytes): column shift + j feeds output step j's first tap
  const int ts = (t0 - halo) & ~3;
  const int shift = t0 - halo - ts;
  const int wlen = kBM + 2 * halo + shift;  // window steps the taps read
  const int slabs = (C + kSlab - 1) / kSlab;
  const size_t plane = static_cast<size_t>(C) * T;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesB; ++i) {
      mbar_init(full_b + i, 1);
      mbar_init(empty_b + i, kConsumers);
    }
    for (int i = 0; i < kStagesW; ++i) {
      mbar_init(full_w + i, tma_windows ? 1 : 32);
      mbar_init(empty_w + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warps: warp 0 loads the weight slabs, warp 1 the windows
    const int pw = (threadIdx.x - kConsumers) / 32;
    const int lane = threadIdx.x % 32;
    if (pw == 0) {
      if (lane == 0) {
        int bs = 0;
        uint32_t bphase = 0;
        for (int s = 0; s < slabs; ++s) {
          for (int k = 0; k < kTaps; ++k) {
            mbar_wait(empty_b + bs, bphase ^ 1);
            uint8_t* slab = b_tiles + bs * 2 * kTile;
            mbar_expect_tx(full_b + bs, 2 * kTile);
            tma_load_2d(slab, &w_big, s * kSlab, k * C + n0, full_b + bs);
            tma_load_2d(slab + kTile, &w_small, s * kSlab, k * C + n0, full_b + bs);
            if (++bs == kStagesB) {
              bs = 0;
              bphase ^= 1;
            }
          }
        }
      }
    } else if (pw == 1) {
      const float* srcb = src + blockIdx.z * plane;
      for (int s = 0; s < slabs; ++s) {
        const int ws = s % kStagesW;
        mbar_wait(empty_w + ws, ((s / kStagesW) & 1) ^ 1);
        float* w = win + ws * kSlab * stride;
        if (tma_windows) {  // [32 channels][stride steps] from ts, zeros outside
          if (lane == 0) {
            mbar_expect_tx(full_w + ws, kSlab * stride * 4);
            tma_load_3d(w, &win_map, ts, s * kSlab, blockIdx.z, full_w + ws);
          }
        } else {  // T % 4 != 0: rows are not 16-byte aligned for TMA
          for (int r = 0; r < kSlab; ++r) {
            const int c = s * kSlab + r;
            const float* row = srcb + static_cast<size_t>(c < C ? c : 0) * T;
            for (int j = lane; j < wlen; j += 32) {
              const int t = ts + j;
              const bool ok = c < C && t >= 0 && t < T;
              cp_async4(w + r * stride + j, ok ? row + t : srcb, ok);
            }
          }
          cp_async_arrive(full_w + ws);
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
  } else {
    // ---- consumer warpgroups
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int q = lane % 4;
    const int row0 = wg * 64 + warp * 16 + lane / 4;  // this thread's first M row
    // Each tap's 12 wgmmas sum into part, from zero (the tensor cores
    // round toward zero: see the header); acc adds part with a rounded f32
    // add.
    float acc[Mma::kRegs], part[Mma::kRegs];
#pragma unroll
    for (int i = 0; i < Mma::kRegs; ++i) acc[i] = 0.f;
    uint32_t big[2][4], small[2][4];
    int bs = 0;
    uint32_t bphase = 0;
    for (int s = 0; s < slabs; ++s) {
      const int ws = s % kStagesW;
      const float* w = win + ws * kSlab * stride;
      mbar_wait(full_w + ws, (s / kStagesW) & 1);
      for (int k = 0; k < kTaps; ++k) {
        mbar_wait(full_b + bs, bphase);
        const uint8_t* slab = b_tiles + bs * 2 * kTile;
        const uint64_t d_big = smem_desc(slab), d_small = smem_desc(slab + kTile);
        const float* a_base = w + q * stride + row0 + shift + k * dil;
#pragma unroll
        for (int st = 0; st < kSlab / 8; ++st) {
          const int f = st & 1;
          if (st >= 2) wgmma_wait<1>();  // step st - 2 has released set f
          const float* p = a_base + st * 8 * stride;
          split_tf32(p[0], big[f][0], small[f][0]);
          split_tf32(p[8], big[f][1], small[f][1]);
          split_tf32(p[4 * stride], big[f][2], small[f][2]);
          split_tf32(p[4 * stride + 8], big[f][3], small[f][3]);
          fence_regs(part);
          wgmma_fence();
          // small terms first; 32 bytes (8 f32 of K) a step along the row
          Mma::mma(part, small[f], d_big + 2 * st, st > 0);
          Mma::mma(part, big[f], d_small + 2 * st, 1);
          Mma::mma(part, big[f], d_big + 2 * st, 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(part);
        mbar_arrive(empty_b + bs);
        if (++bs == kStagesB) {
          bs = 0;
          bphase ^= 1;
        }
#pragma unroll
        for (int i = 0; i < Mma::kRegs; ++i) acc[i] += part[i];
      }
      mbar_arrive(empty_w + ws);
    }

    // ---- epilogue: acc[i] is row m = row0 + 8 ((i / 2) % 2), column
    // n = 8 (i / 4) + 2 q + i % 2 of the tile
    const size_t off = blockIdx.z * plane;
#pragma unroll
    for (int i = 0; i < Mma::kRegs; ++i) {
      const int t = t0 + row0 + 8 * ((i / 2) % 2);
      const int c = n0 + 8 * (i / 4) + 2 * q + i % 2;
      if (t < T && c < C) {
        const size_t o = off + static_cast<size_t>(c) * T + t;
        if (CONV)
          dst[o] = snake(acc[i] + bias[c], alpha[c]);
        else
          dst[o] = resid[o] + (acc[i] + bias[c]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// map over a [rows, cols] f32 matrix (cols % 4 == 0), boxes of [BN rows, 32
// cols] with the 128-byte swizzle, zeros past the edges
bool weight_map(CUtensorMap* map, const float* w, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {kSlab, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// map over src [B, C, T] (T % 4 == 0), boxes of [32 channels][box_t steps],
// zeros past the edges (the conv's halo, a ragged last slab)
bool window_map(CUtensorMap* map, const float* src, int B, int C, int T, int box_t) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(T) * sizeof(float),
                                 static_cast<cuuint64_t>(C) * T * sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_t), kSlab, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(src), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool CONV>
cudaError_t launch_gemm(const CUtensorMap& big, const CUtensorMap& small, const float* src,
                        const float* bias, const float* alpha, const float* resid, float* dst,
                        int B, int C, int T, int dil, cudaStream_t stream) {
  const int stride = window_stride(kBM + (CONV ? 6 * dil : 0) + 3);
  const size_t smem = smem_bytes<BN>(stride);
  if (stride > kMaxBox || smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const bool tma_windows = T % 4 == 0;
  CUtensorMap win_map = {};
  if (tma_windows && !window_map(&win_map, src, B, C, T, stride)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(resunit_gemm<BN, CONV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBM - 1) / kBM, (C + BN - 1) / BN, B);
  resunit_gemm<BN, CONV><<<grid, kThreads, smem, stream>>>(
      big, small, win_map, tma_windows, src, bias, alpha, resid, dst, C, T, dil, stride);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_dense(const float* x, const float* a1, const float* wd_big,
                         const float* wd_small, const float* bd, const float* a2,
                         const float* w1_big, const float* w1_small, const float* b1, float* y,
                         float* out, int B, int C, int T, int dil, cudaStream_t stream) {
  const int cp = (C + 3) / 4 * 4;
  CUtensorMap maps[4];
  if (!weight_map(&maps[0], wd_big, 7 * C, cp, BN) ||
      !weight_map(&maps[1], wd_small, 7 * C, cp, BN) ||
      !weight_map(&maps[2], w1_big, C, cp, BN) || !weight_map(&maps[3], w1_small, C, cp, BN))
    return cudaErrorInvalidValue;
  // out holds h = snake(x, a1) until the pointwise launch overwrites it
  const dim3 grid(B * C, (T + 1023) / 1024);
  snake_rows<<<grid, 256, 0, stream>>>(x, a1, out, C, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm<BN, true>(maps[0], maps[1], out, bd, a2, nullptr, y, B, C, T, dil, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<BN, false>(maps[2], maps[3], y, b1, nullptr, x, out, B, C, T, 0, stream);
}

template <int BN>
cudaError_t launch_depthwise(const float* x, const float* a1, const float* wd, const float* bd,
                             const float* a2, const float* w1_big, const float* w1_small,
                             const float* b1, float* y, float* out, int B, int C, int T, int dil,
                             cudaStream_t stream) {
  const int cp = (C + 3) / 4 * 4;
  CUtensorMap maps[2];
  if (!weight_map(&maps[0], w1_big, C, cp, BN) || !weight_map(&maps[1], w1_small, C, cp, BN))
    return cudaErrorInvalidValue;
  const dim3 grid(B * C, (T + kDwTile - 1) / kDwTile);
  const size_t smem = (kDwTile + 6 * static_cast<size_t>(dil) + 8) * sizeof(float);
  depthwise_rows<<<grid, 256, smem, stream>>>(x, a1, wd, bd, a2, y, C, T, dil);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<BN, false>(maps[0], maps[1], y, b1, nullptr, x, out, B, C, T, 0, stream);
}

// f(std::integral_constant<int, BN>) with the GEMM's channel tile for C
template <class F>
cudaError_t with_tile(int C, F f) {
  if (C <= 64) return f(std::integral_constant<int, 64>());
  if (C == 96 || C == 192) return f(std::integral_constant<int, 96>());
  return f(std::integral_constant<int, 128>());
}

cudaError_t check_unit(int device, int B, int C, int T, int dil) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dil <= 0 || B > 65535 || T > 65535 * 1024) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// x, y, out [B, C, T]; a1, a2, bd, b1 [C]; wd_big, wd_small [7, C, Cp], the
// dense Wd [C, C, 7] re-laid as [tap, Cout, Cin], Cin zero-padded to Cp =
// C rounded up to 4, split into its TF32 part and the rest; w1_big,
// w1_small [C, Cp] likewise for W1. All f32 contiguous; y is scratch; out
// does not alias x or y. Returns cudaGetLastError() of the last launch (or
// the first error).
extern "C" int nc_resunit_dense_f32(const float* x, const float* a1, const float* wd_big,
                                    const float* wd_small, const float* bd, const float* a2,
                                    const float* w1_big, const float* w1_small,
                                    const float* b1, float* y, float* out, int B, int C, int T,
                                    int dil, int device, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0) return cudaSuccess;
  cudaError_t err = check_unit(device, B, C, T, dil);
  if (err != cudaSuccess) return err;
  return with_tile(C, [&](auto bn) {
    return launch_dense<decltype(bn)::value>(x, a1, wd_big, wd_small, bd, a2, w1_big, w1_small,
                                             b1, y, out, B, C, T, dil,
                                             static_cast<cudaStream_t>(stream));
  });
}

// x, y, out [B, C, T]; a1, a2, bd, b1 [C]; wd [C, 1, 7], the depthwise taps
// (f32); w1_big, w1_small [C, Cp]: W1 [C, C, 1] as [Cout, Cin], Cin
// zero-padded to Cp = C rounded up to 4, split into its TF32 part and the
// rest. All f32 contiguous; y is scratch; out does not alias x or y.
// Returns cudaGetLastError() of the last launch (or the first error).
extern "C" int nc_resunit_depthwise_f32(const float* x, const float* a1, const float* wd,
                                        const float* bd, const float* a2, const float* w1_big,
                                        const float* w1_small, const float* b1, float* y,
                                        float* out, int B, int C, int T, int dil, int device,
                                        void* stream) {
  if (B <= 0 || C <= 0 || T <= 0) return cudaSuccess;
  cudaError_t err = check_unit(device, B, C, T, dil);
  if (err != cudaSuccess) return err;
  return with_tile(C, [&](auto bn) {
    return launch_depthwise<decltype(bn)::value>(x, a1, wd, bd, a2, w1_big, w1_small, b1, y,
                                                 out, B, C, T, dil,
                                                 static_cast<cudaStream_t>(stream));
  });
}
