// Fused residual units for Hopper (sm_90a): the depthwise and the dense form.
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/resunit.py:154
// (fused_residual_unit, _make_kernel), both of its forms. Each computes, for
// x in torch's [B, C, T] layout,
//
//   out = x + b1 + W1 . snake(bd + dilconv_k7(snake(x, a1); Wd), a2)
//
// with a 7-tap conv of dilation d and zero padding 3d, then a C x C
// pointwise conv. The depthwise form (groups = C, every SNAC preset) has
// Wd [C, 1, 7]; the dense form (groups = 1, DAC; resunit.py:106-118) has
// Wd [C, C, 7].
//
// What bounds them on the H100: the C x C products. The pointwise product
// is 2 C^2 flops per element against 8 bytes of input and output; the dense
// dilated conv adds 14 C^2. Both forms are bound by f32 operations at every
// width the models use (16 T C^2 flops a dense unit against 67 TFLOP/s); the
// unfused chain also moves five intermediate [B, C, T] tensors through
// device memory. The design keeps every intermediate on chip: one block per
// (stream, time tile) computes y = snake(bd + dilconv(snake(x)), a2) for its
// tile into shared memory, y [C, tile], then the pointwise product from
// there, and adds bias and residual as it writes the output, once. Products
// are f32 FMAs on a 4 x 4 register tile a thread (TM output channels x 64
// time steps a pass of TM / 4 x 16 threads); the weights are staged in slabs.
//
// Depthwise stage 1: the snaked window (tile + dilation halo) is staged
// channel chunk by channel chunk and convolved channel by channel. The time
// tile is chosen from C so that y fits (128 steps up to C = 128, else 64:
// 128 KB at C = 512).
//
// Dense stage 1: an implicit GEMM of depth 7 C, never materialising im2col.
// For each tile of TM output channels the block walks the input channels in
// slabs of KS: it stages the slab's snaked window [KS, 64 + 6d] and its
// weights [7, KS, TM] (from Wd re-laid to [7, Cin, Cout] by the wrapper, so
// the slab is read along Cout, coalesced) and accumulates the 7 taps by
// reading the window at offsets k d. A thread owns time steps tx, tx + 16,
// tx + 32, tx + 48, so a warp's window reads are 16 consecutive floats (no
// bank conflicts). snake(x) is recomputed for every output tile (C / TM
// times): keeping it for all C channels over the halo'd window would need
// C (64 + 6d) more floats of shared memory (362 KB at C = 768, d = 9), which
// does not fit beside y; the recompute is one sinf per 7 TM FMAs.
//
// The time tile is 64 steps in the dense form, so y alone is 256 C bytes and
// from C = 256 up it caps the SM at one or two blocks. Below C = 256 a block
// is 256 threads with TM = 64, KS = 8; from C = 256 it is 512 threads with
// TM = 128, KS = 4, which doubles the warps an SM holds at the same shared
// memory (the first design, 256 threads at every C, held 8 warps an SM at
// C >= 512 and ran those units far slower: PERF.md). Shared memory a block:
// 4 (64 C + max(7 KS TM + KS (64 + 6d), 32 (TM + 4))) bytes: 34 496 at
// C = 64, d = 9; 213 504 at C = 768 (one block an SM, 16 warps).
//
// Ragged channel counts (any C, masked against the TM-channel tiles), the
// ragged tail of T and the zero halo at both ends are masked in the kernels.
// ptxas's register and spill report for both kernels (for each dense
// instantiation on sm_90a: 64 registers, a 32-byte stack frame, no spills)
// is printed by chip_smoke.py's build phase.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kTaps = 7;
constexpr int kThreads = 256;
constexpr int kTileM = 64;              // output channels per pass (16 x 4)
constexpr int kTileN = 64;              // time steps per pass (16 x 4)
constexpr int kSlabK = 32;              // input channels per pointwise weight slab
constexpr int kSlabStride = kTileM + 4; // padded: fewer bank conflicts, 16 B rows
constexpr int kChan = 16;               // channels per depthwise stage-1 chunk
constexpr int kDenseSlab = 8;           // input channels per dense stage-1 slab
constexpr int kDenseTile = 64;          // time steps per block, dense form
constexpr int kWideC = 256;             // from here the dense form runs 512 threads
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float snake(float x, float a) {
  if (a == 0.f) return x;
  const float s = sinf(a * x);
  return x + (s * s) / a;
}

// out = x + (W1 . y + b1) for the block's tile, y [C][tt] in shared memory,
// TM output channels x 64 time steps a pass of TM / 4 x 16 threads; scratch
// holds one [kSlabK][TM + 4] slab of W1 at a time.
template <int TM>
__device__ __forceinline__ void pointwise_residual(const float* y_s, float* scratch,
                                                   const float* __restrict__ w1,
                                                   const float* __restrict__ b1,
                                                   const float* xb, float* ob, int C, int T,
                                                   int t0, int tt) {
  constexpr int threads = TM / 4 * 16;
  constexpr int stride = TM + 4;  // padded: fewer bank conflicts, 16 B rows
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // time: 4 consecutive steps
  const int ty = tid / 16;  // channels: 4 consecutive outputs
  for (int m0 = 0; m0 < C; m0 += TM) {
    for (int n0 = 0; n0 < tt; n0 += kTileN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < C; k0 += kSlabK) {
        const int kn = min(kSlabK, C - k0);
        __syncthreads();  // stage 1 or the previous slab is consumed
        for (int i = tid; i < kSlabK * TM; i += threads) {
          const int m = i / kSlabK, kk = i % kSlabK;  // reads along W1's rows
          const int co = m0 + m;
          scratch[kk * stride + m] =
              (co < C && kk < kn) ? w1[static_cast<size_t>(co) * C + k0 + kk] : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < kn; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(scratch + kk * stride + ty * 4);
          const float4 v = *reinterpret_cast<const float4*>(
              y_s + static_cast<size_t>(k0 + kk) * tt + n0 + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = m0 + ty * 4 + i;
        if (co >= C) continue;
        const float bias = b1[co];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + n0 + tx * 4 + j;
          if (t < T) {
            const size_t o = static_cast<size_t>(co) * T + t;
            ob[o] = xb[o] + (acc[i][j] + bias);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resunit_depthwise_kernel(const float* __restrict__ x, const float* __restrict__ a1,
                         const float* __restrict__ wd, const float* __restrict__ bd,
                         const float* __restrict__ a2, const float* __restrict__ w1,
                         const float* __restrict__ b1, float* __restrict__ out,
                         int C, int T, int dil, int tt) {
  extern __shared__ __align__(16) float smem[];
  const int halo = 3 * dil;
  const int hw = tt + 2 * halo;                       // stage-1 window width
  float* y_s = smem;                                  // [C][tt]
  float* scratch = y_s + static_cast<size_t>(C) * tt; // stage 1: [kChan][hw]
                                                      // stage 2: [kSlabK][kSlabStride]
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * tt;
  const size_t plane = static_cast<size_t>(C) * T;
  const float* xb = x + blockIdx.y * plane;
  float* ob = out + blockIdx.y * plane;

  // ---- stage 1: y = snake(bd + dilconv(snake(x, a1)), a2) for the tile
  for (int c0 = 0; c0 < C; c0 += kChan) {
    const int cn = min(kChan, C - c0);
    __syncthreads();  // the previous chunk's window is consumed
    for (int i = tid; i < cn * hw; i += kThreads) {
      const int c = c0 + i / hw;
      const int t = t0 - halo + i % hw;
      scratch[i] = (t >= 0 && t < T)
                       ? snake(xb[static_cast<size_t>(c) * T + t], a1[c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < cn * tt; i += kThreads) {
      const int cc = i / tt, j = i % tt;
      const int c = c0 + cc;
      const float* h = scratch + cc * hw + j;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = fmaf(wd[c * kTaps + k], h[k * dil], acc);
      y_s[static_cast<size_t>(c) * tt + j] = (t0 + j < T) ? snake(acc + bd[c], a2[c]) : 0.f;
    }
  }

  // ---- stage 2: out = x + (W1 . y + b1), C x C product from shared memory
  pointwise_residual<kTileM>(y_s, scratch, w1, b1, xb, ob, C, T, t0, tt);
}

// TM output channels a pass (TM / 4 x 16 threads), KS input channels a slab
template <int TM, int KS>
__global__ void __launch_bounds__(TM / 4 * 16)
resunit_dense_kernel(const float* __restrict__ x, const float* __restrict__ a1,
                     const float* __restrict__ wdt, const float* __restrict__ bd,
                     const float* __restrict__ a2, const float* __restrict__ w1,
                     const float* __restrict__ b1, float* __restrict__ out,
                     int C, int T, int dil) {
  extern __shared__ __align__(16) float smem[];
  constexpr int tt = kDenseTile;
  constexpr int threads = TM / 4 * 16;
  const int halo = 3 * dil;
  const int hw = tt + 2 * halo;                       // stage-1 window width
  float* y_s = smem;                                  // [C][tt]
  float* scratch = y_s + static_cast<size_t>(C) * tt;
  float* w_s = scratch;                               // stage 1: [7][KS][TM]
  float* h_s = w_s + kTaps * KS * TM;                 //          [KS][hw]
                                                      // stage 2: [kSlabK][TM + 4]
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // time: steps tx, tx + 16, tx + 32, tx + 48
  const int ty = tid / 16;  // channels: 4 consecutive outputs
  const int t0 = blockIdx.x * tt;
  const size_t plane = static_cast<size_t>(C) * T;
  const float* xb = x + blockIdx.y * plane;
  float* ob = out + blockIdx.y * plane;

  // ---- stage 1: y = snake(bd + dilconv(snake(x, a1); Wd), a2) for the tile
  for (int m0 = 0; m0 < C; m0 += TM) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += KS) {
      const int kn = min(KS, C - k0);
      __syncthreads();  // the previous slab (or y's last reader) is done
      for (int i = tid; i < kn * hw; i += threads) {
        const int kk = i / hw, j = i % hw;
        const int t = t0 - halo + j;
        h_s[kk * hw + j] = (t >= 0 && t < T)
            ? snake(xb[static_cast<size_t>(k0 + kk) * T + t], a1[k0 + kk]) : 0.f;
      }
      for (int i = tid; i < kTaps * KS * TM; i += threads) {
        const int m = i % TM, r = i / TM;             // r = k * KS + kk
        const int kk = r % KS, k = r / KS;
        const int co = m0 + m;
        w_s[i] = (co < C && kk < kn)
            ? wdt[(static_cast<size_t>(k) * C + k0 + kk) * C + co] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(w_s + (k * KS + kk) * TM + ty * 4);
          const float* h = h_s + kk * hw + k * dil + tx;
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float vv[4] = {h[0], h[16], h[32], h[48]};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = m0 + ty * 4 + i;
      if (c >= C) continue;
      const float bias = bd[c], alpha = a2[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx + 16 * j;
        y_s[static_cast<size_t>(c) * tt + t] =
            (t0 + t < T) ? snake(acc[i][j] + bias, alpha) : 0.f;
      }
    }
  }

  // ---- stage 2: out = x + (W1 . y + b1), C x C product from shared memory
  pointwise_residual<TM>(y_s, scratch, w1, b1, xb, ob, C, T, t0, tt);
}

template <int TM, int KS>
cudaError_t launch_dense(const float* x, const float* a1, const float* wdt, const float* bd,
                         const float* a2, const float* w1, const float* b1, float* out, int B,
                         int C, int T, int dil, cudaStream_t stream) {
  const int hw = kDenseTile + 6 * dil;
  const size_t scratch = std::max(static_cast<size_t>(kTaps * KS * TM + KS * hw),
                                  static_cast<size_t>(kSlabK) * (TM + 4));
  const size_t smem = (static_cast<size_t>(C) * kDenseTile + scratch) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(resunit_dense_kernel<TM, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kDenseTile - 1) / kDenseTile, B);
  resunit_dense_kernel<TM, KS><<<grid, TM / 4 * 16, smem, stream>>>(
      x, a1, wdt, bd, a2, w1, b1, out, C, T, dil);
  return cudaGetLastError();
}

}  // namespace

// x, out [B, C, T]; a1, a2, bd, b1 [C]; wd [C, 1, 7]; w1 [C, C, 1]; all f32
// contiguous, out not aliasing x. Returns cudaGetLastError().
extern "C" int nc_resunit_depthwise_f32(const float* x, const float* a1, const float* wd,
                                        const float* bd, const float* a2, const float* w1,
                                        const float* b1, float* out, int B, int C, int T,
                                        int dil, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || C <= 0 || T <= 0) return cudaSuccess;
  if (dil <= 0 || B > 65535) return cudaErrorInvalidValue;
  const int tt = C <= 128 ? 128 : 64;
  const int hw = tt + 6 * dil;
  const size_t scratch = std::max(static_cast<size_t>(kChan) * hw,
                                  static_cast<size_t>(kSlabK) * kSlabStride);
  const size_t smem = (static_cast<size_t>(C) * tt + scratch) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(resunit_depthwise_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tt - 1) / tt, B);
  resunit_depthwise_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a1, wd, bd, a2, w1, b1, out, C, T, dil, tt);
  return cudaGetLastError();
}

// x, out [B, C, T]; a1, a2, bd, b1 [C]; wdt [7, C, C], the dense Wd [C, C, 7]
// re-laid as [tap, Cin, Cout]; w1 [C, C, 1]; all f32 contiguous, out not
// aliasing x. Returns cudaGetLastError().
extern "C" int nc_resunit_dense_f32(const float* x, const float* a1, const float* wdt,
                                    const float* bd, const float* a2, const float* w1,
                                    const float* b1, float* out, int B, int C, int T,
                                    int dil, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || C <= 0 || T <= 0) return cudaSuccess;
  if (dil <= 0 || B > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return C >= kWideC
             ? launch_dense<2 * kTileM, kDenseSlab / 2>(x, a1, wdt, bd, a2, w1, b1, out, B, C, T,
                                                       dil, s)
             : launch_dense<kTileM, kDenseSlab>(x, a1, wdt, bd, a2, w1, b1, out, B, C, T, dil,
                                                s);
}
