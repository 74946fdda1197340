// Fused residual unit for Hopper (sm_90a): the depthwise form.
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/resunit.py:154
// (fused_residual_unit, _make_kernel) with depthwise=True. It computes, for
// x in torch's [B, C, T] layout,
//
//   out = x + b1 + W1 . snake(bd + dilconv_k7(snake(x, a1); Wd), a2)
//
// with a 7-tap conv of dilation d and zero padding 3d, then a C x C
// pointwise conv. The depthwise form (groups = C, every SNAC preset) has
// Wd [C, 1, 7]; the dense form (groups = 1, DAC) is resunit_dense.cu.
//
// What bounds it on the H100: the C x C pointwise product, 2 C^2 flops per
// element against 8 bytes of input and output, bound by f32 operations at
// every width the models use; the unfused chain also moves five
// intermediate [B, C, T] tensors through device memory. The design keeps
// every intermediate on chip: one block per (stream, time tile) computes
// y = snake(bd + dilconv(snake(x)), a2) for its tile into shared memory,
// y [C, tile], then the pointwise product from there, and adds bias and
// residual as it writes the output, once. Products are f32 FMAs on a 4 x 4
// register tile a thread (64 output channels x 64 time steps a pass of
// 16 x 16 threads); the weights are staged in slabs.
//
// Stage 1: the snaked window (tile + dilation halo) is staged channel chunk
// by channel chunk and convolved channel by channel. The time tile is
// chosen from C so that y fits (128 steps up to C = 128, else 64: 128 KB at
// C = 512).
//
// Ragged channel counts (any C, masked against the 64-channel tiles), the
// ragged tail of T and the zero halo at both ends are masked in the kernel.
// ptxas's register and spill report is printed by chip_smoke.py's build
// phase.

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
