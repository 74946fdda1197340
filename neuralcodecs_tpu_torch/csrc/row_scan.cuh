// Tile pipeline shared by the per-sample recurrences (envelope.cu, biquad.cu).
//
// Both kernels run a serial first-order-in-time recurrence along each row of
// a row-major [N, T] f32 signal, one chain per row, with the state in
// registers. Their step is a chain of dependent f32 ops (25-27 cycles a step
// measured on an H100), and
// at the DSP pipeline's shapes (N = 64, T = 240 000) there are far too few
// chains to hide anything: the whole kernel is T of those steps back to back.
// So the one thing the design has to get right is that the step loop never
// waits on device memory.
//
// A block owns kRows = 4 rows (lanes 0-3 of warp 0, the stepping warp) and
// walks T in tiles of kTile samples, through two shared-memory buffers of
// [kRows][kStride] floats:
//   - warps 1-3 (the loaders) copy tile k+1 from device memory into one
//     buffer with cp.async (4 bytes a thread, neighbouring threads on
//     neighbouring samples, so any T and any row alignment is coalesced),
//     after writing the previous tile's results out of that same buffer;
//   - meanwhile warp 0 steps tile k in the other buffer, reading 4 samples
//     at a time as a float4 and writing its outputs back in place;
//   - one __syncthreads() per tile hands the buffers over.
// The row stride kTile + 4 keeps the float4 reads and writes of the stepping
// lanes (one row each) free of bank conflicts: their rows start 4 banks
// apart. Rows past N and samples past T are neither loaded nor stepped nor
// stored, so the kernels take any N >= 1 and T >= 1 with no padding.
//
// Why 4 rows: copying costs the loaders about 0.8 ns per element per SM
// (measured on an H100 at N = 64, T = 240 000), so with 32 rows a block (2
// SMs at N = 64) the copies, not the steps, set the pace: 9.3 ms against
// 3.3 ms for the stepping warp alone. 4 rows a block spread the copies over
// 16 SMs and leave the step chain as the bound.

#pragma once

#include <cuda_runtime.h>

namespace row_scan {

constexpr int kRows = 4;                  // chains per block, one per lane of warp 0
constexpr int kTile = 256;                // samples per tile
constexpr int kStride = kTile + 4;        // floats per buffered row
constexpr int kLoaders = 96;              // threads of warps 1-3
constexpr int kThreads = 32 + kLoaders;
constexpr int kBufFloats = kRows * kStride;
constexpr size_t kSmemBytes = 2 * kBufFloats * sizeof(float);   // 8 320 B
static_assert(kSmemBytes <= 48 * 1024, "dynamic shared memory above 48 KB needs an opt-in");

__device__ __forceinline__ void cp_async4(float* dst_smem, const float* src_gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src_gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loader thread l copies its share of tile k (rows [row0, row0 + nr),
// samples [k kTile, k kTile + len)) into buf. load_tile and store_tile give
// each loader the same elements, so a loader's writes of a buffer never
// overtake its own earlier reads of it.
__device__ __forceinline__ void load_tile(float* buf, const float* __restrict__ x, int l,
                                          int row0, int nr, int T, int k, int len) {
  const size_t t0 = static_cast<size_t>(k) * kTile;
  for (int e = l; e < kRows * kTile; e += kLoaders) {
    const int r = e / kTile, c = e % kTile;
    if (r < nr && c < len)
      cp_async4(buf + r * kStride + c, x + (row0 + r) * static_cast<size_t>(T) + t0 + c);
  }
}

__device__ __forceinline__ void store_tile(const float* buf, float* __restrict__ y, int l,
                                           int row0, int nr, int T, int k, int len) {
  const size_t t0 = static_cast<size_t>(k) * kTile;
  for (int e = l; e < kRows * kTile; e += kLoaders) {
    const int r = e / kTile, c = e % kTile;
    if (r < nr && c < len)
      y[(row0 + r) * static_cast<size_t>(T) + t0 + c] = buf[r * kStride + c];
  }
}

// Runs `step` (a functor float -> float that carries its state) over the
// row of this lane in buf, in place.
template <class Step>
__device__ __forceinline__ void step_row(float* row, int len, Step& step) {
  int c = 0;
#pragma unroll 2
  for (; c + 4 <= len; c += 4) {
    float4 v = *reinterpret_cast<float4*>(row + c);
    v.x = step(v.x);
    v.y = step(v.y);
    v.z = step(v.z);
    v.w = step(v.w);
    *reinterpret_cast<float4*>(row + c) = v;
  }
  for (; c < len; ++c) row[c] = step(row[c]);
}

// y[n, :] = the recurrence `step` over x[n, :], for the kRows rows of this
// block. Launch with kThreads threads and kSmemBytes of dynamic shared memory.
template <class Step>
__device__ __forceinline__ void scan_rows(const float* __restrict__ x, float* __restrict__ y,
                                          int N, int T, Step step) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kRows;
  const int nr = min(kRows, N - row0);
  const int tiles = (T + kTile - 1) / kTile;
  const bool stepper = threadIdx.x < 32;
  const int l = threadIdx.x - 32;  // loader index, for threads of warps 1-3
  auto buf = [&](int k) { return smem + (k & 1) * kBufFloats; };
  auto len = [&](int k) { return min(kTile, T - k * kTile); };

  if (!stepper) {
    load_tile(buf(0), x, l, row0, nr, T, 0, len(0));
    cp_async_wait_all();
  }
  __syncthreads();
  for (int k = 0; k < tiles; ++k) {
    if (stepper) {
      if (threadIdx.x < nr) step_row(buf(k) + threadIdx.x * kStride, len(k), step);
    } else {
      if (k >= 1) store_tile(buf(k - 1), y, l, row0, nr, T, k - 1, len(k - 1));
      if (k + 1 < tiles) load_tile(buf(k + 1), x, l, row0, nr, T, k + 1, len(k + 1));
      cp_async_wait_all();
    }
    __syncthreads();  // tile k stepped, tile k+1 loaded
  }
  if (!stepper) store_tile(buf(tiles - 1), y, l, row0, nr, T, tiles - 1, len(tiles - 1));
}

// Launches `kernel` over N rows of T samples on `stream`; returns the
// launch's error.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int N, int T, int device, void* stream, Args... args) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || T <= 0) return cudaErrorInvalidValue;
  const int blocks = (N + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args..., N, T);
  return cudaGetLastError();
}

}  // namespace row_scan
