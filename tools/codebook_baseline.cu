// The codebook-argmin kernel as it stood before its redesign (one block of
// 32 rows that stages the whole codebook, 4-byte strided loads), kept
// unchanged as the baseline that chip_smoke.py's codebook phase and
// tools/codebook_ablate.py build and time beside csrc/codebook.cu. It
// exports the same C entry, nc_codebook_argmin_f32. Not part of the port's
// library.
//
// Fused L2-argmin codebook search for Hopper (sm_90a).
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/codebook.py
// (l2_argmin_pallas, body _kernel). For each row x of the flattened latents
// [T, D] it returns argmin_n (|e_n|^2 - 2 x.e_n) over the codebook [N, D],
// ties to the lowest index (torch.argmin). The [T, N] score matrix is never
// written to device memory.
//
// What bounds it on the H100: at SNAC's and DAC's D = 8 each codebook
// element read from shared memory feeds one FMA per row, so the kernel is
// bound by operations and shared-memory bandwidth, not device bytes (the
// inputs are tens of KB; the codebook stays in L2). The design keeps the
// inner loop on registers and broadcasts: a block owns 32 rows (one per
// lane, the row cached in a padded shared tile so the per-lane reads do not
// conflict); its 8 warps split each staged codebook chunk; each thread
// scores a tile of 8 entries at a time, reading them as two float4
// broadcasts shared by the whole warp. The codebook is staged entry-fastest
// ([D][chunk]) with its norms. SNAC's 4096 x 8 codebook with norms
// (~144 KB) fits in one chunk, as dynamic shared memory above 48 KB;
// larger ones (Encodec 1024 x 128) stream through in chunks. Each thread
// keeps a running (min, index) with strict '<' in increasing index order,
// and the warps' partial results are merged by (value, index), so the
// lowest index wins a tie.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kRows = 32;                 // rows per block, one per lane
constexpr int kWarps = 8;                 // warps splitting a codebook chunk
constexpr int kTile = 8;                  // entries scored per register tile
constexpr int kThreads = kRows * kWarps;
constexpr int kSmemBudget = 200 * 1024;   // bytes of dynamic shared memory

__global__ void __launch_bounds__(kThreads)
codebook_argmin_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                       int* __restrict__ out, int T, int N, int D, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int xs = D + 1;                            // padded row stride
  float* x_s = smem;                               // [kRows][D + 1]
  float* cb_s = x_s + kRows * xs;                  // [D][chunk], entry-fastest
  float* esq_s = cb_s + static_cast<size_t>(D) * chunk;  // [chunk]
  float* red_v = esq_s + chunk;                    // [kWarps][kRows]
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kRows);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kRows;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    x_s[r * xs + d] = row < T ? x[static_cast<size_t>(row) * D + d] : 0.f;
  }

  float best = INFINITY;
  int best_i = N;  // sentinel: no finite score seen
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int cn = min(chunk, N - c0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = tid; i < cn * D; i += kThreads) {
      const int d = i / cn, n = i % cn;
      cb_s[d * chunk + n] = cb[static_cast<size_t>(c0 + n) * D + d];
    }
    __syncthreads();
    for (int n = tid; n < cn; n += kThreads) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float e = cb_s[d * chunk + n];
        s = fmaf(e, e, s);
      }
      esq_s[n] = s;
    }
    __syncthreads();
    for (int base = warp * kTile; base < cn; base += kWarps * kTile) {
      float acc[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float xd = x_s[lane * xs + d];
        const float4* e = reinterpret_cast<const float4*>(cb_s + d * chunk + base);
        const float4 e0 = e[0], e1 = e[1];
        acc[0] = fmaf(xd, e0.x, acc[0]);
        acc[1] = fmaf(xd, e0.y, acc[1]);
        acc[2] = fmaf(xd, e0.z, acc[2]);
        acc[3] = fmaf(xd, e0.w, acc[3]);
        acc[4] = fmaf(xd, e1.x, acc[4]);
        acc[5] = fmaf(xd, e1.y, acc[5]);
        acc[6] = fmaf(xd, e1.z, acc[6]);
        acc[7] = fmaf(xd, e1.w, acc[7]);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (base + j < cn) {
          const float s = esq_s[base + j] - 2.f * acc[j];
          if (s < best) {
            best = s;
            best_i = c0 + base + j;
          }
        }
      }
    }
  }

  red_v[warp * kRows + lane] = best;
  red_i[warp * kRows + lane] = best_i;
  __syncthreads();
  if (warp == 0) {
    float v = red_v[lane];
    int idx = red_i[lane];
    for (int w = 1; w < kWarps; ++w) {
      const float v2 = red_v[w * kRows + lane];
      const int i2 = red_i[w * kRows + lane];
      if (v2 < v || (v2 == v && i2 < idx)) {
        v = v2;
        idx = i2;
      }
    }
    const int row = row0 + lane;
    if (row < T) out[row] = idx < N ? idx : 0;
  }
}

}  // namespace

// x [T, D], cb [N, D] f32 contiguous; out [T] int32. Returns cudaGetLastError().
extern "C" int nc_codebook_argmin_f32(const float* x, const float* cb, int* out,
                                      int T, int N, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T <= 0) return cudaSuccess;
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  const size_t fixed = (static_cast<size_t>(kRows) * (D + 1) + 2 * kWarps * kRows) * 4;
  const size_t per_entry = static_cast<size_t>(D + 1) * 4;
  if (fixed + per_entry * kWarps * kTile > static_cast<size_t>(kSmemBudget))
    return cudaErrorInvalidValue;  // D too large for one staged chunk
  // chunk: a multiple of kWarps * kTile that fits the budget, or all of N
  // rounded up to kTile (the float4 tiles may read past cn, never past chunk)
  const int max_chunk = static_cast<int>((kSmemBudget - fixed) / per_entry)
                        / (kWarps * kTile) * (kWarps * kTile);
  const int chunk = std::min(max_chunk, (N + kTile - 1) / kTile * kTile);
  const size_t smem = fixed + per_entry * chunk;
  err = cudaFuncSetAttribute(codebook_argmin_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (T + kRows - 1) / kRows;
  codebook_argmin_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, cb, out, T, N, D, chunk);
  return cudaGetLastError();
}
