// LSTM layer recurrence for Hopper (sm_90a): one persistent cooperative grid.
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/lstm.py
// (lstm_scan_pallas, body _kernel). Given the hoisted input projection
// gates_x [T, B, 4H] (x . W_ih^T + b_ih + b_hh), the recurrent weight W_hh in
// torch's layout [4H, H] (gate order i, f, g, o) and the state h0, c0 [B, H],
// it runs, for t = 0 .. T-1,
//
//   gates = gates_x[t] + h_{t-1} . W_hh^T
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g),  h_t = sigmoid(o) * tanh(c_t)
//
// and writes ys [T, B, H] = h_t, plus h_f, c_f [B, H], the state after the
// last step.
//
// What bounds it on the H100: the serial latency of a step. Each step needs
// all of h_{t-1} before it can start, and is tiny (2 B H 4H flops: 8.4 MFLOP
// at B = 4, H = 512; h_{t-1} is 8 KB), so neither bytes nor flops matter:
// what costs is the chain of latencies inside a step (stage h from L2, the
// dot products, the cell) and the per-step grid barrier (about 1.1 us on an
// H100 for 32-132 blocks). On the TPU the grid runs in order on one core and
// W_hh sits in VMEM; here W_hh at H = 512 is 4 MiB of f32, far more than one
// block's shared memory, so the weight is split across the SMs and the grid
// synchronises once per step.
//
// The design: one cooperative launch (cudaLaunchCooperativeKernel) of at most
// one block per SM. Block j owns U = ceil(H / SMs) hidden units (4 at
// H = 512: 128 blocks); it keeps their 4U rows of W_hh in shared memory for
// the whole sequence (32 KB at H = 512) and their cell state c on chip. Each
// step it stages h_{t-1} [B, H] from ys[t-1] (h0 at t = 0; read through L2
// with __ldcg, since other blocks wrote it during this launch) into shared
// memory, in chunks of BS batch rows where B H does not fit, together with
// its units' input gates gates_x[t]; computes its 4 U B gate sums with f32
// FMAs (a warp per weight row, lanes across H, up to 8 batch rows per
// register tile, then a warp shuffle reduction); applies the cell; writes
// its units of h_t to ys[t]; and meets the other blocks at grid.sync(). ys
// itself is the double buffer: step t reads ys[t-1] and writes ys[t], so no
// block can overwrite what another still reads, and one barrier per step
// suffices. No fast-math intrinsics: expf and tanhf keep the kernel within
// 1e-5 of the plain PyTorch loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileB = 8;                 // batch rows per register tile
constexpr int kSmemBudget = 200 * 1024;   // bytes of dynamic shared memory

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
lstm_scan_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                 const float* h0, const float* __restrict__ c0, float* ys,
                 float* __restrict__ h_f, float* __restrict__ c_f,
                 int T, int B, int H, int U, int BS) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int R = 4 * U;                        // weight rows of this block
  float* w_s = smem;                          // [R][H]
  float* h_s = w_s + static_cast<size_t>(R) * H;   // [BS][H] staged h_{t-1}
  float* g_s = h_s + static_cast<size_t>(BS) * H;  // [R][BS] gate sums
  float* c_s = g_s + static_cast<size_t>(R) * BS;  // [B][U] cell state

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);              // units this block owns
  const int four_h = 4 * H;

  for (int i = tid; i < R * H; i += kThreads) {
    const int lr = i / H, k = i % H;
    const int g = lr / U, j = lr % U;
    w_s[i] = j < nu ? w_hh[static_cast<size_t>(g * H + u0 + j) * H + k] : 0.f;
  }
  for (int i = tid; i < B * U; i += kThreads) {
    const int b = i / U, j = i % U;
    c_s[i] = j < nu ? c0[static_cast<size_t>(b) * H + u0 + j] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : ys + static_cast<size_t>(t - 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += BS) {
      const int nb = min(BS, B - b0);
      __syncthreads();  // h_s, g_s and w_s (first pass) are ready to be (re)written/read
      for (int i = tid; i < BS * H; i += kThreads) {
        const int r = i / H;
        h_s[i] = r < nb ? __ldcg(h_prev + static_cast<size_t>(b0) * H + i) : 0.f;
      }
      // the input gates of this step seed the gate sums; their loads overlap
      // the staging of h instead of following the dot products
      for (int i = tid; i < R * nb; i += kThreads) {
        const int lr = i / nb, bb = i % nb;
        const int g = lr / U, j = lr % U;
        if (j < nu)
          g_s[lr * BS + bb] = gx[(static_cast<size_t>(t) * B + b0 + bb) * four_h + g * H + u0 + j];
      }
      __syncthreads();
      for (int lr = warp; lr < R; lr += kWarps) {
        if (lr % U >= nu) continue;  // warp-uniform
        const float* w_row = w_s + static_cast<size_t>(lr) * H;
        for (int bt = 0; bt < nb; bt += kTileB) {
          float acc[kTileB];
#pragma unroll
          for (int r = 0; r < kTileB; ++r) acc[r] = 0.f;
          // BS is a multiple of kTileB and rows >= nb of h_s are zero, so
          // every tile row is in bounds
          for (int k = lane; k < H; k += 32) {
            const float w = w_row[k];
#pragma unroll
            for (int r = 0; r < kTileB; ++r) acc[r] = fmaf(w, h_s[(bt + r) * H + k], acc[r]);
          }
#pragma unroll
          for (int r = 0; r < kTileB; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          }
#pragma unroll
          for (int r = 0; r < kTileB; ++r) {
            if (lane == r && bt + r < nb) g_s[lr * BS + bt + r] += acc[r];
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < nb * nu; i += kThreads) {
        const int bb = i / nu, j = i % nu;
        const int b = b0 + bb;
        const float gi = g_s[(0 * U + j) * BS + bb];
        const float gf = g_s[(1 * U + j) * BS + bb];
        const float gg = g_s[(2 * U + j) * BS + bb];
        const float go = g_s[(3 * U + j) * BS + bb];
        const float c = sigmoid_f(gf) * c_s[b * U + j] + sigmoid_f(gi) * tanhf(gg);
        const float h = sigmoid_f(go) * tanhf(c);
        c_s[b * U + j] = c;
        ys[(static_cast<size_t>(t) * B + b) * H + u0 + j] = h;
        if (t == T - 1) {
          h_f[static_cast<size_t>(b) * H + u0 + j] = h;
          c_f[static_cast<size_t>(b) * H + u0 + j] = c;
        }
      }
    }
    if (t + 1 < T) grid.sync();  // h_t complete in ys[t] for every block
  }
}

// The launch on a card of `sms` SMs: U hidden units per block, `blocks`
// blocks, BS batch rows of h staged per pass, `smem` bytes of dynamic shared
// memory.
struct Plan {
  int sms, U, blocks, BS;
  size_t smem;
};

cudaError_t make_plan(int B, int H, int device, Plan* p) {
  if (B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  p->U = (H + p->sms - 1) / p->sms;
  p->blocks = (H + p->U - 1) / p->U;
  // shared memory: W rows and c fixed; per staged batch row one h row and
  // 4U gate sums. BS: all of B (rounded up to the register tile) if it fits.
  const size_t fixed = (static_cast<size_t>(4) * p->U * H + static_cast<size_t>(B) * p->U) * 4;
  const size_t per_row = (static_cast<size_t>(H) + 4 * p->U) * 4;
  if (fixed + per_row * kTileB > static_cast<size_t>(kSmemBudget))
    return cudaErrorInvalidValue;  // H or B too large for one block's slice
  const int fit = static_cast<int>((kSmemBudget - fixed) / per_row) / kTileB * kTileB;
  p->BS = std::min(fit, (B + kTileB - 1) / kTileB * kTileB);
  p->smem = fixed + per_row * p->BS;
  return cudaSuccess;
}

}  // namespace

// gx [T, B, 4H], w_hh [4H, H], h0/c0 [B, H], ys [T, B, H], h_f/c_f [B, H]:
// f32, contiguous. Returns cudaGetLastError() after the launch, or the error
// that kept it from launching (the grid does not fit the card co-resident).
extern "C" int nc_lstm_scan_f32(const float* gx, const float* w_hh, const float* h0,
                                const float* c0, float* ys, float* h_f, float* c_f,
                                int T, int B, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  Plan p;
  err = make_plan(B, H, device, &p);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_scan_kernel, kThreads,
                                                      p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm * p.sms < p.blocks) return cudaErrorCooperativeLaunchTooLarge;
  int t = T, b = B, h = H, u = p.U, bs = p.BS;
  void* args[] = {&gx, &w_hh, &h0, &c0, &ys, &h_f, &c_f, &t, &b, &h, &u, &bs};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_scan_kernel), dim3(p.blocks),
                                    dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan nc_lstm_scan_f32 launches with at B, H on `device`: out[0] = U
// (hidden units per block), out[1] = blocks, out[2] = BS (batch rows of h
// staged per pass; B > BS takes several passes per step). Launches nothing.
extern "C" int nc_lstm_plan(int B, int H, int device, int* out) {
  Plan p;
  const cudaError_t err = make_plan(B, H, device, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.U;
  out[1] = p.blocks;
  out[2] = p.BS;
  return cudaSuccess;
}
