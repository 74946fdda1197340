// LSTM layer recurrence for Hopper (sm_90a): one persistent grid, a
// per-step handoff through a counter in device memory.
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
// what costs is the chain of latencies from one block's h_t to every
// block's h_{t+1}. On the TPU the grid runs in order on one core and W_hh
// sits in VMEM; here W_hh at H = 512 is 4 MiB of f32, so it is split across
// the SMs and the blocks hand h over once a step.
//
// The design: one cooperative launch (for its co-residency guarantee) of
// ceil(H / kUnits) blocks, at most one a SM. Block j owns kUnits hidden units
// and their 4 kUnits rows of W_hh, held in registers for the whole sequence
// (32 floats a thread at H = 512), and their cell state. A step, as a chain:
// - thread 0 spins (ld.acquire.gpu) on one 64-bit arrival counter until
//   every block has arrived from step t-1; then it pulls h_{t-1} [BS, H]
//   from ys[t-1] (h0 at t = 0) into shared memory with one cp.async.bulk,
//   completing on an mbarrier, after the fence.proxy.async that orders the
//   generic stores it acquired before the async copy. Where a row is not
//   whole 128-float chunks (H % 128 != 0) warp 0 copies h with 4-byte
//   ld.global.cg loads instead, a group of them in flight at once, past
//   L1, since other blocks wrote h during this launch;
// - gates_x[t] was copied into a double buffer by cp.async during step t-1,
//   off the chain;
// - each warp forms RW = kUnits / 2 weight rows x 4 batch rows of gate sums:
//   a lane holds k = 4 lane + 128 c (c < NC) of its rows, multiplies them
//   with h from shared memory (float4 reads, conflict-free) and the warp
//   reduces the 8 sums in 9 shuffles (warp_reduce: each level halves the
//   sums a lane keeps) instead of 8 x 5; the lane that ends with a sum adds
//   gates_x and applies that gate's sigmoid or tanh, so the transcendentals
//   of a step run on 64 lanes at once;
// - warp 0 applies the cell (one tanh a unit) and stores h_t into ys[t],
//   then lane 0 fences and adds 1 to the counter.
// So a step is one handoff (a release add, an acquire poll) instead of the
// cooperative barrier's arrive-and-wait, two block barriers, and one L2
// round trip each for the poll and for h. ys is the double buffer: step t
// reads ys[t-1] and writes ys[t], and no block reads ys[t] before every
// block has arrived from step t, so nothing is overwritten while read.
//
// The counter lives in device memory for the life of the library. Each
// launch is two nodes on its stream: a cudaMemsetAsync that zeroes the
// counter, then the kernel, which waits for blocks x t arrivals at step t.
// Nothing of a launch is kept on the host, so a launch captured into a
// CUDA graph replays right after any other launch, eager or replayed.
// The counter is one a device, so launches on one device must not overlap;
// the port issues them on torch's current stream. The kernel goes out through cudaLaunchKernelEx
// with the cooperative attribute (its co-residency guarantee), which
// stream capture takes; the shared-memory attribute is set once per
// instantiation, device and size, outside any capture that follows. No
// fast-math intrinsics: expf and tanhf keep the kernel within 1e-5 of the
// plain PyTorch loop.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// hidden units a block: 128 blocks at H = 512, the fastest of 128, 64 and
// 32 (tools/lstm_ablate.py's blocks64 / blocks32 variants)
constexpr int kUnits = 4;
constexpr int kRowsPerWarp = 4 * kUnits / kWarps;
constexpr int kTileB = 4;                  // batch rows a register tile
constexpr int kMaxChunks = 5;              // H <= 640: k chunks of 128 a lane
constexpr int kStageLoads = 16;            // loads in flight a lane, without bulk copies
constexpr int kSmemBudget = 200 * 1024;    // bytes of dynamic shared memory
constexpr int kMaxDevices = 64;

__device__ unsigned long long g_arrivals;  // blocks that finished a step, this launch

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar` (expecting the bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// the N sums a[0 .. N) of every lane reduced over the warp: each level
// sends half of what a lane keeps, so lane l ends holding sum l / (32 / N);
// N - 1 + 5 - log2(N) shuffles (9 at N = 8) instead of 5 N
template <int N>
__device__ __forceinline__ float warp_reduce(float (&a)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: a power of two <= 32");
  int off = 16;
#pragma unroll
  for (int half = N / 2; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? a[i] : a[i + half];
      const float keep = upper ? a[i + half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float s = a[0];
#pragma unroll
  for (; off >= 1; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// NC: 128-wide k chunks a lane holds of each weight row (ceil(H / 128))
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                 const float* h0, const float* __restrict__ c0, float* ys,
                 float* __restrict__ h_f, float* __restrict__ c_f, int T, int B, int H,
                 int BS, int bulk) {
  constexpr int R = 4 * kUnits;   // weight rows of this block
  constexpr int KP = 128 * NC;    // h row stride in shared memory
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                                   // [BS][KP] staged h_{t-1}
  float* a_s = h_s + static_cast<size_t>(BS) * KP;     // [R][BS] activated gates
  float* g_s = a_s + static_cast<size_t>(R) * BS;      // [2][B][R] gates_x, double buffer
  float* c_s = g_s + static_cast<size_t>(2) * R * B;   // [B][kUnits] cell state
  __shared__ uint64_t h_bar;                           // h_{t-1}'s bulk copy landed

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int u0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - u0);  // units this block owns
  const int four_h = 4 * H;

  // this warp's rows lr = warp RW + r (gate lr / kUnits, unit lr % kUnits),
  // k = 4 lane + 128 c + e, zero past H and past the block's units
  float w[kRowsPerWarp][NC][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = warp * kRowsPerWarp + r;
    const int g = lr / kUnits, j = lr % kUnits;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * lane + 128 * c + e;
        w[r][c][e] = (j < nu && k < H) ? w_hh[static_cast<size_t>(g * H + u0 + j) * H + k] : 0.f;
      }
  }
  // h's columns past H stay zero (their weights are zero, and 0 * garbage
  // could be NaN)
  for (int i = tid; i < BS * KP; i += kThreads) h_s[i] = 0.f;
  for (int i = tid; i < B * kUnits; i += kThreads) {
    const int b = i / kUnits, j = i % kUnits;
    c_s[i] = j < nu ? c0[static_cast<size_t>(b) * H + u0 + j] : 0.f;
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&h_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t h_phase = 0;
  // gates_x[t] of this block's rows into g_s[t % 2]: one 4-byte cp.async a
  // thread and row element (rows past nu are never read)
  auto prefetch_gates = [&](int t) {
    float* dst = g_s + (t & 1) * R * B;
    for (int i = tid; i < R * B; i += kThreads) {
      const int b = i / R, lr = i % R;
      const int g = lr / kUnits, j = lr % kUnits;
      if (j < nu)
        cp_async4(dst + i, gx + (static_cast<size_t>(t) * B + b) * four_h + g * H + u0 + j);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  prefetch_gates(0);
  __syncthreads();  // h_s's zeros and the barrier's init land before h is staged

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      prefetch_gates(t + 1);
    } else {
      asm volatile("cp.async.commit_group;" ::: "memory");  // keeps the group count
    }
    const float* h_prev = t == 0 ? h0 : ys + static_cast<size_t>(t - 1) * B * H;
    const float* g_now = g_s + (t & 1) * R * B;
    for (int b0 = 0; b0 < B; b0 += BS) {
      const int nb = min(BS, B - b0);
      if (warp == 0) {
        // ---- handoff: wait until every block has stored h_{t-1}
        if (t > 0 && b0 == 0) {
          if (lane == 0) {
            const unsigned long long want = static_cast<unsigned long long>(gridDim.x) * t;
            while (load_acquire(&g_arrivals) < want) {
            }
          }
          __syncwarp();
        }
        // ---- stage h_{t-1} rows b0 .. b0 + nb
        const float* src = h_prev + static_cast<size_t>(b0) * H;
        if (bulk) {
          // one request: the rows are contiguous in both places (H = KP)
          if (lane == 0) {
            // order the other blocks' stores (acquired above, generic
            // proxy) and this block's reads of h_s before the async copy
            asm volatile("fence.proxy.async;" ::: "memory");
            bulk_load(h_s, src, static_cast<uint32_t>(nb) * H * 4, &h_bar);
          }
        } else {
          // 4-byte loads, past L1, every load of a group in flight first
          for (int r = 0; r < nb; ++r) {
            for (int k0 = 0; k0 < H; k0 += 32 * kStageLoads) {
              float v[kStageLoads];
#pragma unroll
              for (int s = 0; s < kStageLoads; ++s) {
                const int k = k0 + s * 32 + lane;
                if (k < H) v[s] = __ldcg(src + static_cast<size_t>(r) * H + k);
              }
#pragma unroll
              for (int s = 0; s < kStageLoads; ++s) {
                const int k = k0 + s * 32 + lane;
                if (k < H) h_s[r * KP + k] = v[s];
              }
            }
          }
        }
      }
      if (bulk) {
        mbar_wait(&h_bar, h_phase);
        h_phase ^= 1;
      }
      // gates_x[t] has landed (gates_x[t + 1] may still be in flight)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();

      // ---- gate sums, gates_x added, each gate's activation
      for (int bt = 0; bt < nb; bt += kTileB) {
        float acc[kRowsPerWarp * kTileB];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp * kTileB; ++i) acc[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int bb = 0; bb < kTileB; ++bb) {
            // rows bt + bb >= nb hold stale h; their sums are never stored
            const float4 hv =
                *reinterpret_cast<const float4*>(h_s + (bt + bb) * KP + 4 * lane + 128 * c);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              float& s = acc[r * kTileB + bb];
              s = fmaf(w[r][c][0], hv.x, s);
              s = fmaf(w[r][c][1], hv.y, s);
              s = fmaf(w[r][c][2], hv.z, s);
              s = fmaf(w[r][c][3], hv.w, s);
            }
          }
        }
        constexpr int kSums = kRowsPerWarp * kTileB;
        const float sum = warp_reduce<kSums>(acc, lane);
        const int v = lane / (32 / kSums);
        const int lr = warp * kRowsPerWarp + v / kTileB, bb = bt + v % kTileB;
        if (lane % (32 / kSums) == 0 && bb < nb && lr % kUnits < nu) {
          const float gate = sum + g_now[(b0 + bb) * R + lr];
          a_s[lr * BS + bb] = lr / kUnits == 2 ? tanhf(gate) : sigmoid_f(gate);
        }
      }
      __syncthreads();

      // ---- the cell, and h_t into ys[t]
      if (warp == 0) {
        for (int i = lane; i < nb * kUnits; i += 32) {
          const int bb = i / kUnits, j = i % kUnits;
          if (j >= nu) continue;
          const int b = b0 + bb;
          const float ig = a_s[(0 * kUnits + j) * BS + bb];
          const float fg = a_s[(1 * kUnits + j) * BS + bb];
          const float gg = a_s[(2 * kUnits + j) * BS + bb];
          const float og = a_s[(3 * kUnits + j) * BS + bb];
          const float c = fg * c_s[b * kUnits + j] + ig * gg;
          const float h = og * tanhf(c);
          c_s[b * kUnits + j] = c;
          ys[(static_cast<size_t>(t) * B + b) * H + u0 + j] = h;
          if (t == T - 1) {
            h_f[static_cast<size_t>(b) * H + u0 + j] = h;
            c_f[static_cast<size_t>(b) * H + u0 + j] = c;
          }
        }
        __syncwarp();
      }
    }
    // ---- handoff: this block's h_t is stored
    if (tid == 0) {
      __threadfence();
      atomicAdd(&g_arrivals, 1ull);
    }
  }
}

// The launch on a card of `sms` SMs: `blocks` blocks of kUnits hidden
// units, NC k chunks a lane, BS batch rows of h staged a pass, `smem` bytes
// of dynamic shared memory.
struct Plan {
  int sms, blocks, NC, BS;
  size_t smem;
};

cudaError_t make_plan(int B, int H, int device, Plan* p) {
  if (B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  p->blocks = (H + kUnits - 1) / kUnits;
  p->NC = (H + 127) / 128;
  if (p->blocks > p->sms || p->NC > kMaxChunks)
    return cudaErrorInvalidValue;  // H past one block a SM at kUnits units
  // shared memory: gates_x's double buffer and c fixed; per staged batch row
  // one h row and 4 kUnits activated gates. BS: all of B (rounded up to the
  // register tile) if it fits.
  const size_t fixed = static_cast<size_t>(2 * 4 * kUnits + kUnits) * B * 4;
  const size_t per_row = (static_cast<size_t>(128) * p->NC + 4 * kUnits) * 4;
  if (fixed + per_row * kTileB > static_cast<size_t>(kSmemBudget))
    return cudaErrorInvalidValue;  // B too large for one block
  const int fit = static_cast<int>((kSmemBudget - fixed) / per_row) / kTileB * kTileB;
  p->BS = std::min(fit, (B + kTileB - 1) / kTileB * kTileB);
  p->smem = fixed + per_row * p->BS;
  return cudaSuccess;
}

// Allow `bytes` of dynamic shared memory to `kernel` on `device`, once per
// size: a runtime call, kept out of every launch after the first of a shape.
cudaError_t allow_smem(const void* kernel, int device, size_t bytes) {
  struct Allowed {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static Allowed seen[64];
  static int count = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < count; ++i)
    if (seen[i].kernel == kernel && seen[i].device == device && seen[i].bytes >= bytes)
      return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err == cudaSuccess && count < 64) seen[count++] = {kernel, device, bytes};
  return err;
}

// g_arrivals' address on `device` (the current device), looked up once
cudaError_t arrivals_counter(int device, void** out) {
  static std::mutex mu;
  static void* addr[kMaxDevices] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (addr[device] == nullptr) {
    const cudaError_t err = cudaGetSymbolAddress(&addr[device], g_arrivals);
    if (err != cudaSuccess) return err;
  }
  *out = addr[device];
  return cudaSuccess;
}

template <int NC>
cudaError_t launch(const Plan& p, const float* gx, const float* w_hh, const float* h0,
                   const float* c0, float* ys, float* h_f, float* c_f, int T, int B, int H,
                   int device, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(lstm_scan_kernel<NC>);
  cudaError_t err = allow_smem(kernel, device, p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_scan_kernel<NC>, kThreads,
                                                      p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm * p.sms < p.blocks) return cudaErrorCooperativeLaunchTooLarge;
  // one bulk copy of h a pass: its rows fill whole 128-float chunks and
  // start on 16 bytes
  int bulk = H % 128 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  void* counter = nullptr;
  err = arrivals_counter(device, &counter);
  if (err != cudaSuccess) return err;
  // the launch's arrivals count from 0: the reset is a node of the stream
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_scan_kernel<NC>, gx, w_hh, h0, c0, ys, h_f, c_f, T, B, H,
                           p.BS, bulk);
  return err != cudaSuccess ? err : cudaGetLastError();
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
  if (T <= 0 || B <= 0 || H <= 0 || device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  Plan p;
  err = make_plan(B, H, device, &p);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.NC) {
    case 1: return launch<1>(p, gx, w_hh, h0, c0, ys, h_f, c_f, T, B, H, device, s);
    case 2: return launch<2>(p, gx, w_hh, h0, c0, ys, h_f, c_f, T, B, H, device, s);
    case 3: return launch<3>(p, gx, w_hh, h0, c0, ys, h_f, c_f, T, B, H, device, s);
    case 4: return launch<4>(p, gx, w_hh, h0, c0, ys, h_f, c_f, T, B, H, device, s);
    default: return launch<5>(p, gx, w_hh, h0, c0, ys, h_f, c_f, T, B, H, device, s);
  }
}

// The plan nc_lstm_scan_f32 launches with at B, H on `device`: out[0] = U
// (hidden units per block), out[1] = blocks, out[2] = BS (batch rows of h
// staged per pass; B > BS takes several passes per step). Launches nothing.
extern "C" int nc_lstm_plan(int B, int H, int device, int* out) {
  Plan p;
  const cudaError_t err = make_plan(B, H, device, &p);
  if (err != cudaSuccess) return err;
  out[0] = kUnits;
  out[1] = p.blocks;
  out[2] = p.BS;
  return cudaSuccess;
}
