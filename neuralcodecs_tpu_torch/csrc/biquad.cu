// Cascade of 1 or 2 direct-form-II-transposed biquads (the BS.1770
// K-weighting) for Hopper (sm_90a), as a chunked scan over time.
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/biquad.py
// (biquad_pallas). Along each row of x [N, T], every section runs, with
// z1 = z2 = 0 before the first sample, for t = 0 .. T-1
//
//   y = b0 u + z1;  z1 = b1 u - a1 y + z2;  z2 = b2 u - a2 y
//
// as the scan in neuralcodecs_tpu/dsp/filters.py (biquad) writes it; u is x
// for the first section and the previous section's y for the next. The
// coefficients are f32 (a0 taken as 1).
//
// What bounds it on the H100: one serial chain a row has a step of four
// dependent f32 ops (~25 cycles), so at N = 64, T = 240 000 a serial kernel
// takes ~3 ms a section on 16 SMs, against a bytes bound of 0.037 ms for the
// whole cascade. The recurrence is linear, so time is cut into chunks of L
// samples that run in parallel (64 rows x 235 chunks: ~15 000 chains), in
// three launches:
//   1. chunk_end_states: every chunk but the last of a row runs the cascade
//      from zero state in f64 and writes its end state e_k (2S doubles);
//   2. carry: one warp a row walks its chunks in order, s_{k+1} = Phi s_k +
//      e_k in f64 (Phi, the cascade's 2S x 2S state transition over L steps,
//      is built by the host in f64 from the f32 coefficients), and writes
//      each chunk's start state rounded to f32;
//   3. chunk_outputs: every chunk re-runs the cascade from its start state
//      with the plain loop's own f32 step (__fmul_rn, __fadd_rn, __fsub_rn:
//      no FMA contraction) and writes y.
// Within a chunk the arithmetic is the plain loop's; only the start state
// differs, by the rounding the loop itself accumulates. So the kernel is not
// bit-exact against the plain loop where T > L, but as accurate against the
// exact (f64) filter: chip_smoke.py holds its max error there to 1.5 x the
// loop's. Where T <= L there is one chunk from zero state and phases 1-2 do
// not run: the plain loop bit for bit. No atomics: the result is
// deterministic.
//
// What bounds the chunked kernel: its bytes, x read twice (phases 1 and 3)
// and y written once, 0.055 ms at the config-4 shape; phase 1's serial f64
// chains (an f64 op has twice an f32 op's latency) run at about twice their
// share of that.
//
// Phases 1 and 3 give a warp 32 chunks, one a lane, and stream them through
// shared memory in tiles of kTile samples, double-buffered by cp.async (16
// bytes a lane where T % 4 == 0 and the pointers are 16-byte aligned, 4
// otherwise) so the step loop does not wait on device memory. A staged
// chunk row keeps its 16-byte granules XOR-swizzled by (chunk & 7): the warp
// copying one chunk's 512 bytes and the 32 lanes each reading 16 bytes of
// their own chunk are both free of bank conflicts. Any N >= 1 and T >= 1,
// with no padding; L a multiple of kTile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                 // chunks a block, one a lane
constexpr int kTile = 128;                 // samples of each chunk staged at once
constexpr int kBufFloats = kLanes * kTile;
constexpr size_t kSmemBytes = 2 * kBufFloats * sizeof(float);   // 32 KB, two tiles
constexpr int kMaxSections = 2;
constexpr int kMaxState = 2 * kMaxSections;

struct Cascade {
  float c[kMaxSections][5];           // b0, b1, b2, a1, a2 of each section
  double phi[kMaxState][kMaxState];   // state transition over L steps
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// offset of sample i of chunk row c in a staged tile
__device__ __forceinline__ int swz(int c, int i) {
  return c * kTile + ((((i >> 2) ^ (c & 7))) << 2) + (i & 3);
}

// The chunks of this warp: where each starts in x (and y) and how many
// samples it has (0 past the last chunk).
struct Chunks {
  long long off[kLanes];
  int len[kLanes];
};

// Copy tile j (samples [j kTile, (j + 1) kTile) of every chunk) into buf.
template <bool kVec>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ x, const Chunks& ch,
                                      int j, int lane) {
  for (int c = 0; c < kLanes; ++c) {
    const int m = min(ch.len[c] - j * kTile, kTile);
    if (m <= 0) continue;
    const float* src = x + ch.off[c] + static_cast<long long>(j) * kTile;
    if (kVec) {
      if (4 * lane < m) cp_async16(buf + swz(c, 4 * lane), src + 4 * lane);
    } else {
      for (int i = lane; i < m; i += kLanes) cp_async4(buf + swz(c, i), src + i);
    }
  }
}

// Write tile j of every chunk from buf to y.
template <bool kVec>
__device__ __forceinline__ void unstage(const float* buf, float* __restrict__ y, const Chunks& ch,
                                        int j, int lane) {
  for (int c = 0; c < kLanes; ++c) {
    const int m = min(ch.len[c] - j * kTile, kTile);
    if (m <= 0) continue;
    float* dst = y + ch.off[c] + static_cast<long long>(j) * kTile;
    if (kVec) {
      if (4 * lane < m)
        *reinterpret_cast<float4*>(dst + 4 * lane) =
            *reinterpret_cast<const float4*>(buf + swz(c, 4 * lane));
    } else {
      for (int i = lane; i < m; i += kLanes) dst[i] = buf[swz(c, i)];
    }
  }
}

// Runs `step` over this lane's chunk row of a staged tile (m samples),
// writing its outputs back in place when kWrite. The next group of 4 is
// read before the current one is stepped, so the shared-memory latency
// overlaps the chain.
template <bool kWrite, class Step>
__device__ __forceinline__ void step_tile(float* buf, int lane, int m, Step& step) {
  int i = 0;
  if (m >= 4) {
    float4 cur = *reinterpret_cast<const float4*>(buf + swz(lane, 0));
#pragma unroll 2
    for (; i + 8 <= m; i += 4) {
      const float4 next = *reinterpret_cast<const float4*>(buf + swz(lane, i + 4));
      cur.x = step(cur.x);
      cur.y = step(cur.y);
      cur.z = step(cur.z);
      cur.w = step(cur.w);
      if (kWrite) *reinterpret_cast<float4*>(buf + swz(lane, i)) = cur;
      cur = next;
    }
    cur.x = step(cur.x);
    cur.y = step(cur.y);
    cur.z = step(cur.z);
    cur.w = step(cur.w);
    if (kWrite) *reinterpret_cast<float4*>(buf + swz(lane, i)) = cur;
    i += 4;
  }
  for (; i < m; ++i) {
    const float v = step(buf[swz(lane, i)]);
    if (kWrite) buf[swz(lane, i)] = v;
  }
}

// Streams this warp's chunks (L samples at most each) through the two
// staged tiles and runs each lane's chunk through `step`; with kWrite the
// outputs go to y.
template <bool kVec, bool kWrite, class Step>
__device__ __forceinline__ void run_chunks(const float* __restrict__ x, float* __restrict__ y,
                                           const Chunks& ch, int L, Step& step) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int tiles = L / kTile;
  stage<kVec>(smem, x, ch, 0, lane);
  cp_async_commit();
  for (int j = 0; j < tiles; ++j) {
    float* buf = smem + (j & 1) * kBufFloats;
    if (j + 1 < tiles) {
      stage<kVec>(smem + ((j + 1) & 1) * kBufFloats, x, ch, j + 1, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    step_tile<kWrite>(buf, lane, min(max(ch.len[lane] - j * kTile, 0), kTile), step);
    __syncwarp();
    if (kWrite) {
      unstage<kVec>(buf, y, ch, j, lane);
      __syncwarp();
    }
  }
}

// The cascade's step in f64 (phase 1; contraction allowed: it only feeds
// the carry).
template <int S>
struct StepF64 {
  double c[S][5], z[S][2];

  __device__ __forceinline__ float operator()(float x) {
    double u = x;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const double y = c[s][0] * u + z[s][0];
      const double z1 = c[s][1] * u - c[s][3] * y + z[s][1];
      z[s][1] = c[s][2] * u - c[s][4] * y;
      z[s][0] = z1;
      u = y;
    }
    return static_cast<float>(u);
  }
};

// The cascade's step in f32, each op rounded on its own, in the order of
// the plain loop (phase 3).
template <int S>
struct StepF32 {
  float c[S][5], z[S][2];

  __device__ __forceinline__ float operator()(float u) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float y = __fadd_rn(__fmul_rn(c[s][0], u), z[s][0]);
      const float z1 = __fadd_rn(__fsub_rn(__fmul_rn(c[s][1], u), __fmul_rn(c[s][3], y)), z[s][1]);
      z[s][1] = __fsub_rn(__fmul_rn(c[s][2], u), __fmul_rn(c[s][4], y));
      z[s][0] = z1;
      u = y;
    }
    return u;
  }
};

// Phase 1: e [N, C - 1, 2S] f64, the zero-start end state of every chunk
// but the last of each row (all L samples long).
template <int S, bool kVec>
__global__ void __launch_bounds__(kLanes)
chunk_end_states(const float* __restrict__ x, double* __restrict__ e, Cascade cs, int N, int T,
                 int L, int C) {
  __shared__ Chunks ch;
  const int lane = threadIdx.x;
  const long long g = static_cast<long long>(blockIdx.x) * kLanes + lane;
  const long long total = static_cast<long long>(N) * (C - 1);
  if (g < total) {
    const long long n = g / (C - 1), k = g % (C - 1);
    ch.off[lane] = n * T + k * L;
    ch.len[lane] = L;
  } else {
    ch.off[lane] = 0;
    ch.len[lane] = 0;
  }
  __syncwarp();
  StepF64<S> step;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < 5; ++i) step.c[s][i] = cs.c[s][i];
    step.z[s][0] = step.z[s][1] = 0.0;
  }
  run_chunks<kVec, false>(x, nullptr, ch, L, step);
  if (g < total) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      e[g * 2 * S + 2 * s] = step.z[s][0];
      e[g * 2 * S + 2 * s + 1] = step.z[s][1];
    }
  }
}

// Phase 2: one warp a row carries the state across its chunks in f64 and
// writes s[n, k] (k >= 1), the start state of chunk k rounded to f32. Lanes
// load 32 chunks' e at once (the next 32 while these are carried); every
// lane runs the same serial chain, taking e_k from lane k by shuffle, and
// lane k keeps s_{k+1} (by a select: a branch a step would hold the
// shuffles back) and rounds it once the 32 steps are done. The steps are
// unrolled so the shuffles run ahead of the chain; past the row's last chunk
// they carry zeros into a state nothing reads.
template <int S>
__global__ void __launch_bounds__(kLanes)
carry(const double* __restrict__ e, float* __restrict__ s, Cascade cs, int C) {
  constexpr int D = 2 * S;
  const int lane = threadIdx.x;
  const double* en = e + static_cast<size_t>(blockIdx.x) * (C - 1) * D;
  float* sn = s + static_cast<size_t>(blockIdx.x) * C * D;
  double phi[D][D], st[D], ahead[D];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    st[r] = 0.0;
    ahead[r] = lane < C - 1 ? en[static_cast<size_t>(lane) * D + r] : 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c) phi[r][c] = cs.phi[r][c];
  }
  for (int k0 = 0; k0 < C - 1; k0 += kLanes) {
    const int k = k0 + lane;
    double mine[D], keep[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mine[d] = ahead[d];
      ahead[d] = k + kLanes < C - 1 ? en[static_cast<size_t>(k + kLanes) * D + d] : 0.0;
      keep[d] = 0.0;
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      double next[D];
#pragma unroll
      for (int r = 0; r < D; ++r) {
        // e + Phi st as two partial sums: a chain ceil(D / 2) + 1 deep
        double even = __shfl_sync(0xffffffffu, mine[r], i), odd = 0.0;
#pragma unroll
        for (int c = 0; c < D; c += 2) {
          even = fma(phi[r][c], st[c], even);
          odd = fma(phi[r][c + 1], st[c + 1], odd);
        }
        next[r] = even + odd;
      }
#pragma unroll
      for (int r = 0; r < D; ++r) {
        st[r] = next[r];
        keep[r] = lane == i ? next[r] : keep[r];  // a select, not a branch
      }
    }
    if (k < C - 1) {
#pragma unroll
      for (int d = 0; d < D; ++d) sn[static_cast<size_t>(k + 1) * D + d] = __double2float_rn(keep[d]);
    }
  }
}

// Phase 3: y, every chunk run from its start state (zero for the first
// chunk of a row) with the plain loop's f32 step.
template <int S, bool kVec>
__global__ void __launch_bounds__(kLanes)
chunk_outputs(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ s,
              Cascade cs, int N, int T, int L, int C) {
  __shared__ Chunks ch;
  const int lane = threadIdx.x;
  const long long g = static_cast<long long>(blockIdx.x) * kLanes + lane;
  const long long total = static_cast<long long>(N) * C;
  long long k = 0;
  if (g < total) {
    const long long n = g / C;
    k = g % C;
    ch.off[lane] = n * T + k * L;
    ch.len[lane] = static_cast<int>(min(static_cast<long long>(L), T - k * L));
  } else {
    ch.off[lane] = 0;
    ch.len[lane] = 0;
  }
  __syncwarp();
  StepF32<S> step;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < 5; ++j) step.c[i][j] = cs.c[i][j];
    const bool carried = g < total && k > 0;
    step.z[i][0] = carried ? s[g * 2 * S + 2 * i] : 0.f;
    step.z[i][1] = carried ? s[g * 2 * S + 2 * i + 1] : 0.f;
  }
  run_chunks<kVec, true>(x, y, ch, L, step);
}

unsigned blocks_for(long long chunks) {
  return static_cast<unsigned>((chunks + kLanes - 1) / kLanes);
}

template <int S, bool kVec>
void launch_phases(const float* x, float* y, double* e, float* s, const Cascade& cs, int N, int T,
                   int L, int C, cudaStream_t stream) {
  if (C > 1) {
    chunk_end_states<S, kVec><<<blocks_for(static_cast<long long>(N) * (C - 1)), kLanes,
                                kSmemBytes, stream>>>(x, e, cs, N, T, L, C);
    carry<S><<<N, kLanes, 0, stream>>>(e, s, cs, C);
  }
  chunk_outputs<S, kVec><<<blocks_for(static_cast<long long>(N) * C), kLanes, kSmemBytes,
                           stream>>>(x, y, s, cs, N, T, L, C);
}

template <int S>
void launch_sections(bool vec, const float* x, float* y, double* e, float* s, const Cascade& cs,
                     int N, int T, int L, int C, cudaStream_t stream) {
  if (vec)
    launch_phases<S, true>(x, y, e, s, cs, N, T, L, C, stream);
  else
    launch_phases<S, false>(x, y, e, s, cs, N, T, L, C, stream);
}

}  // namespace

// x, y [N, T] f32, contiguous, not overlapping; e: N (C - 1) 2S doubles and
// s: N C 2S floats of scratch, C = ceil(T / L); L a positive multiple of
// 128; S = 1 or 2 sections; coefs (host) the S sections' b0, b1, b2, a1, a2;
// phi (host) the 2S x 2S row-major state transition over L steps. Returns
// cudaGetLastError() after the launches.
extern "C" int nc_biquad_cascade_f32(const float* x, float* y, double* e, float* s, int N, int T,
                                     int L, int S, const float* coefs, const double* phi,
                                     int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || T <= 0 || L <= 0 || L % kTile != 0 || S < 1 || S > kMaxSections)
    return cudaErrorInvalidValue;
  Cascade cs = {};
  const int D = 2 * S;
  for (int i = 0; i < S; ++i)
    for (int j = 0; j < 5; ++j) cs.c[i][j] = coefs[5 * i + j];
  for (int r = 0; r < D; ++r)
    for (int c = 0; c < D; ++c) cs.phi[r][c] = phi[r * D + c];
  const int C = (T + L - 1) / L;
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (S == 1)
    launch_sections<1>(vec, x, y, e, s, cs, N, T, L, C, st);
  else
    launch_sections<2>(vec, x, y, e, s, cs, N, T, L, C, st);
  return cudaGetLastError();
}
