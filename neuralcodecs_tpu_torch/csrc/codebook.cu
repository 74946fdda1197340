// Codebook argmin for Hopper (sm_90a): the codebook split across a
// thread-block cluster and merged on chip.
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/codebook.py:46
// (l2_argmin_pallas, body _kernel). For each row x of the flattened latents
// [T, D] it returns argmin_n (|e_n|^2 - 2 x.e_n) over the codebook [N, D] as
// int32, ties to the lowest index (torch.argmin). The [T, N] score matrix is
// never written to device memory.
//
// What bounds it on the H100: latency more than work. The inputs are tens
// of KB to 0.5 MB and stay in L2; the products are 2 T N D flops (SNAC's
// 1888 x 4096 x 8: 1.85 us at the f32 peak; Encodec's 3000 x 1024 x 128:
// 11.7 us, or 4.8 us as 3xTF32 on the tensor cores). The kernel before this
// one lost its time to staging: every block of 32 rows copied the whole
// codebook with one load in flight a thread (~0.3 us a round trip to L2),
// 41 us at 4096 x 8 and 131 us at 1024 x 128 whatever T.
//
// Grid. A cluster of S blocks (S <= 8, the portable cluster size) takes R
// rows; block s of the cluster takes codebook slice s, entries [s ns,
// (s + 1) ns) with ns = N / S rounded up to 8. A slice is contiguous in
// device memory, so the block copies it coalesced, 16 bytes a thread, all
// of its loads in flight at once, and computes |e|^2 for its own entries
// only. It keeps a (min, index) pair for each of its R rows; the S blocks
// then merge the pairs through distributed shared memory (block s merges
// the rows r % S == s, reading each block's pair by map_shared_rank between
// two cluster barriers) and write the codes: one launch, no atomics, no
// scratch, the same result on every run. S is the largest power of two
// <= 8 that leaves a slice >= 256 entries on the CUDA cores (8 at N = 4096,
// 4 at 1024), >= 128 on the tensor cores (8 at 1024: one tile a block),
// halved there where that fits the grid into one wave of blocks (4 at
// Encodec's 3000 rows: two tiles a block, 96 blocks instead of 192).
//
// D in {4, 8, 12, 16} (SNAC 4096 x 8, DAC 1024 x 8, the .ecdc golden's
// 32 x 16): f32 FMAs on the CUDA cores. 256 threads; 2 rows a lane (R = 64) in
// registers, loaded before the slice so the two latencies overlap; the 8
// warps split the slice, a warp scoring 4 entries a step from float4
// broadcasts out of shared memory (every lane reads the same entry). A
// step's 4 scores of a row go through one min of 4 and one compare with the
// running minimum (the index is looked up only when it improves), so a
// score costs its D FMAs, one more for |e|^2 - 2 x.e and under 2 more: this
// form stays a few x above its f32 bound plus the launch latency; tensor
// cores would remove at most the FMAs. A score is the earlier kernel's:
// fmaf over d from 0 for x.e and for |e|^2, then |e|^2 - 2 x.e.
//
// D in {32, 64, 128} (Encodec 1024 x 128): the tensor cores, wgmma m64nNTk8
// TF32 as three passes (small.big + big.small + big.big, a = big + small
// with big a rounded to TF32: csrc/resunit.cu's arithmetic).
// kWarpgroups = 2 warpgroups take 64 rows each (R = 128) against the
// block's NT = 128 entries.
// - Staging: one cp.async of 16 bytes a chunk for every x chunk and every
//   codebook chunk, all in flight, then one wait. x lands at a row stride
//   of D + 4 words (the fragment reads hit 32 distinct banks); the entries
//   land K-major in [32-float slab][entry] tiles, at the 128-byte swizzle
//   the descriptor names. Each thread then splits the chunks it copied in
//   place into big and small tiles and sums their |e|^2 across the entry's
//   lanes; fence.proxy.async makes those stores visible to the tensor cores.
// - A, x, is split in registers a k8 step at a time, two register sets so
//   a step's loads overlap the last step's wgmmas. All D / 8 steps sum into
//   one accumulator (the tensor cores round a sum toward zero, a drift of
//   at most D / 8 x 3 ulps here, well inside the near-tie tolerance).
// - The epilogue works on the accumulator fragment: s = |e|^2 - 2 acc, a
//   thread's minimum over its own columns, a shuffle across the 4 lanes
//   that share a row, then the cluster merge. No score leaves the
//   registers. A slice longer than NT runs in NT-entry tiles.
// kTensorCores = false runs D in {32, 64, 128} on f32 FMAs in the same grid.
//
// Semantics: a running minimum takes a score only if it is strictly less,
// visiting indices in increasing order, and every merge compares (value,
// index), values first: -0 and +0 tie, and the lowest index wins a tie,
// within a slice or across slices. A NaN score never wins, and a row with
// no finite score gets 0, as in the earlier kernel.
//
// Host: the shared-memory attribute is set once per kernel and device; a
// call is one cudaLaunchKernelEx with the cluster dimension. ptxas's report
// and the HGMMA count of the tensor-core form come from chip_smoke.py's
// build phase; tools/codebook_ablate.py times the knobs below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "wgmma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSlices = 8;      // the portable cluster size
constexpr int kMinSlice = 256;     // fewest entries a slice on the CUDA cores
constexpr int kForceSlices = 0;    // > 0: this many slices whatever N
constexpr int kRowsPerLane = 2;    // FMA form: R = 32 x this
constexpr int kWarpgroups = 2;     // tensor-core form: 64 rows each
constexpr bool kTensorCores = true;  // D in {32, 64, 128} on wgmma, else f32 FMAs
constexpr int kTileN = 128;        // entries a wgmma tile
constexpr int kFmaThreads = 256;
constexpr int kFmaWarps = kFmaThreads / 32;
constexpr int kEntryTile = 4;      // entries a thread scores at once (FMA form)
constexpr int kNone = 0x7fffffff;  // index of a row with no finite score yet
constexpr int kMaxSmem = 227 * 1024;

// (v, i) before (best, best_i): values first, then indices
__device__ __forceinline__ void merge(float v, int i, float& best, int& best_i) {
  if (v < best || (v == best && i < best_i)) {
    best = v;
    best_i = i;
  }
}

// The running (min, index) of a row after 4 scores of increasing indices
// n0 < n1 < n2 < n3: as four strict '<' steps in that order. fminf skips a
// NaN; the index is the first whose score equals the minimum (-0 == +0).
__device__ __forceinline__ void keep4(float s0, float s1, float s2, float s3, int n0, int n1,
                                      int n2, int n3, float& best, int& best_i) {
  const float m = fminf(fminf(s0, s1), fminf(s2, s3));
  if (m < best) {
    best = m;
    best_i = s0 == m ? n0 : s1 == m ? n1 : s2 == m ? n2 : n3;
  }
}

// Each block of the cluster holds its slice's pair for each of its R rows
// in blk_v / blk_i. Block `rank` merges rows r % S == rank over the S
// blocks, in slice order, and writes their codes.
__device__ __forceinline__ void cluster_merge(float* blk_v, int* blk_i, int R, int row_base,
                                              int T, int S, int rank, int* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's pairs are written
  for (int r = rank + S * static_cast<int>(threadIdx.x); r < R; r += S * blockDim.x) {
    float v = INFINITY;
    int idx = kNone;
    for (int q = 0; q < S; ++q)
      merge(*cluster.map_shared_rank(blk_v + r, q), *cluster.map_shared_rank(blk_i + r, q), v,
            idx);
    if (row_base + r < T) out[row_base + r] = idx == kNone ? 0 : idx;
  }
  cluster.sync();  // no block leaves while another still reads its pairs
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 16 bytes; with ok false, write zeros and read nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// ---- D in {4, 8, 12, 16} (and, with kTensorCores false, 32 / 64 / 128):
// f32 FMAs. Block blockIdx.x takes slice blockIdx.x % S of rows
// [(blockIdx.x / S) R, + R), R = 32 RT. Dynamic shared memory: e_s [ns][D],
// esq [ns], the warps' pairs [kFmaWarps][R] twice, the block's pairs [R]
// twice.
template <int KD, int RT>
__global__ void __launch_bounds__(kFmaThreads)
argmin_fma(const float* __restrict__ x, const float* __restrict__ cb, int* __restrict__ out,
           int T, int N, int ns, int S) {
  constexpr int D = 4 * KD;
  constexpr int R = 32 * RT;
  extern __shared__ __align__(16) float smem[];
  float* e_s = smem;
  float* esq_s = e_s + ns * D;
  float* warp_v = esq_s + ns;
  int* warp_i = reinterpret_cast<int*>(warp_v + kFmaWarps * R);
  float* blk_v = reinterpret_cast<float*>(warp_i + kFmaWarps * R);
  int* blk_i = reinterpret_cast<int*>(blk_v + R);

  const int rank = blockIdx.x % S;
  const int row_base = (blockIdx.x / S) * R;
  const int n0 = rank * ns;
  const int nv = max(0, min(ns, N - n0));  // this slice's entries
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float xr[RT][D];  // loaded first: their latency overlaps the slice's
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row_base + lane + 32 * r;
#pragma unroll
    for (int d = 0; d < D; ++d) xr[r][d] = row < T ? x[static_cast<size_t>(row) * D + d] : 0.f;
  }
  // the slice: nv D floats from n0 D on, 16-byte aligned (n0 is a multiple
  // of 8), every chunk's copy in flight at once
  const float* src = cb + static_cast<size_t>(n0) * D;
  for (int i = threadIdx.x; i < nv * KD; i += kFmaThreads)
    cp_async16(e_s + 4 * i, src + 4 * i, true);
  cp_async_wait_all();
  __syncthreads();
  for (int n = threadIdx.x; n < nv; n += kFmaThreads) {
    const float4* e = reinterpret_cast<const float4*>(e_s + n * D);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const float4 v = e[k];
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    esq_s[n] = s;
  }
  __syncthreads();

  float best[RT];
  int best_i[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    best[r] = INFINITY;
    best_i[r] = kNone;
  }
  // entries [base, base + 4) a step, warps interleaved; every lane reads
  // the same entry (a broadcast). Entries past nv are read (ns is a
  // multiple of 8) but score +inf, which is never kept.
  for (int base = warp * kEntryTile; base < nv; base += kFmaWarps * kEntryTile) {
    float acc[RT][kEntryTile];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < kEntryTile; ++j) acc[r][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kEntryTile; ++j) {
      const float4* e = reinterpret_cast<const float4*>(e_s + (base + j) * D);
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const float4 v = e[k];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[r][j] = fmaf(xr[r][4 * k], v.x, acc[r][j]);
          acc[r][j] = fmaf(xr[r][4 * k + 1], v.y, acc[r][j]);
          acc[r][j] = fmaf(xr[r][4 * k + 2], v.z, acc[r][j]);
          acc[r][j] = fmaf(xr[r][4 * k + 3], v.w, acc[r][j]);
        }
      }
    }
    float esq[kEntryTile];
#pragma unroll
    for (int j = 0; j < kEntryTile; ++j) esq[j] = base + j < nv ? esq_s[base + j] : INFINITY;
    const int n = n0 + base;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      keep4(esq[0] - 2.f * acc[r][0], esq[1] - 2.f * acc[r][1], esq[2] - 2.f * acc[r][2],
            esq[3] - 2.f * acc[r][3], n, n + 1, n + 2, n + 3, best[r], best_i[r]);
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    warp_v[warp * R + lane + 32 * r] = best[r];
    warp_i[warp * R + lane + 32 * r] = best_i[r];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kFmaThreads) {
    float v = warp_v[r];
    int idx = warp_i[r];
    for (int w = 1; w < kFmaWarps; ++w) merge(warp_v[w * R + r], warp_i[w * R + r], v, idx);
    blk_v[r] = v;
    blk_i[r] = idx;
  }
  cluster_merge(blk_v, blk_i, R, row_base, T, S, rank, out);
}

// ---- D in {32, 64, 128}: 3xTF32 on the tensor cores.

// wgmma descriptor of a K-major [rows][32 f32] tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), 1024-byte aligned
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint32_t a = smem_addr(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// big: a rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32), its low 13 bits cleared; small = a - big, exact
__device__ __forceinline__ float tf32_big(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
  const float b = tf32_big(a);
  big = __float_as_uint(b);
  small = __float_as_uint(a - b);
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

template <int D>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + 2 * static_cast<size_t>(D / 32) * kTileN * 128 +
         (static_cast<size_t>(64 * kWarpgroups) * (D + 4) + kTileN + 2 * 64 * kWarpgroups) * 4;
}

// Block blockIdx.x takes slice blockIdx.x % S of rows [(blockIdx.x / S) R,
// + R), R = 64 kWarpgroups; NT = kTileN entries a tile. Dynamic shared
// memory (1024-aligned): B big and small [D / 32][NT][32] swizzled, x_s
// [R][D + 4], esq [NT], the block's pairs [R] twice.
template <int D>
__global__ void __launch_bounds__(128 * kWarpgroups)
argmin_wgmma(const float* __restrict__ x, const float* __restrict__ cb, int* __restrict__ out,
             int T, int N, int ns, int S) {
  using Mma = WgmmaTf32<kTileN>;
  constexpr int NT = kTileN;
  constexpr int kSlabs = D / 32;
  constexpr int R = 64 * kWarpgroups;
  constexpr int kThreads = 128 * kWarpgroups;
  constexpr int XS = D + 4;          // x_s row stride, words: 4 mod 32
  constexpr int Q = D / 4;           // 16-byte chunks an entry or a row
  constexpr uint32_t kSlabBytes = NT * 128;
  static_assert(D % 32 == 0 && D <= 128, "D in {32, 64, 128}");
  static_assert((NT * Q) % kThreads == 0, "whole warps of B chunks");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* b_big = base;
  uint8_t* b_small = base + kSlabs * kSlabBytes;
  float* x_s = reinterpret_cast<float*>(b_small + kSlabs * kSlabBytes);
  float* esq_s = x_s + R * XS;
  float* blk_v = esq_s + NT;
  int* blk_i = reinterpret_cast<int*>(blk_v + R);

  const int rank = blockIdx.x % S;
  const int row_base = (blockIdx.x / S) * R;
  const int n0 = rank * ns;
  const int nv = max(0, min(ns, N - n0));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int row0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  float best[2] = {INFINITY, INFINITY};
  int best_i[2] = {kNone, kNone};

  for (int t0 = 0; t0 < nv; t0 += NT) {
    const int tv = min(NT, nv - t0);  // entries of this tile
    __syncthreads();  // the previous tile's B and |e|^2 are consumed
    if (t0 == 0) {  // x rows [row_base, + R), zeros past T
      for (int i = tid; i < R * Q; i += kThreads) {
        const int row = row_base + i / Q;
        cp_async16(x_s + (i / Q) * XS + 4 * (i % Q),
                   row < T ? x + static_cast<size_t>(row) * D + 4 * (i % Q) : x, row < T);
      }
    }
    // B: entry n's chunk c lands in slab c / 8, row n, 16-byte chunk
    // (c % 8) ^ (n % 8); zeros past the tile's entries
    const float* src = cb + static_cast<size_t>(n0 + t0) * D;
    for (int i = tid; i < NT * Q; i += kThreads) {
      const int n = i / Q, c = i % Q;
      cp_async16(b_big + (c / 8) * kSlabBytes + n * 128 + (((c % 8) ^ (n % 8)) * 16),
                 n < tv ? src + 4 * i : cb, n < tv);
    }
    cp_async_wait_all();
    // each thread splits the chunks it copied; a warp covers 32 / Q
    // entries, whose |e|^2 it sums across the Q lanes of each
    for (int i = tid; i < NT * Q; i += kThreads) {
      const int n = i / Q, c = i % Q;
      const uint32_t off = (c / 8) * kSlabBytes + n * 128 + (((c % 8) ^ (n % 8)) * 16);
      const float4 v = *reinterpret_cast<const float4*>(b_big + off);
      const float4 big = make_float4(tf32_big(v.x), tf32_big(v.y), tf32_big(v.z), tf32_big(v.w));
      *reinterpret_cast<float4*>(b_big + off) = big;
      *reinterpret_cast<float4*>(b_small + off) =
          make_float4(v.x - big.x, v.y - big.y, v.z - big.z, v.w - big.w);
      float sq = v.x * v.x;
      sq = fmaf(v.y, v.y, sq);
      sq = fmaf(v.z, v.z, sq);
      sq = fmaf(v.w, v.w, sq);
#pragma unroll
      for (int o = Q / 2; o > 0; o /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      if (c == 0) esq_s[n] = sq;
    }
    // the generic-proxy stores, visible to the tensor cores' async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    float acc[Mma::kRegs];
    uint32_t big[2][4], small[2][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int f = kk & 1, st = kk % 4;
      if (kk >= 2) wgmma_wait<1>();  // step kk - 2 has released set f
      const float* p = x_s + row0 * XS + kk * 8 + q;
      split_tf32(p[0], big[f][0], small[f][0]);
      split_tf32(p[8 * XS], big[f][1], small[f][1]);
      split_tf32(p[4], big[f][2], small[f][2]);
      split_tf32(p[8 * XS + 4], big[f][3], small[f][3]);
      const uint64_t d_big = smem_desc(b_big + (kk / 4) * kSlabBytes) + 2 * st;
      const uint64_t d_small = smem_desc(b_small + (kk / 4) * kSlabBytes) + 2 * st;
      fence_regs(acc);
      wgmma_fence();
      // small terms first; 32 bytes (8 f32 of K) a step along the row
      Mma::mma(acc, small[f], d_big, kk > 0);
      Mma::mma(acc, big[f], d_small, 1);
      Mma::mma(acc, big[f], d_big, 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // acc[i] is row row0 + 8 ((i / 2) % 2), entry 8 (i / 4) + 2 q + i % 2
    // of the tile: per row, entries 8 j + 2 q, + 1, 8 (j + 1) + 2 q, + 1
    // in increasing order
#pragma unroll
    for (int j = 0; j < NT / 8; j += 2) {
      const int n = 8 * j + 2 * q;
      const float e0 = n < tv ? esq_s[n] : INFINITY, e1 = n + 1 < tv ? esq_s[n + 1] : INFINITY;
      const float e2 = n + 8 < tv ? esq_s[n + 8] : INFINITY;
      const float e3 = n + 9 < tv ? esq_s[n + 9] : INFINITY;
      const int g = n0 + t0 + n;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        keep4(e0 - 2.f * acc[4 * j + 2 * h], e1 - 2.f * acc[4 * j + 2 * h + 1],
              e2 - 2.f * acc[4 * j + 4 + 2 * h], e3 - 2.f * acc[4 * j + 5 + 2 * h], g, g + 1,
              g + 8, g + 9, best[h], best_i[h]);
    }
  }

  // the 4 lanes of a row hold interleaved entries: merge by (value, index)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      const float v = __shfl_xor_sync(0xffffffffu, best[h], o);
      const int i = __shfl_xor_sync(0xffffffffu, best_i[h], o);
      merge(v, i, best[h], best_i[h]);
    }
    if (q == 0) {
      blk_v[row0 + 8 * h] = best[h];
      blk_i[row0 + 8 * h] = best_i[h];
    }
  }
  cluster_merge(blk_v, blk_i, R, row_base, T, S, rank, out);
}

// Allow `bytes` of dynamic shared memory to `kernel` on `device`, once:
// setting the attribute is a runtime call, so each (kernel, device) pays
// it at its first launch only.
cudaError_t allow_smem(const void* kernel, int device, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
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

// the device's SM count, read once
int sm_count(int device) {
  static std::mutex mu;
  static int sms[64] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (device < 0 || device >= 64) return 132;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms[device] = 132;
  return sms[device];
}

// one launch of S * tiles blocks in clusters of S
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int S, int tiles, int threads, size_t smem,
                   int device, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), device, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * tiles);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// S: the largest power of two <= kMaxSlices leaving slices of at least
// min_slice entries
int slices(int N, int min_slice) {
  if (kForceSlices > 0) return kForceSlices;
  int S = kMaxSlices;
  while (S > 1 && N / S < min_slice) S /= 2;
  return S;
}

int slice_len(int N, int S) { return ((N + S - 1) / S + 7) / 8 * 8; }

template <int KD, int RT>
cudaError_t launch_fma(const float* x, const float* cb, int* out, int T, int N, int S,
                       int device, cudaStream_t stream) {
  constexpr int R = 32 * RT;
  const int ns = slice_len(N, S);
  const size_t smem = (static_cast<size_t>(ns) * (4 * KD + 1) + 2 * (kFmaWarps + 1) * R) * 4;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return launch(argmin_fma<KD, RT>, S, (T + R - 1) / R, kFmaThreads, smem, device, stream, x, cb,
                out, T, N, ns, S);
}

// slices of >= kMinSlice entries
template <int KD>
cudaError_t plan_fma(const float* x, const float* cb, int* out, int T, int N, int device,
                     cudaStream_t stream) {
  constexpr int RT = KD <= 4 ? kRowsPerLane : 1;  // D > 16: the x row fills the registers
  return launch_fma<KD, RT>(x, cb, out, T, N, slices(N, kMinSlice), device, stream);
}

// slices of one kTileN-entry tile where N allows, halved where that turns
// more than one wave of blocks (one an SM) into one
template <int D>
cudaError_t plan_wgmma(const float* x, const float* cb, int* out, int T, int N, int device,
                       cudaStream_t stream) {
  constexpr int R = 64 * kWarpgroups;
  const int tiles = (T + R - 1) / R;
  int S = slices(N, kTileN);
  const int sms = sm_count(device);
  if (kForceSlices == 0 && S > 1 && S * tiles > sms && S / 2 * tiles <= sms) S /= 2;
  return launch(argmin_wgmma<D>, S, tiles, 128 * kWarpgroups, wgmma_smem_bytes<D>(), device,
                stream, x, cb, out, T, N, slice_len(N, S), S);
}

// D in {32, 64, 128}: the tensor-core form, or with kTensorCores false the
// FMA form (only the form chosen is compiled)
template <int D>
cudaError_t plan_wide(const float* x, const float* cb, int* out, int T, int N, int device,
                      cudaStream_t stream) {
  if constexpr (kTensorCores)
    return plan_wgmma<D>(x, cb, out, T, N, device, stream);
  else
    return plan_fma<D / 4>(x, cb, out, T, N, device, stream);
}

}  // namespace

// x [T, D], cb [N, D] f32 contiguous and 16-byte aligned; out [T] int32.
// D in {4, 8, 12, 16, 32, 64, 128}. Returns the launch's error, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int nc_codebook_argmin_f32(const float* x, const float* cb, int* out, int T, int N,
                                      int D, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T <= 0) return cudaSuccess;
  if (N <= 0 || D <= 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(cb)) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return plan_fma<1>(x, cb, out, T, N, device, st);
    case 8: return plan_fma<2>(x, cb, out, T, N, device, st);
    case 12: return plan_fma<3>(x, cb, out, T, N, device, st);
    case 16: return plan_fma<4>(x, cb, out, T, N, device, st);
    case 32: return plan_wide<32>(x, cb, out, T, N, device, st);
    case 64: return plan_wide<64>(x, cb, out, T, N, device, st);
    case 128: return plan_wide<128>(x, cb, out, T, N, device, st);
    default: return cudaErrorInvalidValue;
  }
}
