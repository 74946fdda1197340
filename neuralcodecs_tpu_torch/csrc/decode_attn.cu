// Decode attention for Hopper (sm_90a): Dia's self and cross attention at
// one query position, reading the K/V cache where it lies. This file holds
// the design and the self kernel; decode_attn_cross.cu the cross kernel, and
// decode_attn.cuh what the two share.
//
// Replaces no Pallas kernel: the JAX package leaves decode attention to XLA
// (neuralcodecs_tpu/models/dia/layers.py, _blocked_decode_attn and
// sdpa_gqa inside the jitted loop). The port's plain form of the same step
// (ops/kernels/decode_attn.py: apply_rope, the slot write, the blocked or
// full read) is some 80 small launches a layer: casts of the bf16 cache to
// f32, copies for einsum's permutes, a product and a dozen reductions.
//
// Two entry points.
//
// Self (nc_decode_attn_self): q [B, Nq, Dh] and the new k, v [B, Nkv, Dh]
// (the projections' outputs), the cache k, v [B, maxT, Nkv, Dh], the
// position of each row and the step index, both int64 on the device. The
// kernel rotates q and k (RoPE, split-half), writes k and v into slot
// `step`, and attends over slots 0..step: q.k scores, the running max, sum
// and weighted sum in f32 (f64 for an f64 cache), v widened for p.v, the
// output rounded to the cache's type: _blocked_decode_attn's arithmetic,
// reading only the live slots (those past `step` weigh exactly 0 there).
// The slot count comes from the device, so one captured graph is right at
// every step.
//
// Cross (nc_decode_attn_cross): q [B, Nq, Dh] at one position against the
// encoder's cache k, v [B, S, Nkv, Dh] under a key mask [B, S]: sdpa_gqa's
// arithmetic, scores and softmax in f32, the weights rounded to the cache's
// type, p.v summed in f32 and rounded; a row whose keys are all masked gives
// zeros (sdpa_gqa's nan_to_num), bit for bit.
//
// RoPE is apply_rope's: the angle position / timescale by a rounded
// division (__fdiv_rn), precise sinf / cosf (no fast-math intrinsics), each
// product and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn: no
// FMA contraction), then rounded to the cache's type, as PyTorch's separate
// kernels round them; in the f64 mode the angle, sin and cos are f64, as
// they are there.
//
// What bounds it on the H100: bytes. At Dia's shapes (8 rows, 16 query and
// 4 K/V heads of 128, bf16) the self cache holds 16 KB a slot over all rows
// and heads, 8.4 MB at step 511; the cross cache (16 heads, 256 keys) 16.8
// MB; a query row meets each K/V vector with 4 query heads (1 in cross),
// 2 flops a byte, far below the card's ~295. So the design moves each byte
// once, 16 bytes a lane, and keeps CUDA cores (no wgmma) for the products:
// - a K/V row of 128 bf16 is 16 lanes' 16-byte loads; a warp takes two rows
//   at once. Each lane issues the loads of all its rows of K and V (4 of
//   each in self-attention at Dia's shapes, 8 in cross-attention) before
//   anything else, and uses them after its prologue (RoPE, the slot write),
//   whose inputs are in flight at the same time: one round trip to device
//   memory, not one a row. A lane's partial dot goes through log2(16)
//   shuffles. One load of a K or V vector serves every query head of its
//   group. What a block spends beyond that is mostly its chain of dependent
//   arithmetic, shuffles and barriers (at step 60, 8.6 of its 10 us with the
//   loads removed; PERF.md).
// - self: the slots split into chunks of kChunk = 64, one block a (row, K/V
//   head, chunk), flash-decoding style: 256 live blocks at step 511, so the
//   card is full from the first steps on. Blocks past the live slots exit at
//   once. Each lane keeps a running softmax over its rows (max, sum and
//   weighted sum, rescaled once a batch of rows); the lanes and warps merge
//   theirs, and each live block writes its chunk's (max, sum, weighted sum);
//   the last block of a (row, head) to finish merges them, in chunk order,
//   so the result does not depend on the order blocks ran. It knows it is
//   last from an arrival counter in device memory (one a row and head, for
//   the life of the library), which it sets back to zero: nothing of a
//   launch is kept on the host, so launches can be captured and replayed,
//   and no memset node precedes each (one cost 2.3 us a launch on the H100).
//   Launches on one device must not overlap; the port issues them on
//   torch's current stream. A one-chunk step skips the merge.
// - the block whose chunk holds `step` takes slot `step`'s k and v from
//   shared memory (the values it writes) and no block reads that slot from
//   device memory, so the write needs no ordering against the reads.
// - cross: one block of 512 threads a (row, K/V head), all S keys in one
//   batch up to 256 keys: the weights need the softmax's sum before they are
//   rounded, so the scores go through shared memory. Masked keys are not
//   loaded, and a row with every key masked (the CFG batch's unconditional
//   rows, half of them) writes its zeros and exits.
// - a block takes at most kGroup = 4 query heads of a group; larger groups
//   run in several blocks, each reading the group's K/V again.

#include "decode_attn.cuh"

namespace {

constexpr int kChunk = 64;          // cache slots a block of the self kernel
constexpr int kMaxChunks = 64;      // chunks a buffer at most: 4096 slots
constexpr int kMergeBatch = 8;      // chunks' partial sums in flight in the merge
constexpr int kMaxCounters = 4096;  // (row, K/V head, head group)s of a self launch at most
constexpr int kSelfThreads = 256;

// the self kernel's arrival counters, one a (row, K/V head, head group),
// zero between launches: the last block to arrive sets its counter back
__device__ unsigned g_counters[kMaxCounters];

// A lane's running softmax over the rows it has seen, for each of a block's
// query heads: max m, sum l of exp(score - m), acc the weighted sum of v
// over the lane's EPL dims.
template <typename A, int EPL> struct Running {
  A m[kGroup], l[kGroup], acc[kGroup][EPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      m[g] = neg_inf<A>();
      l[g] = 0;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[g][i] = 0;
    }
  }

  // fold in (m2, l2, acc2) of other rows of head g
  __device__ __forceinline__ void merge(int g, A m2, A l2, const A (&acc2)[EPL]) {
    const A mx = fmax(m[g], m2);
    if (mx == neg_inf<A>()) return;                    // neither has seen a row
    const A c1 = exp_(m[g] - mx), c2 = exp_(m2 - mx);
    l[g] = l[g] * c1 + l2 * c2;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * c1 + acc2[i] * c2;
    m[g] = mx;
  }
};

// Grid (chunks, Nkv x head groups, B). part [B, Nq, chunks, DH] and ml [B,
// Nq, chunks, 2] hold the chunks' weighted sums and (max, sum); counters
// [B x gridDim.y] are zero at launch. A lane group (LPR lanes) takes a row
// at a time of the chunk; all of a batch's K and V rows are in flight at
// once, the first batch's before the prologue, and the batch folds into the
// lane's running softmax with one rescale.
template <typename T, int DH>
__global__ void __launch_bounds__(kSelfThreads)
decode_self_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, T* __restrict__ k_cache,
                   T* __restrict__ v_cache, const int64_t* __restrict__ pos,
                   long long pos_stride, const int64_t* __restrict__ step_p,
                   const typename AccOf<T>::type* __restrict__ ts, T* __restrict__ out,
                   typename AccOf<T>::type* __restrict__ part,
                   typename AccOf<T>::type* __restrict__ ml, int max_t, int nq, int nkv) {
  using A = typename AccOf<T>::type;
  using R = Rows<T, DH>;
  constexpr int kWarps = kSelfThreads / 32;
  constexpr int RPI = R::RPW * kWarps;                 // rows a block at once
  constexpr int NIT = kChunk / RPI > 0 ? kChunk / RPI : 1;
  constexpr int NB = NIT < 8 / R::NV ? NIT : 8 / R::NV;  // rows in flight a lane
  static_assert(NIT % NB == 0, "batches");

  // the rotated query heads, the rotated new k (row gb) and the new v (row
  // kGroup + 1)
  __shared__ A qs[kGroup + 2][DH];
  __shared__ A red_m[kWarps][kGroup], red_l[kWarps][kGroup], red[kWarps][kGroup][DH];
  __shared__ A w_s[kGroup][kMaxChunks], l_s[kGroup][kMaxChunks], m_s[kGroup];
  __shared__ bool last_s;

  const int64_t step = *step_p;
  const int last = step < 0 ? 0 : (step >= max_t ? max_t - 1 : (int)step);
  const bool fresh = step == last;                     // slot `last` is this step's
  const int n_chunks = last / kChunk + 1;
  const int c = blockIdx.x;
  if (c >= n_chunks) return;
  const int b = blockIdx.z, gy = gridDim.y / nkv;
  const int h = blockIdx.y / gy, g0 = (blockIdx.y % gy) * kGroup;
  const int G = nq / nkv, gb = min(kGroup, G - g0);
  const int r0 = c * kChunk, rows = min(kChunk, last + 1 - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % R::LPR, rw = lane / R::LPR;
  const long long row_stride = (long long)nkv * DH;
  const long long base = ((long long)b * max_t * nkv + h) * DH + sub * R::EPL;

  uint4 kraw[NB][R::NV], vraw[NB][R::NV];
  auto row = [&](int it) { return it * RPI + warp * R::RPW + rw; };
  auto in_cache = [&](int r) { return r < rows && !(fresh && r0 + r == last); };
  auto load = [&](int it0) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      if (in_cache(r)) {
        load_raw<T>(k_cache + base + (r0 + r) * row_stride, kraw[u]);
        load_raw<T>(v_cache + base + (r0 + r) * row_stride, vraw[u]);
      }
    }
  };
  load(0);

  const long long slot = (((long long)b * max_t + last) * nkv + h) * DH;
  const bool writer = fresh && g0 == 0 && last / kChunk == c;
  const T* vb = v_new + ((long long)b * nkv + h) * DH;
  T vt[(DH + kSelfThreads - 1) / kSelfThreads];
#pragma unroll
  for (int k = 0; k * kSelfThreads < DH; ++k)
    if (tid + k * kSelfThreads < DH) vt[k] = vb[tid + k * kSelfThreads];
  const T* heads[kGroup + 1];
  for (int g = 0; g < gb; ++g) heads[g] = q + ((long long)b * nq + h * G + g0 + g) * DH;
  heads[gb] = k_new + ((long long)b * nkv + h) * DH;
  rotate_heads<T, DH, kSelfThreads>(heads, gb + 1, pos[(long long)b * pos_stride], ts, qs,
                                    writer ? k_cache + slot : nullptr);
#pragma unroll
  for (int k = 0; k * kSelfThreads < DH; ++k) {
    const int i = tid + k * kSelfThreads;
    if (i < DH) {
      qs[kGroup + 1][i] = widen(vt[k]);
      if (writer) v_cache[slot + i] = vt[k];
    }
  }
  __syncthreads();

  Running<A, R::EPL> run;
  run.init();
#pragma unroll
  for (int it0 = 0; it0 < NIT; it0 += NB) {
    if (it0 > 0) load(it0);
    // the batch's scores, a head at a time
    A sc[NB][kGroup];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      A kv[R::EPL];
      if (in_cache(r)) {
        unpack<T>(kraw[u], kv);
      } else {
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) kv[i] = r < rows ? qs[gb][sub * R::EPL + i] : A(0);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        sc[u][g] = neg_inf<A>();
        if (g >= gb) continue;                           // the same in every thread
        A s = 0;
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) s = fma(kv[i], qs[g][sub * R::EPL + i], s);
#pragma unroll
        for (int off = R::LPR / 2; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        if (r < rows) sc[u][g] = s;
      }
    }
    // fold the batch into the running softmax: one rescale, then p.v
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      A mx = run.m[g];
#pragma unroll
      for (int u = 0; u < NB; ++u) mx = fmax(mx, sc[u][g]);
      const A corr = run.m[g] == neg_inf<A>() ? A(0) : exp_(run.m[g] - mx);
      run.l[g] *= corr;
#pragma unroll
      for (int i = 0; i < R::EPL; ++i) run.acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        sc[u][g] = sc[u][g] == neg_inf<A>() ? A(0) : exp_(sc[u][g] - mx);
        run.l[g] += sc[u][g];
      }
      run.m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      if (r >= rows) continue;
      A vv[R::EPL];
      if (in_cache(r)) {
        unpack<T>(vraw[u], vv);
      } else {
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) vv[i] = qs[kGroup + 1][sub * R::EPL + i];
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) run.acc[g][i] = fma(sc[u][g], vv[i], run.acc[g][i]);
    }
  }

  // the warp's row groups, then the warps
#pragma unroll
  for (int off = R::LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g >= gb) break;                                // the same in every thread
      const A m2 = __shfl_xor_sync(kFull, run.m[g], off);
      const A l2 = __shfl_xor_sync(kFull, run.l[g], off);
      A acc2[R::EPL];
#pragma unroll
      for (int i = 0; i < R::EPL; ++i) acc2[i] = __shfl_xor_sync(kFull, run.acc[g][i], off);
      run.merge(g, m2, l2, acc2);
    }
  }
  if (rw == 0) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < gb) {
        if (sub == 0) {
          red_m[warp][g] = run.m[g];
          red_l[warp][g] = run.l[g];
        }
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) red[warp][g][sub * R::EPL + i] = run.acc[g][i];
      }
    }
  }
  __syncthreads();

  // each head's max over the warps, the warps' weights in red_m, its sum
  if (tid < gb) {
    const int g = tid;
    A m = neg_inf<A>(), l = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmax(m, red_m[w][g]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const A e = red_m[w][g] == neg_inf<A>() ? A(0) : exp_(red_m[w][g] - m);
      l += red_l[w][g] * e;
      red_m[w][g] = e;
    }
    m_s[g] = m;
    l_s[g][0] = l;
  }
  __syncthreads();
  const int cap = gridDim.x;
  for (int t = tid; t < gb * DH; t += kSelfThreads) {
    const int g = t / DH, d = t % DH;
    A s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][g][d] * red_m[w][g];
    const long long hq = (long long)b * nq + h * G + g0 + g;
    if (n_chunks == 1) {
      out[hq * DH + d] = narrow<T>(s / fmax(l_s[g][0], A(1e-30)));
    } else {
      part[(hq * cap + c) * DH + d] = s;
      if (d == 0) {
        ml[(hq * cap + c) * 2] = m_s[g];
        ml[(hq * cap + c) * 2 + 1] = l_s[g][0];
      }
    }
  }
  if (n_chunks == 1) return;

  // the last block of this (row, head group) to finish merges the chunks;
  // it sets the counter back to zero for the next launch
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* counter = g_counters + (long long)b * gridDim.y + blockIdx.y;
    last_s = atomicAdd(counter, 1u) == (unsigned)(n_chunks - 1);
    if (last_s) *counter = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every chunk's (max, sum) of the block's heads into shared memory at
  // once, each head's weights exp(max_j - max) there, then the weighted
  // sums, kMergeBatch chunks' partial sums in flight at a time
  for (int t = tid; t < gb * n_chunks; t += kSelfThreads) {
    const int g = t / n_chunks, j = t % n_chunks;
    const long long at = (((long long)b * nq + h * G + g0 + g) * cap + j) * 2;
    w_s[g][j] = __ldcg(ml + at);
    l_s[g][j] = __ldcg(ml + at + 1);
  }
  __syncthreads();
  for (int g = warp; g < gb; g += kWarps) {
    A m = neg_inf<A>();
    for (int j = lane; j < n_chunks; j += 32) m = fmax(m, w_s[g][j]);
    m = warp_max(m);
    A l = 0;
    for (int j = lane; j < n_chunks; j += 32) {
      w_s[g][j] = exp_(w_s[g][j] - m);
      l += l_s[g][j] * w_s[g][j];
    }
    l = warp_sum(l);
    if (lane == 0) red_l[0][g] = l;
  }
  __syncthreads();
  // a thread's (head, dim) items, kMergeBatch chunks of each in flight
  constexpr int NI = (kGroup * DH + kSelfThreads - 1) / kSelfThreads;
  A acc[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) acc[k] = 0;
  for (int j0 = 0; j0 < n_chunks; j0 += kMergeBatch) {
    A v[NI][kMergeBatch];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int t = tid + k * kSelfThreads, g = t / DH, d = t % DH;
      const A* pj = part + ((long long)b * nq + h * G + g0 + g) * cap * DH + d;
#pragma unroll
      for (int jj = 0; jj < kMergeBatch; ++jj)
        v[k][jj] = t < gb * DH && j0 + jj < n_chunks ? __ldcg(pj + (long long)(j0 + jj) * DH)
                                                      : A(0);
    }
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int g = (tid + k * kSelfThreads) / DH;
#pragma unroll
      for (int jj = 0; jj < kMergeBatch; ++jj)
        if (g < gb && j0 + jj < n_chunks) acc[k] += v[k][jj] * w_s[g][j0 + jj];
    }
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int t = tid + k * kSelfThreads, g = t / DH, d = t % DH;
    if (t < gb * DH)
      out[((long long)b * nq + h * G + g0 + g) * DH + d] = narrow<T>(acc[k] / fmax(red_l[0][g], A(1e-30)));
  }
}

template <typename T, int DH>
cudaError_t launch_self(const void* q, const void* k_new, const void* v_new, void* k_cache,
                        void* v_cache, const int64_t* pos, long long pos_stride,
                        const int64_t* step, const void* ts, void* out, void* part, void* ml,
                        int B, int max_t, int nq, int nkv, int chunks, cudaStream_t s) {
  using A = typename AccOf<T>::type;
  const int gy = (nq / nkv + kGroup - 1) / kGroup;
  decode_self_kernel<T, DH><<<dim3(chunks, nkv * gy, B), kSelfThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), pos, pos_stride, step,
      static_cast<const A*>(ts), static_cast<T*>(out), static_cast<A*>(part),
      static_cast<A*>(ml), max_t, nq, nkv);
  return cudaGetLastError();
}

template <typename T, int DH> struct SelfLaunch {
  template <typename... Args> static cudaError_t run(Args... args) {
    return launch_self<T, DH>(args...);
  }
};
}  // namespace

// q [B, Nq, Dh], k_new / v_new [B, Nkv, Dh], k_cache / v_cache [B, maxT, Nkv,
// Dh], all of `dtype`; pos: B int64 positions `pos_stride` apart; step: one
// int64; ts [Dh / 2] (f64 for an f64 cache, f32 else); out [B, Nq, Dh];
// part [B, Nq, chunks, Dh] and ml [B, Nq, chunks, 2] of the accumulation
// type; chunks = ceil(maxT / 64), at most 64. Launches on one device must
// not overlap (they share the arrival counters).
extern "C" int nc_decode_attn_self(int dtype, const void* q, const void* k_new,
                                   const void* v_new, void* k_cache, void* v_cache,
                                   const int64_t* pos, long long pos_stride,
                                   const int64_t* step, const void* ts, void* out, void* part,
                                   void* ml, int B, int max_t, int nq, int nkv, int dh,
                                   int chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shapes_ok(B, nq, nkv, device) || max_t <= 0 || chunks != (max_t + kChunk - 1) / kChunk
      || chunks > kMaxChunks || (long long)B * nkv * ((nq / nkv + kGroup - 1) / kGroup) > kMaxCounters)
    return cudaErrorInvalidValue;
  return dispatch<SelfLaunch>(dtype, dh, q, k_new, v_new, k_cache, v_cache, pos, pos_stride,
                              step, ts, out, part, ml, B, max_t, nq, nkv, chunks,
                              static_cast<cudaStream_t>(stream));
}


