// Decode cross-attention for Hopper (sm_90a): one query position against the
// encoder's K/V cache under a key mask. The design is in decode_attn.cu.

#include "decode_attn.cuh"

namespace {

constexpr int kCrossThreads = 512;

// Grid (head groups, Nkv, B); dynamic shared memory: gb x max(S, warps x
// DH) values of A, the scores and then the warps' partial sums. A row whose
// keys are all masked writes zeros and reads no K or V; else the first
// batch's K and V rows of the live keys are in flight at once (a batch
// holds RPI x NB = 256 keys of 128 bf16), then the scores, the softmax and
// its rounding, then p.v.
template <typename T, int DH>
__global__ void __launch_bounds__(kCrossThreads)
decode_cross_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const uint8_t* __restrict__ mask,
                    long long mask_stride, const int64_t* __restrict__ pos,
                    long long pos_stride, const typename AccOf<T>::type* __restrict__ ts,
                    T* __restrict__ out, int S, int nq, int nkv) {
  using A = typename AccOf<T>::type;
  using R = Rows<T, DH>;
  constexpr int kWarps = kCrossThreads / 32;
  constexpr int RPI = R::RPW * kWarps;
  constexpr int NB = 8 / R::NV;

  __shared__ A qs[kGroup][DH], red_s[kWarps];
  extern __shared__ __align__(16) unsigned char dyn[];
  A* sc = reinterpret_cast<A*>(dyn);                   // [gb][S], then [kWarps][gb][DH]

  const int b = blockIdx.z, h = blockIdx.y, g0 = blockIdx.x * kGroup;
  const int G = nq / nkv, gb = min(kGroup, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % R::LPR, rw = lane / R::LPR;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (long long)b * mask_stride;
  T* ob = out + ((long long)b * nq + h * G + g0) * DH;
  auto row = [&](int it) { return it * RPI + warp * R::RPW + rw; };
  auto live = [&](int r) { return r < S && (mb == nullptr || mb[r] != 0); };

  int any = 0;
  for (int r = tid; r < S; r += kCrossThreads) any |= live(r);
  if (!__syncthreads_or(any)) {                        // every key masked: zeros
    for (int t = tid; t < gb * DH; t += kCrossThreads) ob[t] = narrow<T>(A(0));
    return;
  }
  const long long row_stride = (long long)nkv * DH;
  const long long base = ((long long)b * S * nkv + h) * DH + sub * R::EPL;
  uint4 kraw[NB][R::NV], vraw[NB][R::NV];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int r = row(u);
    if (live(r)) {
      load_raw<T>(k_cache + base + r * row_stride, kraw[u]);
      load_raw<T>(v_cache + base + r * row_stride, vraw[u]);
    }
  }

  const T* heads[kGroup];
  for (int g = 0; g < gb; ++g) heads[g] = q + ((long long)b * nq + h * G + g0 + g) * DH;
  rotate_heads<T, DH, kCrossThreads>(heads, gb, pos[(long long)b * pos_stride], ts, qs,
                                     (T*)nullptr);
  __syncthreads();

  for (int it0 = 0; it0 * RPI < S; it0 += NB) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      if (it0 > 0 && live(r)) load_raw<T>(k_cache + base + r * row_stride, kraw[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      const bool on = live(r);
      A kv[R::EPL];
      if (on) {
        unpack<T>(kraw[u], kv);
      } else {
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) kv[i] = 0;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g >= gb) break;                              // the same in every thread
        A s = 0;
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) s = fma(kv[i], qs[g][sub * R::EPL + i], s);
#pragma unroll
        for (int off = R::LPR / 2; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        if (sub == 0 && r < S) sc[g * S + r] = on ? s : neg_inf<A>();
      }
    }
  }
  __syncthreads();

  // softmax over the block, a head at a time, its weights rounded to T
  for (int g = 0; g < gb; ++g) {
    A* w = sc + g * S;
    A m = neg_inf<A>();
    for (int r = tid; r < S; r += kCrossThreads) m = fmax(m, w[r]);
    m = block_reduce<kWarps>(warp_max(m), red_s, true);
    A l = 0;
    for (int r = tid; r < S; r += kCrossThreads) {
      const A e = exp_(w[r] - m);
      w[r] = e;
      l += e;
    }
    l = block_reduce<kWarps>(warp_sum(l), red_s, false);
    for (int r = tid; r < S; r += kCrossThreads) w[r] = widen(narrow<T>(w[r] / l));
  }
  __syncthreads();

  A acc[kGroup][R::EPL];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int i = 0; i < R::EPL; ++i) acc[g][i] = 0;
  for (int it0 = 0; it0 * RPI < S; it0 += NB) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      if (it0 > 0 && live(r)) load_raw<T>(v_cache + base + r * row_stride, vraw[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = row(it0 + u);
      if (!live(r)) continue;
      A vv[R::EPL];
      unpack<T>(vraw[u], vv);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g < gb) {
          const A p = sc[g * S + r];
#pragma unroll
          for (int i = 0; i < R::EPL; ++i) acc[g][i] = fma(p, vv[i], acc[g][i]);
        }
      }
    }
  }
#pragma unroll
  for (int off = R::LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (g < gb)
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) acc[g][i] += __shfl_xor_sync(kFull, acc[g][i], off);
  __syncthreads();                                     // the scores are read; reuse them
  A* red = sc;
  if (rw == 0) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (g < gb)
#pragma unroll
        for (int i = 0; i < R::EPL; ++i) red[(warp * gb + g) * DH + sub * R::EPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int t = tid; t < gb * DH; t += kCrossThreads) {
    const int g = t / DH, d = t % DH;
    A s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * gb + g) * DH + d];
    ob[t] = narrow<T>(s);
  }
}

template <typename T>
size_t cross_smem(int S, int gb, int dh) {
  const int n = S > (kCrossThreads / 32) * dh ? S : (kCrossThreads / 32) * dh;
  return (size_t)gb * n * sizeof(typename AccOf<T>::type);
}

template <typename T, int DH>
cudaError_t launch_cross(const void* q, const void* k_cache, const void* v_cache,
                         const uint8_t* mask, long long mask_stride, const int64_t* pos,
                         long long pos_stride, const void* ts, void* out, int B, int S, int nq,
                         int nkv, cudaStream_t s) {
  using A = typename AccOf<T>::type;
  const int G = nq / nkv;
  decode_cross_kernel<T, DH><<<dim3((G + kGroup - 1) / kGroup, nkv, B), kCrossThreads,
                               cross_smem<T>(S, G < kGroup ? G : kGroup, DH), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      mask, mask_stride, pos, pos_stride, static_cast<const A*>(ts), static_cast<T*>(out), S,
      nq, nkv);
  return cudaGetLastError();
}

template <typename T, int DH> struct CrossLaunch {
  template <typename... Args> static cudaError_t run(Args... args) {
    return launch_cross<T, DH>(args...);
  }
};

}  // namespace

// q [B, Nq, Dh]; k_cache / v_cache [B, S, Nkv, Dh], all of `dtype`; mask: B
// rows of S bytes (nonzero: attend) `mask_stride` apart, or null (every
// key); pos: B int64 positions `pos_stride` apart; ts [Dh / 2] (f64 for an
// f64 cache, f32 else); out [B, Nq, Dh]. Refuses S whose scores and partial
// sums do not fit 40 KB of shared memory.
extern "C" int nc_decode_attn_cross(int dtype, const void* q, const void* k_cache,
                                    const void* v_cache, const uint8_t* mask,
                                    long long mask_stride, const int64_t* pos,
                                    long long pos_stride, const void* ts, void* out, int B, int S,
                                    int nq, int nkv, int dh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shapes_ok(B, nq, nkv, device) || S <= 0 || nkv > 65535) return cudaErrorInvalidValue;
  const int gb = nq / nkv < kGroup ? nq / nkv : kGroup;
  const size_t smem = dtype == 2 ? cross_smem<double>(S, gb, dh) : cross_smem<float>(S, gb, dh);
  if (smem > 40 * 1024) return cudaErrorInvalidValue;
  return dispatch<CrossLaunch>(dtype, dh, q, k_cache, v_cache, mask, mask_stride, pos,
                               pos_stride, ts, out, B, S, nq, nkv,
                               static_cast<cudaStream_t>(stream));
}
