// Decode attention for Hopper (sm_90a): what csrc/decode_attn.cu (the self
// kernel and the design) and csrc/decode_attn_cross.cu share. The two
// kernels build as two sources, side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kGroup = 4;           // query heads a block
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

template <typename T> __device__ __forceinline__ T narrow(typename AccOf<T>::type x);
template <> __device__ __forceinline__ bf16 narrow<bf16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ double narrow<double>(double x) { return x; }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }
__device__ __forceinline__ void sincos_(double x, double* s, double* c) { *s = sin(x); *c = cos(x); }

template <typename A> __device__ __forceinline__ A neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -INFINITY; }
template <> __device__ __forceinline__ double neg_inf<double>() { return -(double)INFINITY; }

template <typename A> __device__ __forceinline__ A warp_max(A v) {
  for (int off = 16; off; off >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
template <typename A> __device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The max (or the sum) over a block of W warps of each warp's value v
// (already reduced over its lanes), in every thread; buf holds W values.
template <int W, typename A>
__device__ __forceinline__ A block_reduce(A v, A* buf, bool is_max) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < W ? buf[lane] : (is_max ? neg_inf<A>() : A(0));
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();
  return v;
}

// How a warp reads rows of Dh values of type T: EPL values a lane (at least
// 16 bytes), LPR lanes a row, RPW rows at once.
template <typename T, int DH> struct Rows {
  static constexpr int EPL = 16 / (int)sizeof(T) > DH / 32 ? 16 / (int)sizeof(T) : DH / 32;
  static constexpr int LPR = DH / EPL;
  static constexpr int RPW = 32 / LPR;
  static constexpr int NV = EPL * (int)sizeof(T) / 16;   // 16-byte loads a lane a row
  static_assert(DH % EPL == 0 && LPR >= 1 && LPR <= 32, "head size");
};

template <typename T, int NV>
__device__ __forceinline__ void load_raw(const T* p, uint4 (&raw)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) raw[v] = __ldg(reinterpret_cast<const uint4*>(p) + v);
}

template <typename T, int EPL, int NV>
__device__ __forceinline__ void unpack(const uint4 (&raw)[NV], typename AccOf<T>::type (&out)[EPL]) {
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < EPL; ++i) out[i] = widen(e[i]);
}

// The rotated pair (a, b) = (x[j], x[j + DH/2]) of a head at angle
// position / timescale: apply_rope's arithmetic, each result rounded to T.
template <typename T, typename A>
__device__ __forceinline__ void rotate_pair(A p, A t, T xa, T xb, T* lo, T* hi) {
  A sn, cs;
  sincos_(div_rn(p, t), &sn, &cs);
  const A a = widen(xa), b = widen(xb);
  *lo = narrow<T>(sub_rn(mul_rn(a, cs), mul_rn(b, sn)));
  *hi = narrow<T>(add_rn(mul_rn(b, cs), mul_rn(a, sn)));
}

// The prologue of a block: its nh heads x[0 .. nh) (the query heads, and
// for the self kernel the new k last), each of DH values of T at one
// position, rotated and rounded to T into dst[h] (widened), all of their
// inputs in flight at once. Where `k_out` is given, the last head's T
// values go there too (the cache slot). NT threads; at most kGroup + 1 heads.
template <typename T, int DH, int NT>
__device__ __forceinline__ void rotate_heads(const T* const* x, int nh, int64_t position,
                                             const typename AccOf<T>::type* ts,
                                             typename AccOf<T>::type (*dst)[DH], T* k_out) {
  using A = typename AccOf<T>::type;
  constexpr int half = DH / 2;
  constexpr int NR = ((kGroup + 1) * half + NT - 1) / NT;
  const A p = (A)__ll2float_rn(position);   // apply_rope's positions cast to f32
  T xa[NR], xb[NR];
  A t[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int i = threadIdx.x + k * NT;
    if (i < nh * half) {
      xa[k] = x[i / half][i % half];
      xb[k] = x[i / half][i % half + half];
      t[k] = ts[i % half];
    }
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int i = threadIdx.x + k * NT, h = i / half, j = i % half;
    if (i < nh * half) {
      T lo, hi;
      rotate_pair(p, t[k], xa[k], xb[k], &lo, &hi);
      dst[h][j] = widen(lo);
      dst[h][j + half] = widen(hi);
      if (k_out != nullptr && h == nh - 1) {
        k_out[j] = lo;
        k_out[j + half] = hi;
      }
    }
  }
}

// dtype: 0 bf16, 1 f32, 2 f64; head sizes 8, 16 and 128 (Dia's and its
// test configurations'; each size is another instance of each kernel, and
// the build's time grows with them)
template <template <typename, int> class F, typename... Args>
cudaError_t dispatch(int dtype, int dh, Args... args) {
#define NC_DH(T)                                           \
  switch (dh) {                                            \
    case 8: return F<T, 8>::run(args...);                  \
    case 16: return F<T, 16>::run(args...);                \
    case 128: return F<T, 128>::run(args...);              \
    default: return cudaErrorInvalidValue;                 \
  }
  switch (dtype) {
    case 0: NC_DH(bf16)
    case 1: NC_DH(float)
    case 2: NC_DH(double)
    default: return cudaErrorInvalidValue;
  }
#undef NC_DH
}

bool shapes_ok(int B, int nq, int nkv, int device) {
  return B > 0 && B <= 65535 && nkv > 0 && nq >= nkv && nq % nkv == 0 && device >= 0;
}

}  // namespace
