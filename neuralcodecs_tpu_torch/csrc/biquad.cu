// Direct-form-II-transposed biquad (the BS.1770 K-weighting stages) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/biquad.py
// (biquad_pallas). Along each row of x [N, T], with z1 = z2 = 0 before the
// first sample, it runs for t = 0 .. T-1
//
//   y = b0 x + z1;  z1 = b1 x - a1 y + z2;  z2 = b2 x - a2 y;  out[t] = y
//
// left to right as the scan in neuralcodecs_tpu/dsp/filters.py (biquad)
// writes it, each op rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn:
// no FMA contraction), so the kernel is bit-exact against the plain
// PyTorch loop. The coefficients are runtime f32 arguments, a0 taken as 1.
//
// What bounds it on the H100: the serial latency of a step. The chain
// y -> a1 y -> z1 -> next y is four dependent ops (~25 cycles measured); b x and the
// z2 update hang off it in parallel. As in envelope.cu, the tiles of
// row_scan.cuh keep device memory off the step loop.

#include "row_scan.cuh"

namespace {

struct BiquadStep {
  float b0, b1, b2, a1, a2, z1, z2;

  __device__ __forceinline__ float operator()(float v) {
    const float y = __fadd_rn(__fmul_rn(b0, v), z1);
    const float z1n = __fadd_rn(__fsub_rn(__fmul_rn(b1, v), __fmul_rn(a1, y)), z2);
    z2 = __fsub_rn(__fmul_rn(b2, v), __fmul_rn(a2, y));
    z1 = z1n;
    return y;
  }
};

__global__ void __launch_bounds__(row_scan::kThreads)
biquad_kernel(const float* __restrict__ x, float* __restrict__ y, float b0, float b1, float b2,
              float a1, float a2, int N, int T) {
  row_scan::scan_rows(x, y, N, T, BiquadStep{b0, b1, b2, a1, a2, 0.f, 0.f});
}

}  // namespace

// x, y [N, T] f32, contiguous, not overlapping; b0 .. a2 the f32
// coefficients (a0 == 1). Returns cudaGetLastError() after the launch.
extern "C" int nc_biquad_f32(const float* x, float* y, int N, int T, float b0, float b1,
                             float b2, float a1, float a2, int device, void* stream) {
  return row_scan::launch(biquad_kernel, N, T, device, stream, x, y, b0, b1, b2, a1, a2);
}
