// Envelope follower (the compressor's core) for Hopper (sm_90a).
//
// Replaces the Pallas kernel neuralcodecs_tpu/ops/pallas/envelope.py
// (envelope_pallas). Along each row of x [N, T], with level = 0 before the
// first sample, it runs for t = 0 .. T-1
//
//   a = |x[t]|;  gain = a > level ? attack : release
//   level = level + gain * (a - level);  env[t] = level
//
// in the order of the scan in neuralcodecs_tpu/dsp/filters.py
// (one_pole_follower), each op rounded on its own: __fsub_rn, __fmul_rn and
// __fadd_rn keep nvcc from contracting the multiply-add into an FMA, so the
// kernel is bit-exact against the plain PyTorch loop, which rounds each op.
// |x| is taken here (exact), not in a separate pass.
//
// What bounds it on the H100: the serial latency of a step (compare,
// select, multiply, add: ~27 cycles measured), T of them back to back; the 8 bytes
// a sample moves are nothing. On the TPU the grid walked time blocks in
// order with the level carried in VMEM scratch; here a block's loop over
// tiles takes the place of the sequential grid axis, the level stays in a
// register, and row_scan.cuh keeps the next tile's loads off the step loop.

#include "row_scan.cuh"

namespace {

struct EnvelopeStep {
  float attack, release, level;

  __device__ __forceinline__ float operator()(float v) {
    const float a = fabsf(v);
    const float gain = a > level ? attack : release;
    level = __fadd_rn(level, __fmul_rn(gain, __fsub_rn(a, level)));
    return level;
  }
};

__global__ void __launch_bounds__(row_scan::kThreads)
envelope_kernel(const float* __restrict__ x, float* __restrict__ env, float attack,
                float release, int N, int T) {
  row_scan::scan_rows(x, env, N, T, EnvelopeStep{attack, release, 0.f});
}

}  // namespace

// x, env [N, T] f32, contiguous, not overlapping; attack and release are the
// f32 gains. Returns cudaGetLastError() after the launch.
extern "C" int nc_envelope_f32(const float* x, float* env, int N, int T, float attack,
                               float release, int device, void* stream) {
  return row_scan::launch(envelope_kernel, N, T, device, stream, x, env, attack, release);
}
