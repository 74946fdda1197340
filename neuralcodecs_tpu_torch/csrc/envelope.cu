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
// (one_pole_follower), each op rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn: no FMA contraction), so the kernel is bit-exact against the
// plain PyTorch loop, which rounds each op. The gain switches on the level
// itself, so the recurrence is not linear: it cannot be cut into chunks
// that run in parallel (a chunked scan would change the function, not just
// its rounding), and it stays one serial chain a row.
//
// What bounds it on the H100: the serial latency of a step, T of them back
// to back; the 8 bytes a sample moves are nothing. The design makes the
// step as short as the arithmetic allows and keeps everything else off it:
// - the step computes both candidates, level + attack d and level +
//   release d with d = a - level, and selects last (EnvelopeStep): the same
//   rounded ops on the same operands as the gain-first form, so the same
//   bits, but the compare runs beside the subtraction and the chain is
//   FADD -> FMUL -> FADD -> select, not compare -> select -> FMUL -> FADD;
// - a block owns kRows = 4 rows, one a lane of warp 0 (the stepper), with
//   the level in a register. Lane 0 of warp 1 (the producer) feeds it by
//   TMA: one cp.async.bulk a row of each tile of kTile samples into a ring
//   of kStages tiles, each completing on its own mbarrier, so the stepper
//   waits only on the tile it needs. Each stepping lane sends its row of a
//   tile back by a bulk store after fence.proxy.async, and frees the slot
//   of the tile before once that store has read it (an mbarrier the
//   producer waits on before it refills the slot). No block barrier, no
//   loader threads.
// Bulk copies need 16-byte aligned addresses and sizes, and a row starts at
// n T 4 bytes: a staged row is shifted by (n T) % 4 floats so that its
// 16-byte groups line up with the device's, the aligned middle of each row
// segment moves by bulk copy, and its ragged head and tail (up to 3 floats
// each) by plain loads and stores. So any N >= 1 and T >= 1, no padding; x
// and env must be 16-byte aligned. On the TPU the grid walked time blocks
// in order with the level carried in VMEM scratch; here the block's loop
// over tiles takes the place of the sequential grid axis.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;                       // chains a block, lanes 0-3 of warp 0
constexpr int kTile = 2048;                    // samples a tile
constexpr int kStages = 3;                     // tiles in the ring
constexpr int kStride = kTile + 8;             // floats a staged row: 16-byte aligned, rows
                                               // 8 banks apart, room for the shift
constexpr int kThreads = 64;                   // warp 0 steps, lane 0 of warp 1 produces
constexpr int kProducer = 32;
constexpr int kSlotFloats = kRows * kStride;
constexpr size_t kSmemBytes = kStages * kSlotFloats * sizeof(float);   // 98 688 B
static_assert(kSmemBytes <= 227 * 1024, "more shared memory than a block can have");

struct EnvelopeStep {
  float attack, release, level;

  __device__ __forceinline__ float operator()(float v) {
    const float a = fabsf(v);
    const float d = __fsub_rn(a, level);
    const float up = __fadd_rn(level, __fmul_rn(attack, d));
    const float down = __fadd_rn(level, __fmul_rn(release, d));
    level = a > level ? up : down;
    return level;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A row's segment of one tile: `len` samples from element g0 of the flat
// signal, staged from float `shift` of its slot row (shift = g0 % 4, so
// the staged groups of 4 line up with the device's 16-byte groups); the
// first `head` and the samples from head + body on move one by one, the
// body of whole groups by bulk copy.
struct Segment {
  long long g0;
  int len, shift, head, body;

  __device__ __forceinline__ Segment(int row, int T, int k) {
    g0 = static_cast<long long>(row) * T + static_cast<long long>(k) * kTile;
    len = min(kTile, T - k * kTile);
    shift = static_cast<int>(g0 & 3);
    head = min(len, (4 - shift) & 3);
    body = (len - head) & ~3;
  }
};

// Runs `step` over a staged segment in place: the head one by one, the
// body as float4s (16-byte aligned), the tail one by one. The body's next
// group of 4 is read before the current one is stepped, so its shared-memory
// latency overlaps the chain instead of adding to it at every group.
template <class Step>
__device__ __forceinline__ void step_segment(float* row, const Segment& sg, Step& step) {
  int i = 0;
  for (; i < sg.head; ++i) row[i] = step(row[i]);
  const int end = sg.head + sg.body;
  if (i < end) {
    float4 cur = *reinterpret_cast<const float4*>(row + i);
#pragma unroll 2
    for (; i + 4 < end; i += 4) {
      const float4 next = *reinterpret_cast<const float4*>(row + i + 4);
      cur.x = step(cur.x);
      cur.y = step(cur.y);
      cur.z = step(cur.z);
      cur.w = step(cur.w);
      *reinterpret_cast<float4*>(row + i) = cur;
      cur = next;
    }
    cur.x = step(cur.x);
    cur.y = step(cur.y);
    cur.z = step(cur.z);
    cur.w = step(cur.w);
    *reinterpret_cast<float4*>(row + i) = cur;
    i += 4;
  }
  for (; i < sg.len; ++i) row[i] = step(row[i]);
}

__global__ void __launch_bounds__(kThreads)
envelope_kernel(const float* __restrict__ x, float* __restrict__ env, float attack,
                float release, int N, int T) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int row0 = blockIdx.x * kRows;
  const int nr = min(kRows, N - row0);
  const int tiles = (T + kTile - 1) / kTile;
  auto row_of = [&](int k, int r) { return smem + (k % kStages) * kSlotFloats + r * kStride; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[i]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&empty[i]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == kProducer) {
    for (int k = 0; k < tiles; ++k) {
      uint64_t* bar = &full[k % kStages];
      if (k >= kStages) mbar_wait(&empty[k % kStages], (k / kStages - 1) & 1);
      fence_proxy_async();
      uint32_t bytes = 0;
      for (int r = 0; r < nr; ++r) {
        const Segment sg(row0 + r, T, k);
        float* dst = row_of(k, r) + sg.shift;
        for (int i = 0; i < sg.head; ++i) dst[i] = x[sg.g0 + i];
        for (int i = sg.head + sg.body; i < sg.len; ++i) dst[i] = x[sg.g0 + i];
        bytes += 4u * sg.body;
      }
      mbar_expect(bar, bytes);
      for (int r = 0; r < nr; ++r) {
        const Segment sg(row0 + r, T, k);
        if (sg.body > 0)
          bulk_load(row_of(k, r) + sg.shift + sg.head, x + sg.g0 + sg.head, 4u * sg.body, bar);
      }
    }
  } else if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    EnvelopeStep step{attack, release, 0.f};
    for (int k = 0; k < tiles; ++k) {
      mbar_wait(&full[k % kStages], (k / kStages) & 1);
      if (lane < nr) {
        const Segment sg(row0 + lane, T, k);
        float* row = row_of(k, lane) + sg.shift;
        step_segment(row, sg, step);
        fence_proxy_async();
        for (int i = 0; i < sg.head; ++i) env[sg.g0 + i] = row[i];
        for (int i = sg.head + sg.body; i < sg.len; ++i) env[sg.g0 + i] = row[i];
        if (sg.body > 0) bulk_store(env + sg.g0 + sg.head, row + sg.head, 4u * sg.body);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // the store of tile k - 1 has read its slot
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      }
      __syncwarp();
      if (lane == 0 && k >= 1) mbar_arrive(&empty[(k - 1) % kStages]);
    }
    if (lane < nr) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

}  // namespace

// x, env [N, T] f32, contiguous, 16-byte aligned, not overlapping; attack
// and release are the f32 gains. Returns cudaGetLastError() after the
// launch.
extern "C" int nc_envelope_f32(const float* x, float* env, int N, int T, float attack,
                               float release, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || T <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(env) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (kSmemBytes > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return attr;
  }
  const int blocks = (N + kRows - 1) / kRows;
  envelope_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, env, attack, release, N, T);
  return cudaGetLastError();
}
