"""Time the DSP recurrence kernels (envelope follower, biquad cascade) with
parts of their work removed.

    python3 tools/row_scan_ablate.py [--source DIR] [--out ablate.json] [--sass DIR]

Needs one CUDA card and nvcc. Builds copies of
neuralcodecs_tpu_torch/csrc/envelope.cu and biquad.cu into
neuralcodecs_tpu_torch/_build/ablate_rows/, one for each variant, in
parallel, and times each at N = 64, T = 240 000 (the config-4 batch at
24 kHz) by CUDA events over 20 warm launches:

envelope (one serial chain a row):
- ``kernel``: the source as it is;
- ``compare_select``: the step with the gain chosen first (compare, select,
  multiply, add), as before the speculative step;
- ``max_select``: the step taking the larger of the two candidates (the
  same bits when attack >= release, which the config's gains are);
- ``no_waits``: the stepper's wait on each tile's barrier taken out;
- ``tile512`` / ``tile1024`` / ``tile4096``: tiles of 512 samples in a ring
  of 4 (the first build's), of 1024 or 4096 in a ring of 3;
- ``chain_only`` / ``chain_only_compare_select`` / ``chain_only_max_select``:
  the step alone, T times on inputs held in registers, with no loads,
  stores or barriers (4 chains a block, as the kernel): the floor the
  kernel's step form cannot beat; with its cycles a step from clock64;
- ``fadd_chain`` / ``fmul_chain`` / ``dfma_chain``: a chain of T x 8
  dependent f32 adds (f32 multiplies, f64 multiply-adds): the latency of
  one op, in cycles and ns.

biquad cascade (both K-weighting sections, three phases):
- ``kernel``;
- ``end_states_only``, ``carry_only``, ``outputs_only``: one phase alone;
- ``no_waits``: the cp.async waits taken out;
- ``no_copies``: the staging copies and the output stores taken out (the
  tiles hold a constant): the chunks' chains alone;
- ``kernel L=...``: the kernel at other chunk lengths (``--chunks``);
and the kernel's device time by launch (torch.profiler).

``--source DIR`` also builds DIR/envelope.cu and DIR/biquad.cu (with DIR on
the include path) as they are, for instance the serial row-scan kernels of
an earlier commit, which export nc_envelope_f32 and the one-section
nc_biquad_f32 (called twice for the cascade), and times them in the same
call. The ablated variants compute wrong results by design; the script
prints each variant's max abs error against the kernel's own output (and
the kernel's against the plain loop at a short T). ``--sass DIR`` writes the
SASS of the envelope kernels and the chain-only kernels there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neuralcodecs_tpu_torch.dsp import loudness  # noqa: E402
from neuralcodecs_tpu_torch.ops.kernels import biquad as bq  # noqa: E402
from neuralcodecs_tpu_torch.ops.kernels import build  # noqa: E402
from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow_plain  # noqa: E402

OUT_DIR = build.BUILD_DIR / "ablate_rows"
SHAPE = (64, 240_000)  # N, T
SEED = 20260816
K_WEIGHTING = [(loudness._HIGH_SHELF_B, loudness._HIGH_SHELF_A),
               (loudness._HIGH_PASS_B, loudness._HIGH_PASS_A)]

SPECULATIVE = """    const float up = __fadd_rn(level, __fmul_rn(attack, d));
    const float down = __fadd_rn(level, __fmul_rn(release, d));
    level = a > level ? up : down;"""
COMPARE_SELECT = """    const float gain = a > level ? attack : release;
    level = __fadd_rn(level, __fmul_rn(gain, d));"""
MAX_SELECT = """    const float up = __fadd_rn(level, __fmul_rn(attack, d));
    const float down = __fadd_rn(level, __fmul_rn(release, d));
    level = fmaxf(up, down);"""
ENVELOPE_VARIANTS = {
    "kernel": [],
    "compare_select": [(SPECULATIVE, COMPARE_SELECT)],
    "max_select": [(SPECULATIVE, MAX_SELECT)],
    "no_waits": [("      mbar_wait(&full[k % kStages], (k / kStages) & 1);\n", "")],
    "tile512": [("constexpr int kTile = 2048;", "constexpr int kTile = 512;"),
                ("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "tile1024": [("constexpr int kTile = 2048;", "constexpr int kTile = 1024;")],
    "tile4096": [("constexpr int kTile = 2048;", "constexpr int kTile = 4096;")],
}

_END_STATES = """    chunk_end_states<S, kVec><<<blocks_for(static_cast<long long>(N) * (C - 1)), kLanes,
                                kSmemBytes, stream>>>(x, e, cs, N, T, L, C);
"""
_CARRY = "    carry<S><<<N, kLanes, 0, stream>>>(e, s, cs, C);\n"
_OUTPUTS = """  chunk_outputs<S, kVec><<<blocks_for(static_cast<long long>(N) * C), kLanes, kSmemBytes,
                           stream>>>(x, y, s, cs, N, T, L, C);
"""
BIQUAD_VARIANTS = {
    "kernel": [],
    "end_states_only": [(_CARRY, ""), (_OUTPUTS, "")],
    "carry_only": [(_END_STATES, ""), (_OUTPUTS, "")],
    "outputs_only": [(_END_STATES, ""), (_CARRY, "")],
    "no_waits": [("      cp_async_wait<1>();\n", ""), ("      cp_async_wait<0>();\n", "")],
    "no_copies": [("  stage<kVec>(smem, x, ch, 0, lane);\n",
                   "  for (int i = lane; i < 2 * kBufFloats; i += kLanes) smem[i] = 0.25f;\n"),
                  ("      stage<kVec>(smem + ((j + 1) & 1) * kBufFloats, x, ch, j + 1, lane);\n",
                   ""),
                  ("      unstage<kVec>(buf, y, ch, j, lane);\n", "")],
}

# the step alone from registers, and the dependent-op microchains; built
# with envelope.cu so the step is the kernel's own
CHAINS = r"""
#include "envelope.cu"

namespace {

struct CompareSelectStep {
  float attack, release, level;
  __device__ __forceinline__ float operator()(float v) {
    const float a = fabsf(v);
    const float d = __fsub_rn(a, level);
    const float gain = a > level ? attack : release;
    level = __fadd_rn(level, __fmul_rn(gain, d));
    return level;
  }
};

struct MaxSelectStep {
  float attack, release, level;
  __device__ __forceinline__ float operator()(float v) {
    const float a = fabsf(v);
    const float d = __fsub_rn(a, level);
    level = fmaxf(__fadd_rn(level, __fmul_rn(attack, d)), __fadd_rn(level, __fmul_rn(release, d)));
    return level;
  }
};

// T steps a chain, 4 chains a block (lanes 0-3), inputs from registers
template <class Step>
__global__ void chain_only(const float* __restrict__ x, float* __restrict__ out,
                           long long* __restrict__ cycles, float attack, float release, int N,
                           int T) {
  const int row = blockIdx.x * 4 + threadIdx.x;
  if (threadIdx.x >= 4 || row >= N) return;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = x[static_cast<size_t>(row) * T + i];
  Step step{attack, release, 0.f};
  const long long t0 = clock64();
  for (int t = 0; t + 8 <= T; t += 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) step(v[i]);
  }
  const long long t1 = clock64();
  out[row] = step.level;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// n dependent ops (0: f32 add, 1: f32 multiply, 2: f64 fma)
template <int kOp>
__global__ void op_chain(float* __restrict__ out, long long* __restrict__ cycles, float c,
                         int n) {
  float v = out[threadIdx.x];
  double w = v;
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kOp == 0) v = __fadd_rn(v, c);
      if (kOp == 1) v = __fmul_rn(v, c);
      if (kOp == 2) w = fma(w, 1.0 - 1e-9, static_cast<double>(c));
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = kOp == 2 ? static_cast<float>(w) : v;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int nc_chain_only(int form, const float* x, float* out, long long* cycles,
                             float attack, float release, int N, int T) {
  const int blocks = (N + 3) / 4;
  if (form == 0)
    chain_only<EnvelopeStep><<<blocks, 32>>>(x, out, cycles, attack, release, N, T);
  else if (form == 1)
    chain_only<CompareSelectStep><<<blocks, 32>>>(x, out, cycles, attack, release, N, T);
  else
    chain_only<MaxSelectStep><<<blocks, 32>>>(x, out, cycles, attack, release, N, T);
  return cudaGetLastError();
}

extern "C" int nc_op_chain(int op, float* out, long long* cycles, float c, int n) {
  if (op == 0)
    op_chain<0><<<1, 32>>>(out, cycles, c, n);
  else if (op == 1)
    op_chain<1><<<1, 32>>>(out, cycles, c, n);
  else
    op_chain<2><<<1, 32>>>(out, cycles, c, n);
  return cudaGetLastError();
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PARENT_BIQUAD = [_P, _P, _I, _I] + [_F] * 5 + [_I, _P]


def _compile(sources: dict, include: Path) -> dict:
    """{name: ctypes library} for {name: .cu text}, compiled in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT_DIR / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(include), "-shared", "-o",
             str(OUT_DIR / f"{name}.so"), str(OUT_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        (OUT_DIR / f"{name}.log").write_text(log)
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    return libs


def ptxas_report(name: str) -> list[str]:
    """ptxas's per-function lines (registers, stack, spills) of a variant's build."""
    lines = (OUT_DIR / f"{name}.log").read_text().splitlines()
    return [ln.strip() for ln in lines if "Function properties" in ln or "registers" in ln
            or "stack frame" in ln]


def _variants(source: Path, table: dict, prefix: str) -> dict:
    src = source.read_text()
    out = {}
    for name, edits in table.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{prefix}{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        out[prefix + name] = text
    return out


def _chain_signatures(lib) -> None:
    lib.nc_chain_only.argtypes = [_I, _P, _P, _P, _F, _F, _I, _I]
    lib.nc_op_chain.argtypes = [_I, _P, _P, _F, _I]


def build_chains() -> ctypes.CDLL:
    """The chain-only and op-chain kernels alone."""
    lib = _compile({"chains": CHAINS}, build.CSRC_DIR)["chains"]
    _chain_signatures(lib)
    return lib


def chain_floor(lib, x: torch.Tensor, gains, form: int = 0) -> tuple[float, float]:
    """(ms, cycles a step) of the envelope step alone over x's shape (form 0:
    the kernel's step, 1: compare-select, 2: max-select); inputs from
    registers, T rounded down to whole groups of 8."""
    n, t = x.shape
    cyc = torch.zeros((n + 3) // 4, dtype=torch.int64, device=x.device)
    last = torch.empty(n, device=x.device)
    ms = time_ms(lambda: _rc(lib.nc_chain_only(form, x.data_ptr(), last.data_ptr(),
                                               cyc.data_ptr(), *gains, n, t), "nc_chain_only"))
    return ms, float(cyc.double().mean()) / max(t - t % 8, 1)


def build_all(parent: Path | None = None) -> dict:
    sources = {**_variants(build.CSRC_DIR / "envelope.cu", ENVELOPE_VARIANTS, "envelope_"),
               **_variants(build.CSRC_DIR / "biquad.cu", BIQUAD_VARIANTS, "biquad_"),
               "chains": CHAINS}
    libs = _compile(sources, build.CSRC_DIR)
    if parent is not None:
        libs.update({f"parent_{k}": v for k, v in _compile(
            {"envelope": (parent / "envelope.cu").read_text(),
             "biquad": (parent / "biquad.cu").read_text()}, parent).items()})
    for name, lib in libs.items():
        if name.startswith(("envelope_", "parent_envelope")):
            lib.nc_envelope_f32.argtypes = build._SIGNATURES["nc_envelope_f32"]
        elif name == "parent_biquad":
            lib.nc_biquad_f32.argtypes = _PARENT_BIQUAD
        elif name.startswith("biquad_"):
            lib.nc_biquad_cascade_f32.argtypes = build._SIGNATURES["nc_biquad_cascade_f32"]
        else:
            _chain_signatures(lib)
    return libs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(run, calls: int = 10) -> dict:
    """{kernel name: device us a call} of run() by torch.profiler: the
    launches' own time, without the host's."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def _rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _stream() -> tuple[int, int]:
    return torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream


def envelope_runner(lib, x, out, gains):
    n, t = x.shape
    return lambda: _rc(lib.nc_envelope_f32(x.data_ptr(), out.data_ptr(), n, t, *gains,
                                           *_stream()), "nc_envelope_f32")


def cascade_runner(lib, x, y, sections, chunk: int = bq.CHUNK):
    """The new kernel's C entry, with its scratch (as the wrapper makes it)."""
    n, t = x.shape
    coefs = bq.section_coefs(sections)
    c, d = -(-t // chunk), 2 * len(coefs)
    e = torch.empty(max(n * (c - 1) * d, 1), dtype=torch.float64, device=x.device)
    s = torch.empty(n * c * d, device=x.device)
    flat = [v for sec in coefs for v in sec]
    coef_arr = (ctypes.c_float * len(flat))(*flat)
    phi_arr = (ctypes.c_double * (d * d))(*bq.cascade_phi(sections, chunk).ravel())
    return lambda: _rc(lib.nc_biquad_cascade_f32(
        x.data_ptr(), y.data_ptr(), e.data_ptr(), s.data_ptr(), n, t, chunk, len(coefs),
        coef_arr, phi_arr, *_stream()), "nc_biquad_cascade_f32")


def parent_cascade_runner(lib, x, y, sections):
    """The earlier one-section kernel, once a section (through a scratch)."""
    n, t = x.shape
    mid = torch.empty_like(x)
    coefs = bq.section_coefs(sections)

    def run():
        src = x
        for i, c in enumerate(coefs):
            dst = y if i == len(coefs) - 1 else mid
            _rc(lib.nc_biquad_f32(src.data_ptr(), dst.data_ptr(), n, t, *c, *_stream()),
                "nc_biquad_f32")
            src = dst
    return run


def _sass(lib_path: Path, out: Path, names: tuple[str, ...]) -> dict:
    """Write the SASS of the functions whose name holds one of ``names``;
    return the count of each opcode on their chains' critical ops."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out.mkdir(parents=True, exist_ok=True)
    keep, counts, current = [], {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            current = fn if any(n in fn for n in names) else None
            if current:
                counts[current] = {}
        if current:
            keep.append(line)
            for op in ("FSETP", "FSEL", "FMNMX", "FADD", "FMUL", "FFMA", "SEL"):
                if f" {op}" in line:
                    counts[current][op] = counts[current].get(op, 0) + 1
    (out / f"{lib_path.stem}.sass").write_text("\n".join(keep))
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path,
                        help="a directory with an earlier envelope.cu and biquad.cu to time too")
    parser.add_argument("--out", help="write the rows here (JSON)")
    parser.add_argument("--sass", type=Path, help="write the envelope kernels' SASS here")
    parser.add_argument("--chunks", type=lambda v: [int(c) for c in v.split(",")],
                        default=[256, 512, 2048],
                        help="other chunk lengths L to time the biquad kernel at")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("row_scan_ablate: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    libs = build_all(args.source)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, t = SHAPE
    x = 0.25 * torch.randn(n, t, generator=gen, device="cuda")
    gains = (1.0 - math.exp(-1.0 / 120), 1.0 - math.exp(-1.0 / 1200))  # the compressor's at 24 kHz
    gains = tuple(float(torch.tensor(g, dtype=torch.float32)) for g in gains)
    rows = []

    def record(kernel, variant, ms, err, **extra):
        rows.append({"kernel": kernel, "variant": variant, "N": n, "T": t, "ms": ms,
                     "ns_per_step": ms / t * 1e6, "max_abs_err": err, **extra})
        more = "".join(f", {k} {v:.3f}" for k, v in extra.items())
        print(f"{kernel} {variant:28s}: {ms:.4f} ms ({ms / t * 1e6:.3f} ns a step), "
              f"max|err| vs kernel {err:.2e}{more}", flush=True)

    # ---- envelope: full kernels
    xs = x[:4, :2048].contiguous()
    env_short = torch.empty_like(xs)
    envelope_runner(libs["envelope_kernel"], xs, env_short, gains)()
    exact = torch.equal(env_short, envelope_follow_plain(xs, *gains))
    print(f"envelope kernel vs plain loop at 4 x 2048: bit-exact {exact}", flush=True)
    ref = torch.empty_like(x)
    envelope_runner(libs["envelope_kernel"], x, ref, gains)()
    names = [k for k in libs if k.startswith("envelope_")] + (
        ["parent_envelope"] if args.source else [])
    for name in names:
        out = torch.empty_like(x)
        run = envelope_runner(libs[name], x, out, gains)
        run()
        torch.cuda.synchronize()
        record("envelope", name.removeprefix("envelope_"), time_ms(run),
               float((out - ref).abs().max()))

    # ---- envelope: the step alone, and the op latencies
    chains = libs["chains"]
    for form, label in enumerate(("chain_only", "chain_only_compare_select",
                                  "chain_only_max_select")):
        ms, cycles = chain_floor(chains, x, gains, form)
        record("envelope", label, ms, float("nan"), cycles_per_step=cycles,
               ghz=cycles * (t - t % 8) / (ms * 1e6))
    op_out = torch.ones(32, device="cuda")
    op_cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    for op, label in enumerate(("fadd_chain", "fmul_chain", "dfma_chain")):
        ops = 8 * t
        c = 1.0 if op == 1 else 1e-7
        run = lambda op=op, c=c: _rc(chains.nc_op_chain(op, op_out.data_ptr(),  # noqa: E731
                                                        op_cyc.data_ptr(), c, ops), "nc_op_chain")
        ms = time_ms(run)
        cycles = float(op_cyc.double()[0])
        rows.append({"kernel": "op", "variant": label, "ops": ops, "ms": ms,
                     "cycles_per_op": cycles / ops, "ns_per_op": ms * 1e6 / ops})
        print(f"op {label:31s}: {ms:.4f} ms for {ops} dependent ops: {cycles / ops:.3f} cycles, "
              f"{ms * 1e6 / ops:.3f} ns an op", flush=True)

    # ---- biquad cascade
    ys = torch.empty_like(xs)
    cascade_runner(libs["biquad_kernel"], xs, ys, K_WEIGHTING)()
    want = bq.biquad_cascade_chunked(xs, K_WEIGHTING)
    print(f"biquad kernel vs its CPU-order emulation at 4 x 2048: max|err| "
          f"{float((ys - want).abs().max()):.2e}", flush=True)
    ref = torch.empty_like(x)
    cascade_runner(libs["biquad_kernel"], x, ref, K_WEIGHTING)()
    names = [k for k in libs if k.startswith("biquad_")] + (
        ["parent_biquad"] if args.source else [])
    for name in names:
        y = torch.empty_like(x)
        runner = parent_cascade_runner if name == "parent_biquad" else cascade_runner
        run = runner(libs[name], x, y, K_WEIGHTING)
        run()
        torch.cuda.synchronize()
        record("biquad", name.removeprefix("biquad_"), time_ms(run),
               float((y - ref).abs().max()))
    for name, us in device_times(cascade_runner(libs["biquad_kernel"], x, torch.empty_like(x),
                                                 K_WEIGHTING)).items():
        rows.append({"kernel": "biquad", "variant": f"device {name}", "us": us})
        print(f"biquad device time (torch.profiler) {name[:60]}: {us:.2f} us a call", flush=True)
    for chunk in args.chunks:
        y = torch.empty_like(x)
        run = cascade_runner(libs["biquad_kernel"], x, y, K_WEIGHTING, chunk)
        run()
        torch.cuda.synchronize()
        record("biquad", f"kernel L={chunk}", time_ms(run), float((y - ref).abs().max()))

    for name in ("envelope_kernel", "biquad_kernel"):
        for ln in ptxas_report(name):
            print(f"ptxas {name}: {ln}")
    sass = {}
    if args.sass:
        for name in ("envelope_kernel", "envelope_compare_select", "chains", "biquad_kernel"):
            sass[name] = _sass(OUT_DIR / f"{name}.so", args.sass,
                               ("envelope", "chain_only", "carry"))
            for fn, counts in sass[name].items():
                print(f"sass {name}: {fn[:70]}: {counts}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows, "sass": sass},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
