"""Time the codebook-argmin kernel with parts of its work removed, at other
slice counts and tile sizes, and beside the kernel it replaced.

    python3 tools/codebook_ablate.py [--source DIR] [--out ablate.json]

Needs one CUDA card and nvcc. Builds copies of
neuralcodecs_tpu_torch/csrc/codebook.cu into
neuralcodecs_tpu_torch/_build/ablate_codebook/, one for each variant, in
parallel, and times each at the main paths' shapes (SNAC 4096 x 8 at a
stream's and the served batch's stage rows, DAC 1024 x 8, Encodec
1024 x 128), by CUDA events over 20 warm calls of the C entry and by
torch.profiler's device time a launch:

- ``kernel``: the source as it is (its own slices S and rows a block);
- ``S1`` / ``S2`` / ``S4`` / ``S8``: that many slices a cluster at every N;
- ``rows1``: 1 row a lane (R = 32, not 64) at D <= 16;
- ``wg1``: one warpgroup a block on the tensor cores (R = 64, not 128);
- ``fma_d128``: D = 128 on f32 FMAs in the same grid instead of 3xTF32
  wgmma;
- ``tile64``: 64-entry wgmma tiles (two a slice at Encodec's 1024 / 8);
- ``no_epilogue``: the scores folded into a sum instead of the running
  minimum, so the products stay live (wrong codes by design);
- ``no_merge``: the cluster merge taken out, block 0 of each cluster
  writing its own slice's minimum (wrong codes by design);
- ``empty``: a launch of one empty block through the same C entry: the
  floor of a call;
- ``baseline`` and its ``baseline_coalesced`` (the staging loop reading
  neighbouring addresses), ``baseline_hoisted`` (the shared-memory
  attribute set once) and ``baseline_both``: tools/codebook_baseline.cu,
  the kernel before the redesign.

``--source DIR`` also builds DIR/codebook.cu as it is (``parent``), for
instance an earlier commit's. Each variant's codes are held against the
plain version: rows that differ, and how many of them lie beyond the
near-tie tolerance (score gap > 1e-5 (1 + |s|)). Last, the host's cost of
each step of the wrapper a call, at SNAC's 472 rows.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neuralcodecs_tpu_torch.ops.kernels import build  # noqa: E402
from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin_plain  # noqa: E402
from neuralcodecs_tpu_torch.ops.vq import l2_normalize  # noqa: E402

SOURCE = build.CSRC_DIR / "codebook.cu"
BASELINE_SOURCE = ROOT / "tools" / "codebook_baseline.cu"
OUT_DIR = build.BUILD_DIR / "ablate_codebook"
SEED = 20260816
# (N, D, T): SNAC's stages of one 10 s stream (118, 472) and of the served
# 4 x 10 s batch (472 / 944 / 1888), DAC's one stream and batch, Encodec-24k's
# 1 s and batch
SHAPES = [(4096, 8, 118), (4096, 8, 472), (4096, 8, 944), (4096, 8, 1888), (1024, 8, 862),
          (1024, 8, 3448), (1024, 128, 75), (1024, 128, 3000)]

_FMA_KEEP = """      keep4(esq[0] - 2.f * acc[r][0], esq[1] - 2.f * acc[r][1], esq[2] - 2.f * acc[r][2],
            esq[3] - 2.f * acc[r][3], n, n + 1, n + 2, n + 3, best[r], best_i[r]);"""
_WGMMA_KEEP = """        keep4(e0 - 2.f * acc[4 * j + 2 * h], e1 - 2.f * acc[4 * j + 2 * h + 1],
              e2 - 2.f * acc[4 * j + 4 + 2 * h], e3 - 2.f * acc[4 * j + 5 + 2 * h], g, g + 1,
              g + 8, g + 9, best[h], best_i[h]);"""
_MERGE = "  cluster_merge(blk_v, blk_i, R, row_base, T, S, rank, out);"
_LOCAL = """  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    if (rank == 0 && row_base + r < T) out[row_base + r] = blk_i[r] == kNone ? 0 : blk_i[r];"""
_SLICES = "constexpr int kForceSlices = 0;"
VARIANTS = {
    "kernel": [],
    **{f"S{s}": [(_SLICES, f"constexpr int kForceSlices = {s};")] for s in (1, 2, 4, 8)},
    "rows1": [("constexpr int kRowsPerLane = 2;", "constexpr int kRowsPerLane = 1;")],
    "wg1": [("constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 1;")],
    "fma_d128": [("constexpr bool kTensorCores = true;", "constexpr bool kTensorCores = false;")],
    "tile64": [("constexpr int kTileN = 128;", "constexpr int kTileN = 64;")],
    "no_epilogue": [(_FMA_KEEP, "      best[r] += acc[r][0] + acc[r][1] + acc[r][2] + acc[r][3];"),
                    (_WGMMA_KEEP, "        best[h] += acc[4 * j + 2 * h] + acc[4 * j + 5 + 2 * h];")],
    "no_merge": [(_MERGE, _LOCAL)],
}

_BASE_STAGING = ("      const int d = i / cn, n = i % cn;", "      const int n = i / D, d = i % D;")
_BASE_ATTR = ("""  err = cudaFuncSetAttribute(codebook_argmin_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;""", """  static size_t allowed = 0;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(codebook_argmin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }""")
BASELINE_VARIANTS = {
    "baseline": [],
    "baseline_coalesced": [_BASE_STAGING],
    "baseline_hoisted": [_BASE_ATTR],
    "baseline_both": [_BASE_STAGING, _BASE_ATTR],
}

EMPTY = r"""
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int nc_codebook_argmin_f32(const float*, const float*, int*, int, int, int,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""


def _edited(source: Path, table: dict) -> dict:
    text = source.read_text()
    out = {}
    for name, edits in table.items():
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"{name}: {source.name} no longer holds {old!r}")
            variant = variant.replace(old, new)
        out[name] = variant
    return out


def compile_all(sources: dict, include: dict | None = None) -> tuple[dict, dict]:
    """({name: ctypes library}, {name: nvcc log of a failed build}) for
    {name: .cu text}, compiled in parallel, each with csrc/ (or its entry of
    ``include``) on the include path; a failed variant is left out."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT_DIR / f"{name}.cu").write_text(text)
        inc = (include or {}).get(name, build.CSRC_DIR)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(inc), "-shared", "-o",
             str(OUT_DIR / f"{name}.so"), str(OUT_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, failed = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (OUT_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed[name] = log
            continue
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        lib.nc_codebook_argmin_f32.argtypes = build._SIGNATURES["nc_codebook_argmin_f32"]
        libs[name] = lib
    return libs, failed


def build_baseline() -> ctypes.CDLL:
    """The kernel before the redesign (tools/codebook_baseline.cu) as it is."""
    libs, failed = compile_all({"baseline": BASELINE_SOURCE.read_text()})
    if failed:
        raise RuntimeError(f"tools/codebook_baseline.cu: nvcc failed\n{failed['baseline']}")
    return libs["baseline"]


def build_all(parent: Path | None = None) -> tuple[dict, dict]:
    sources = {**_edited(SOURCE, VARIANTS), **_edited(BASELINE_SOURCE, BASELINE_VARIANTS),
               "empty": EMPTY}
    if parent is None:
        return compile_all(sources)
    sources["parent"] = (parent / "codebook.cu").read_text()
    return compile_all(sources, {"parent": parent})


def runner(lib, flat: torch.Tensor, cb: torch.Tensor, out: torch.Tensor):
    """A call of the library's C entry on flat, cb into out."""
    t, d = flat.shape
    dev, stream = torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.nc_codebook_argmin_f32(flat.data_ptr(), cb.data_ptr(), out.data_ptr(), t,
                                        cb.shape[0], d, dev, stream)
        if rc != 0:
            raise RuntimeError(f"nc_codebook_argmin_f32: CUDA error {rc}")
    return run


def inputs(gen: torch.Generator, n: int, d: int, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Latents and codebook as the paths give them: l2-normalised at D = 8
    (SNAC's and DAC's lookup), raw at D = 128 (Encodec's)."""
    flat = torch.randn(t, d, generator=gen, device="cuda")
    cb = torch.randn(n, d, generator=gen, device="cuda")
    if d <= 16:
        flat, cb = l2_normalize(flat).contiguous(), l2_normalize(cb).contiguous()
    return flat, cb


def mismatches(flat, cb, got, want) -> tuple[int, int]:
    """(rows whose codes differ, of those the rows whose plain scores differ
    beyond the near-tie tolerance 1e-5 (1 + |s|))."""
    diff = torch.nonzero(got != want).flatten()
    if diff.numel() == 0:
        return 0, 0
    scores = torch.sum(cb * cb, dim=-1)[None, :] - 2.0 * (flat[diff] @ cb.t())
    s_got = scores.gather(1, got[diff].long()[:, None])[:, 0]
    s_want = scores.gather(1, want[diff].long()[:, None])[:, 0]
    beyond = (s_got - s_want).abs() > 1e-5 * (1 + s_want.abs())
    return int(diff.numel()), int(beyond.sum())


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


def device_ms(run, calls: int = 20) -> float:
    """Device time a call of run() by torch.profiler: its launches' own
    time, without the host's."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls / 1e3


def host_costs(flat: torch.Tensor, cb: torch.Tensor, calls: int = 2000) -> dict:
    """µs a call of each host step of the wrapper ``codebook_argmin`` (and
    of the whole wrapper and the bare C entry), by the host clock over
    ``calls`` calls."""
    import time

    from neuralcodecs_tpu_torch.ops.kernels import codebook as wrapper

    out = torch.empty(flat.shape[0], dtype=torch.int32, device=flat.device)
    steps = {
        "input checks": lambda: wrapper._check_inputs(flat, cb),
        "torch.empty": lambda: torch.empty(flat.shape[0], dtype=torch.int32, device=flat.device),
        "device_and_stream": lambda: build.device_and_stream(flat),
        "C entry (launch)": runner(build.load_library(), flat, cb, out),
        "wrapper": lambda: wrapper.codebook_argmin(flat, cb),
    }
    costs = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        costs[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return costs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path,
                        help="a directory with an earlier codebook.cu to time too")
    parser.add_argument("--out", help="write the rows here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("codebook_ablate: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    libs, failed = build_all(args.source)
    for name, log in failed.items():
        print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
    for ln in (OUT_DIR / "kernel.log").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"ptxas kernel: {ln.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for n, d, t in SHAPES:
        flat, cb = inputs(gen, n, d, t)
        want = codebook_argmin_plain(flat, cb)
        plain = time_ms(lambda: codebook_argmin_plain(flat, cb))
        print(f"N={n} D={d} T={t}: plain {plain:.4f} ms", flush=True)
        rows.append({"N": n, "D": d, "T": t, "variant": "plain", "ms": plain,
                     "device_ms": device_ms(lambda: codebook_argmin_plain(flat, cb))})
        for name, lib in libs.items():
            out = torch.full((t,), -1, dtype=torch.int32, device="cuda")
            run = runner(lib, flat, cb, out)
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"  {name:14s}: {exc}", flush=True)
                rows.append({"N": n, "D": d, "T": t, "variant": name, "error": str(exc)})
                continue
            differ, beyond = (t, t) if name == "empty" else mismatches(flat, cb, out, want)
            ms, dev = time_ms(run), device_ms(run)
            rows.append({"N": n, "D": d, "T": t, "variant": name, "ms": ms, "device_ms": dev,
                         "rows_differ": differ, "beyond_near_tie": beyond})
            print(f"  {name:14s}: {ms:.4f} ms a call (events), {dev * 1e3:7.2f} us device; "
                  f"codes differ in {differ} rows, {beyond} beyond the near-tie tolerance",
                  flush=True)
    flat, cb = inputs(gen, *SHAPES[1][:2], SHAPES[1][2])
    host = host_costs(flat, cb)
    print(f"host us a call at N={SHAPES[1][0]} D={SHAPES[1][1]} T={SHAPES[1][2]}: "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows, "host_us": host,
                                              "failed": sorted(failed)}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
