"""Time the LSTM recurrence kernel with parts of its step removed.

    python3 tools/lstm_ablate.py [--source lstm.cu] [--out ablate.json]

Needs one CUDA card and nvcc. Builds copies of
neuralcodecs_tpu_torch/csrc/lstm.cu (or of ``--source``, for instance the
cooperative-grid kernel of an earlier commit, which keeps the same C entry)
into neuralcodecs_tpu_torch/_build/ablate_lstm/, one for each variant, in
parallel:

- ``kernel``: the source as it is;
- ``no_barrier``: the wait for the other blocks taken out (the handoff's
  poll; the grid barrier in the earlier kernel);
- ``no_h_staging``: h_{t-1} no longer pulled into shared memory;
- ``no_gates_x``: gates_x no longer loaded;
- ``no_dot``: the dot products' multiply-adds taken out;
- ``no_cell``: the cell update and the store of h_t taken out;
- ``handoff_only``: all four of the last removed (and, in this kernel, the
  gates' activations): what is left is the bare handoff a step, so its
  time is the floor T steps cannot beat;
- ``blocks64`` / ``blocks32`` (this kernel only): 8 or 16 hidden units a
  block instead of 4, so H = 512 runs on 64 or 32 blocks.

Every variant but ``kernel`` and the ``blocks`` ones computes a wrong
result by design; the script prints the max abs error of those against the
plain loop. Times are CUDA-event means over 20 warm launches at T = 750,
B = 4, H = 512 (Encodec-24k's SLSTM at the server's batch of 4 x 10 s),
with the step time (ms / T) beside each.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neuralcodecs_tpu_torch.ops.kernels import build  # noqa: E402
from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan_plain  # noqa: E402

SOURCE = build.CSRC_DIR / "lstm.cu"
OUT_DIR = build.BUILD_DIR / "ablate_lstm"
SHAPE = (750, 4, 512)  # T, B, H

# the per-step handoff kernel (csrc/lstm.cu)
_NO_WAIT = ("            while (load_acquire(&g_arrivals) < want) {\n            }\n", "")
_NO_H = (("            bulk_load(h_s, src, static_cast<uint32_t>(nb) * H * 4, &h_bar);\n", ""),
         ("      if (bulk) {\n        mbar_wait(", "      if (false) {\n        mbar_wait("))
_NO_GX = ("        cp_async4(dst + i, gx + (static_cast<size_t>(t) * B + b) * four_h + g * H + u0 + j);",
          "        ;")
_NO_DOT = ("        for (int c = 0; c < NC; ++c) {\n", "        for (int c = 0; c < 0; ++c) {\n")
_NO_CELL = ("        for (int i = lane; i < nb * kUnits; i += 32) {",
            "        for (int i = lane; i < 0; i += 32) {")
_NO_ACT = ("if (lane % (32 / kSums) == 0 && bb < nb", "if (false && bb < nb")
HANDOFF_VARIANTS = {
    "kernel": [],
    "no_barrier": [_NO_WAIT],
    "no_h_staging": [*_NO_H],
    "no_gates_x": [_NO_GX],
    "no_dot": [_NO_DOT],
    "no_cell": [_NO_CELL],
    "handoff_only": [*_NO_H, _NO_GX, _NO_DOT, _NO_CELL, _NO_ACT],
    "blocks64": [("constexpr int kUnits = 4;", "constexpr int kUnits = 8;")],
    "blocks32": [("constexpr int kUnits = 4;", "constexpr int kUnits = 16;")],
}

# the cooperative-grid kernel (csrc/lstm.cu up to 900cb06): one grid.sync()
# a step
_G_NO_H = ("      for (int i = tid; i < BS * H; i += kThreads) {",
           "      for (int i = tid; i < 0; i += kThreads) {")
_G_NO_GX = ("      for (int i = tid; i < R * nb; i += kThreads) {",
            "      for (int i = tid; i < 0; i += kThreads) {")
_G_NO_DOT = ("      for (int lr = warp; lr < R; lr += kWarps) {",
             "      for (int lr = warp; lr < 0; lr += kWarps) {")
_G_NO_CELL = ("      for (int i = tid; i < nb * nu; i += kThreads) {",
              "      for (int i = tid; i < 0; i += kThreads) {")
GRID_SYNC_VARIANTS = {
    "kernel": [],
    "no_barrier": [("    if (t + 1 < T) grid.sync();", "")],
    "no_h_staging": [_G_NO_H],
    "no_gates_x": [_G_NO_GX],
    "no_dot": [_G_NO_DOT],
    "no_cell": [_G_NO_CELL],
    "handoff_only": [_G_NO_H, _G_NO_GX, _G_NO_DOT, _G_NO_CELL],
}


def variants_for(source_text: str) -> dict:
    return GRID_SYNC_VARIANTS if "grid.sync()" in source_text else HANDOFF_VARIANTS


def build_variants(names=None, source: Path = SOURCE) -> dict:
    """{name: ctypes library} of the named variants of ``source`` (all by
    default), compiled in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = source.read_text()
    table = variants_for(src)
    procs = {}
    for name in names or table:
        text = src
        for old, new in table[name]:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (OUT_DIR / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(OUT_DIR / f"{name}.so"),
             str(OUT_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        lib.nc_lstm_scan_f32.argtypes = build._SIGNATURES["nc_lstm_scan_f32"]
        lib.nc_lstm_scan_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, gx, w_hh, h0, c0):
    """A function that runs the library's kernel on these inputs; returns it
    and its outputs (ys, h_f, c_f), written at each call."""
    t, b, four_h = gx.shape
    ys = torch.empty(t, b, four_h // 4, device=gx.device)
    h_f, c_f = torch.empty_like(h0), torch.empty_like(c0)

    def run():
        rc = lib.nc_lstm_scan_f32(gx.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                                  ys.data_ptr(), h_f.data_ptr(), c_f.data_ptr(), t, b,
                                  four_h // 4, torch.cuda.current_device(),
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nc_lstm_scan_f32: CUDA error {rc}")
    return run, (ys, h_f, c_f)


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path, default=SOURCE,
                        help="the lstm.cu to ablate (default: the package's)")
    parser.add_argument("--out", help="write the rows here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("lstm_ablate: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build_variants(source=args.source)
    gen = torch.Generator(device="cuda").manual_seed(20260816)
    t, b, h = SHAPE
    gx = 0.5 * torch.randn(t, b, 4 * h, generator=gen, device="cuda")
    w_hh = (torch.rand(4 * h, h, generator=gen, device="cuda") * 2 - 1) * h ** -0.5
    h0 = 0.1 * torch.randn(b, h, generator=gen, device="cuda")
    c0 = 0.1 * torch.randn(b, h, generator=gen, device="cuda")
    want = lstm_scan_plain(gx, w_hh, h0, c0)
    rows = []
    for name, lib in libs.items():
        run, outs = launcher(lib, gx, w_hh, h0, c0)
        run()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(outs, want))
        ms = time_ms(run)
        rows.append({"variant": name, "T": t, "B": b, "H": h, "ms": ms, "step_us": ms / t * 1e3,
                     "max_abs_err": err})
        print(f"{args.source.name} {name:13s}: {ms:.3f} ms, {ms / t * 1e3:.2f} us a step, "
              f"max|err| {err:.2e}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi.stdout.strip(),
                                              "source": str(args.source), "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
