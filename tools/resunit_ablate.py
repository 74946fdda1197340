"""Time the residual-unit launches with parts of their work removed.

    python3 tools/resunit_ablate.py [--out ablate.json]

Needs one CUDA card and nvcc. Builds copies of
neuralcodecs_tpu_torch/csrc/resunit.cu into neuralcodecs_tpu_torch/_build/ablate/,
one for each variant, in parallel:

- ``kernel``: the source as it is;
- ``no_mma``: the wgmma instructions taken out, so the GEMM launches only
  load their windows and weight slabs, split the fragments and run their
  epilogues: the time the products would take if they were free;
- ``no_weights``: the weight-slab TMA loads taken out (the products read
  whatever the ring holds): the time without the weights' traffic.

and times each launch of one unit with torch.profiler: of the dense form
(snake_rows, the conv GEMM, the pointwise GEMM) at a few DAC-44k unit
shapes, and of the depthwise form (depthwise_rows, the pointwise GEMM) at
SNAC-24k unit shapes of a 10 s stream. The outputs of the ablated variants
are wrong by design; the script prints the kernel variant's max abs error
against the plain chain. Prints one line per (shape, variant) with each
launch's ms and the pointwise GEMM's rate in TFLOP/s (3xTF32 flops, three
times the f32 products) and, for the depthwise form, the bytes rate of
each launch (x in and y out; y and x in and out out).
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
from neuralcodecs_tpu_torch.ops.kernels.resunit import (  # noqa: E402
    pack_dense_weights,
    pack_pointwise_weights,
    residual_unit_plain,
)

SOURCE = build.CSRC_DIR / "resunit.cu"
OUT_DIR = build.BUILD_DIR / "ablate"
MMAS = ["Mma::mma(part, small[f], d_big + 2 * st, st > 0);",
        "Mma::mma(part, big[f], d_small + 2 * st, 1);",
        "Mma::mma(part, big[f], d_big + 2 * st, 1);"]
WEIGHT_LOADS = """            mbar_expect_tx(full_b + bs, 2 * kTile);
            tma_load_2d(slab, &w_big, s * kSlab, k * C + n0, full_b + bs);
            tma_load_2d(slab + kTile, &w_small, s * kSlab, k * C + n0, full_b + bs);"""
VARIANTS = {
    "kernel": [],
    "no_mma": [(m, "") for m in MMAS],
    "no_weights": [(WEIGHT_LOADS, "            mbar_arrive(full_b + bs);")],
}
# (C, dilation, T, B): DAC-44k units of a 10 s stream, and the server's batch
SHAPES = [(768, 9, 6896, 1), (768, 9, 6896, 4), (384, 1, 55168, 1), (192, 1, 220672, 1),
          (96, 9, 441344, 1)]
# (C, dilation, T, B): SNAC-24k depthwise units of a 10 s stream, each C once
DEPTHWISE_SHAPES = [(48, 9, 241664, 1), (96, 9, 120832, 1), (192, 9, 30208, 1),
                    (384, 9, 3776, 1), (512, 9, 3776, 1), (256, 9, 30208, 1),
                    (128, 9, 120832, 1), (64, 9, 241664, 1)]


def build_variants() -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (OUT_DIR / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared", "-o",
             str(OUT_DIR / f"{name}.so"), str(OUT_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        for entry in ("nc_resunit_dense_f32", "nc_resunit_depthwise_f32"):
            getattr(lib, entry).argtypes = build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the rows here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("resunit_ablate: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(20260816)
    rows = []
    for c, d, t, b in SHAPES:
        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")).contiguous()
        a1, a2 = 1 + rand(1, c, 1, scale=0.3), 1 + rand(1, c, 1, scale=0.3)
        wd, bd = rand(c, c, 7, scale=(7 * c) ** -0.5), rand(c, scale=0.1)
        w1, b1 = rand(c, c, 1, scale=c ** -0.5), rand(c, scale=0.1)
        x = rand(b, c, t)
        packed = pack_dense_weights(wd, w1)
        y, out = torch.empty_like(x), torch.empty_like(x)
        want = residual_unit_plain(x, a1, wd, bd, a2, w1, b1, dilation=d)
        for name, lib in libs.items():
            def run():
                rc = lib.nc_resunit_dense_f32(
                    x.data_ptr(), a1.data_ptr(), packed[0].data_ptr(), packed[1].data_ptr(),
                    bd.data_ptr(), a2.data_ptr(), packed[2].data_ptr(), packed[3].data_ptr(),
                    b1.data_ptr(), y.data_ptr(), out.data_ptr(), b, c, t, d,
                    torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            err = float((out - want).abs().max()) if name == "kernel" else None
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            events = prof.key_averages()

            def ms(*keys):
                return sum(e.self_device_time_total for e in events
                           if all(k in e.key for k in keys)) / 5e3
            row = {"C": c, "dilation": d, "T": t, "B": b, "variant": name,
                   "snake_ms": ms("snake_rows"), "conv_ms": ms("resunit_gemm", "true>"),
                   "pointwise_ms": ms("resunit_gemm", "false>"), "max_abs_err": err}
            flops = 2.0 * t * b * c * c * 3
            rows.append(row)
            print(f"C={c} d={d} T={t} B={b} {name:10s}: snake {row['snake_ms']:.3f} ms, conv "
                  f"{row['conv_ms']:.3f} ms ({7 * flops / row['conv_ms'] / 1e9:.0f} TFLOP/s), "
                  f"pointwise {row['pointwise_ms']:.3f} ms "
                  f"({flops / row['pointwise_ms'] / 1e9:.0f} TFLOP/s)"
                  + (f", max|err| {err:.2e}" if err is not None else ""), flush=True)
    for c, d, t, b in DEPTHWISE_SHAPES:
        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")).contiguous()
        a1, a2 = 1 + rand(1, c, 1, scale=0.3), 1 + rand(1, c, 1, scale=0.3)
        wd, bd = rand(c, 1, 7, scale=7 ** -0.5), rand(c, scale=0.1)
        w1, b1 = rand(c, c, 1, scale=c ** -0.5), rand(c, scale=0.1)
        x = rand(b, c, t)
        w1_big, w1_small = pack_pointwise_weights(w1)
        y, out = torch.empty_like(x), torch.empty_like(x)
        want = residual_unit_plain(x, a1, wd, bd, a2, w1, b1, dilation=d)
        for name, lib in libs.items():
            def run():
                rc = lib.nc_resunit_depthwise_f32(
                    x.data_ptr(), a1.data_ptr(), wd.data_ptr(), bd.data_ptr(), a2.data_ptr(),
                    w1_big.data_ptr(), w1_small.data_ptr(), b1.data_ptr(), y.data_ptr(),
                    out.data_ptr(), b, c, t, d, torch.cuda.current_device(),
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            err = float((out - want).abs().max()) if name == "kernel" else None
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            events = prof.key_averages()

            def ms(*keys):
                return sum(e.self_device_time_total for e in events
                           if all(k in e.key for k in keys)) / 5e3
            row = {"C": c, "dilation": d, "T": t, "B": b, "variant": name, "form": "depthwise",
                   "depthwise_ms": ms("depthwise_rows"),
                   "pointwise_ms": ms("resunit_gemm", "false>"), "max_abs_err": err}
            rows.append(row)
            plane = 4.0 * b * c * t  # bytes of one [B, C, T] tensor
            flops = 2.0 * t * b * c * c * 3
            print(f"depthwise C={c} d={d} T={t} B={b} {name:10s}: depthwise "
                  f"{row['depthwise_ms']:.3f} ms ({2 * plane / row['depthwise_ms'] / 1e6:.0f} GB/s), "
                  f"pointwise {row['pointwise_ms']:.3f} ms "
                  f"({3 * plane / row['pointwise_ms'] / 1e6:.0f} GB/s, "
                  f"{flops / row['pointwise_ms'] / 1e9:.0f} TFLOP/s)"
                  + (f", max|err| {err:.2e}" if err is not None else ""), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi.stdout.strip(), "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
