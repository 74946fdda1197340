"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out details.json] [--phases NAME,...]

Builds the port's CUDA kernels from neuralcodecs_tpu_torch/csrc and holds
each against its plain PyTorch version at the shapes its round trips give
it. The served models come from files: SNAC-24k, Encodec-24k and DAC-44k
are seeded, written with save_pretrained and loaded back on the card
through load_snac (with validate=True) / load_encodec / load_dac, state
dicts equal, before any phase uses them; SNAC-24k also loads from a
torch.save file under upstream's key names and gives the same codes; the
Encodec-24k LM comes from the model cache with the network refused; Dia
1.6B loads from a sharded export through load_dia, its vocoder through
Dia.load_dac_model. The codebook kernel is also held beside the kernel it
replaced (tools/codebook_baseline.cu) and by its device time, at every
served shape and with ties across its codebook slices. SNAC-24k: holds the depthwise
residual-unit kernels (a depthwise launch and a tensor-core launch a unit,
3xTF32) against the plain chain at every
unit shape of a 10 s stream, checks the port against the frozen SNAC golden
and against itself on the CPU, then serves a few requests through full-width SNAC-24k
(seeded random weights, loaded from their export). Encodec: reproduces the
frozen raw .ecdc stream,
holds the LSTM recurrence kernel against its plain loop beside the
floor of its per-step handoff, checks full-width Encodec-24k against
itself on the CPU, serves a few
requests through it and times its round trip with the kernels and with
the plain versions, then runs full-width stereo Encodec-48k through its
chunked forward. Encodec streaming: 4 sessions of 10 s as one batch, in
pushes of 1, 8 and 75 hops and one session of ragged client chunks, each
against the full encode (near-ties only) and decode, with the LSTM kernel
at the pushes' shapes from carried state and the codebook kernel at their
row counts. The LM-coded .ecdc path: full-width seeded language models
code Encodec-24k's 4 x 10 s at lm_batch 4 and 1 and Encodec-48k's
segmented stream through the native range coder, losslessly. DSP (BASELINE.json config 4, 64 clips of 10 s): holds
the envelope kernel bit-exact against its plain loop beside the floor of
its step chain, and the biquad-cascade kernel (a chunked scan) against the
exact filter in f64 and bit-exact where T fits one chunk, runs
the resample -> compressor -> mel chain at 44.1 -> 24 kHz against the CPU
and times it with the kernels and with the plain loops, then measures and
normalises the BS.1770 loudness of the resampled batch (also handed over as
a numpy array, which must run on the card). DAC-44k: holds the
dense residual-unit kernels (a snake launch and two tensor-core launches a
unit, 3xTF32) against the plain chain at every unit shape of a 10 s
stream, reproduces the frozen DAC golden and its .dac bytes, checks
full-width DAC-44k against itself on the CPU, then serves a few requests
through it and times its round trip with the kernels and with the plain
versions. Chunked execution (phase_chunked, on the served SNAC-24k and
DAC-44k): kernels 2a and 2b against their plain chains at the windows'
shapes of a chunked 4 x 10 s round trip, chunked against unchunked codes
(equal but for first differences at near ties) and audio (> 55 dB), the
chunked round trips and vocoder decode with the launch counters, and the
A/B of alternating rounds at n = 1 and at JAX's chunk count of the round
trip at 4 x 10 s and 4 x 3 s and of DAC's from_codes decode at Dia's
vocoder shapes. DAC training (phase_dac_train): a seeded full-width DAC-44k with
DACDiscriminator() at its defaults trains on a batch of 8 x 0.5 s from
AudioCropDataset (seeded WAVs, through prefetch) through make_gan_train_step
and make_train_step, under torch.enable_grad(): the first GAN step's six
losses (rtol 1e-4) and every gradient of G and D (per tensor 1e-3 of its
norm) with the kernels against the plain versions from the same weights,
codes that differ only at top-2 gaps < 1e-5, 5-step loss trajectories
under SGD (rtol 1e-3), the AdamW step's time, audio seconds trained a
second, peak memory, launches a step, idle and backward shares by
torch.profiler, the units' kept weight splits equal to fresh ones after 15
in-place AdamW updates, the plain step for scale, the generator-only step with and
without remat (equal gradients), kernel 2b's training form and written-out
backward at the batch's 24 unit shapes beside its inference form, and
kernels 2a, 3, 4 and 5 raising under grad. Its model's seed is the first of
TRAIN_SEEDS where the mel loss's gradient is stable against one ulp of the
output (a stable reference is what the gradient bar needs). Dia: greedy generations from the tiny goldens' weights against the
port on the CPU and against dia_ladder_golden's codes (the int8 KV cache,
blocked read and integer dots); DiaConfig() widths at 2 + 2 layers against
the CPU in f32 and f64; then the full 1.61 B model (seeded, f32) serving 4
requests of 512 tokens through the DAC-44k above, a voice-clone prompt,
generate_stream against its one-shot codes and the int8 serving ladder,
with the decode step's time, launches, bound, syncs and idle share. The
precision modes: Dia 1.6B loaded in bf16 (load_dia(compute_dtype=bf16))
serving 4 requests to 128 tokens and a 1 s voice-clone prompt through the
f32 DAC-44k, the same requests in f32 for scale and the two modes' step in
alternating order, the int8 and int4 ladders at bf16, and the card's bf16
caches and logits at 2 + 2 layers against the f64 port (an fp8-weight
control must fail that check); SNAC-24k, DAC-44k and Encodec-24k loaded in
decoder_dtype=bf16 and compute_dtype=bf16, whose mixed-mode codes must be
the f32 mode's. The parallel phases come last: a world-1 NCCL group and
2 generator steps of DAC-44k through make_train_step's mesh path, bit for
bit the mesh=None step's; then one spawn of 2 ranks sharing the card over
gloo (NCCL refuses two ranks a card), after one-process references: the
DAC-44k GAN step on dp=2 (8 x 0.5 s, 4 crops a rank) against one process
under SGD, timed, with the collectives' share; 2 steps on dp=1 x tp=2
with the weights stored as halves, a checkpoint saved whole and restored
onto the mesh, one more step; SNAC-24k's time-sharded encode of a 60 s
clip at sp=2 against the one-process codes; Dia 1.6B tp=2 in f32 and int4
(teacher-forced logits against the f64 mode within 4 x the one-process
error, a control with the row-parallel sums dropped outside it, greedy
codes up to near-ties); Encodec-24k's latents through kmeans to 1024
entries (kernel 1) and 5 EMA steps on dp=2 against the one-process update
with the plain search. --phases runs only the named phases (the serving,
chunked, DAC training, precision and parallel ones), after the build and the
exports they need, and prints no kernels line. The
real servers then serve the loaded models on 127.0.0.1:0 in background
threads (cli/serve.py's CodecServer, cli/stream_serve.py's
StreamingCodecServer; clients on keep-alive http.client connections and
StreamClient sessions, each in a thread of its own): SNAC-24k (rounds of four
concurrent 10 s /roundtrip requests micro-batched into batch-4 forwards,
/encode, /decode, a 400 and a 413), Encodec-24k over HTTP and TCP on one
device lock at the same time (four streaming sessions beside two /roundtrip
requests, an encode session piped into a decode session, /compress?lm=1 and
/decompress), DAC-44k (/roundtrip, /compress, /decompress) and Dia 1.6B
(four concurrent /tts requests coalesced into one generate, /tts/stream);
every reply equals the direct model call on the card, and each route's
client-side and /metrics latency is printed with the card. Each
served path runs with the launch counters set to 0 just
before it and read just after, and fails unless every kernel of the path
launched as often as the path calls it; the kernels line reports the sum
over those paths, each kernel's time against its plain version at every
shape checked, its bound on the card and, where one PyTorch call computes
the same function, that call's time. torch.profiler passes over the
Encodec-24k and DAC-44k round trips, the DSP chain and the loudness give
device time by kernel and idle share. The compiled step paths: Dia's
decode step, Encodec-24k's steady streaming pushes and the LM step run as
CUDA graphs (ops/graphs.py), each held on the same weights against its
eager form (ops.graphs.graphs_disabled()): Dia's codes for f32 greedy and
sampled, the int8 ladder, bf16 and int4, a stream's segments against its
one-shot codes, an interleaved /tts/stream and /tts each against its solo
codes; the pushes' codes and audio bit for bit at 1, 8 and 75 hops and for
the ragged client; the LM's pdfs bit for bit, and .ecdc streams written
either way decoded the other way; a captured kernel-3 launch replayed after
eager launches of its own. Dia reports ms a step graphed and eager, the
device ms a step from the trace summary (diagnostics/xplane.py), host
launches a step, capture seconds and the state pool's GB. Exits non-zero
at the first failed phase, and at once when no CUDA device is available.
The last line is a JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import queue
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20260816
DEVICE = "cuda"


KERNELS = ("codebook_argmin", "fused_residual_unit", "fused_residual_unit_dense", "lstm_scan",
           "envelope_follow", "biquad_df2t", "decode_self_attn", "decode_cross_attn")
_NO_LAUNCHES = dict.fromkeys(KERNELS, 0)

# H100 SXM peaks (NVIDIA data sheet, at 700 W): f32 outside the tensor cores
# (TF32 is off for cuDNN and cuBLAS on the port's f32 path), dense TF32 on the
# tensor cores (the residual-unit kernels run f32 products there as
# three TF32 passes) and HBM3
F32_FLOPS, TF32_FLOPS, HBM_BYTES_PER_S = 67e12, 495e12, 3.35e12
KERNEL_TAPS = 7  # the residual unit's dilated conv


class PhaseError(RuntimeError):
    pass


def phase(name: str, ok: bool, detail: str) -> None:
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {detail}")


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS) -> dict:
    """The least time the card could take for work of ``flops`` operations
    at ``peak`` per second that must move ``nbytes`` (each input read once,
    each output written once): the larger of the two times, and which one
    sets it."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() per call, from CUDA events."""
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


def _tool(name: str):
    """The module tools/<name>.py (the ablation tools build the kernels'
    floor variants)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _compressor_gains(sample_rate: int) -> tuple[float, float]:
    """The attack and release gains apply_compressor gives its follower."""
    return (1.0 - math.exp(-1.0 / int(0.005 * sample_rate)),
            1.0 - math.exp(-1.0 / int(0.050 * sample_rate)))



# ---------------------------------------------------------------- phase 1


def phase_device() -> dict:
    """The card, and the port's TF32 and bf16 reduction policy as its
    import left it: nothing here sets a flag."""
    from neuralcodecs_tpu_torch.ops.precision import (bf16_reduced_reduction_disabled,
                                                      tf32_disabled)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    print(card, flush=True)
    info = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    phase("device", bool(card) and tf32_disabled() and bf16_reduced_reduction_disabled(),
          f"{info['name']} x{info['count']}, nvidia-smi '{card}', torch {info['torch']} "
          f"cuda {info['cuda']}, tf32 off after import={tf32_disabled()}, bf16 reduced "
          f"reduction off={bf16_reduced_reduction_disabled()}")
    return info


# ---------------------------------------------------------------- phase 2


def phase_build() -> dict:
    """Build the kernels; print ptxas's register and spill report (and any
    wgmma warning) and, for the residual-unit GEMM kernels and the codebook
    kernel's tensor-core form, the count of tensor-core instructions (HGMMA:
    wgmma, HMMA: mma.sync) in their SASS. Fails unless every instantiation
    of the residual unit's GEMM (both forms' pointwise launch, the dense
    form's conv launch) and of the codebook's D = 32 / 64 / 128 form has
    HGMMA instructions."""
    from neuralcodecs_tpu_torch.ops.kernels import build

    t0 = time.time()
    build.load_library()
    seconds = time.time() - t0
    report = [ln.strip() for ln in build.build_log.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln
              or "wgmma" in ln.lower()]
    for ln in report:
        print(f"    ptxas: {ln}")
    sass = build.sass_counts("resunit_gemm")
    cb_sass = build.sass_counts("argmin_wgmma")
    for name, counts in {**sass, **cb_sass}.items():
        print(f"    sass: {name}: {counts}")
    on_tensor_cores = bool(sass) and all(c["HGMMA"] > 0 for c in sass.values())
    cb_on_tensor_cores = bool(cb_sass) and all(c["HGMMA"] > 0 for c in cb_sass.values())
    phase("build", on_tensor_cores and cb_on_tensor_cores,
          f"{[s.name for s in build.sources()]} -> {build.library_path().name} in "
          f"{seconds:.1f} s; HGMMA in each of the {len(sass)} residual-unit GEMM kernels: "
          f"{on_tensor_cores}, in each of the {len(cb_sass)} codebook tensor-core kernels: "
          f"{cb_on_tensor_cores}")
    return {"seconds": seconds, "ptxas": report, "sass": {**sass, **cb_sass}}


# ---------------------------------------------------------------- phase 3


def _plain_scores(flat: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    return torch.sum(cb * cb, dim=-1)[None, :] - 2.0 * (flat @ cb.t())


def _compare_codes(flat, cb, got, want) -> tuple[int, float]:
    """(rows that differ only within the near-tie tolerance, largest score
    gap at a differing row); raises on a real disagreement."""
    diff = torch.nonzero(got != want).flatten()
    if diff.numel() == 0:
        return 0, 0.0
    scores = _plain_scores(flat[diff], cb)
    s_got = scores.gather(1, got[diff].long()[:, None])[:, 0]
    s_want = scores.gather(1, want[diff].long()[:, None])[:, 0]
    gap = (s_got - s_want).abs()
    tol = 1e-5 * (1 + s_want.abs())
    if bool((gap > tol).any()):
        raise PhaseError(f"{int((gap > tol).sum())} rows disagree beyond the near-tie "
                         f"tolerance (max gap {float(gap.max()):.3e})")
    return int(diff.numel()), float(gap.max())


# (N, D, T) of the served 4 x 10 s batches: SNAC-24k's three stages,
# DAC-44k's and Encodec-24k's; kernel 1 should beat the kernel it replaced
# and its plain version at each
CODEBOOK_SERVED = {(4096, 8, 472), (4096, 8, 944), (4096, 8, 1888), (1024, 8, 3448),
                   (1024, 128, 3000)}


def _tie_case(gen: torch.Generator, n: int, d: int, rows: int):
    """16 entries duplicated at the end of the codebook (the last slice; the
    first copies lie in the first), latents equal to the first copies, then
    ``rows`` random latents; l2-normalised at D <= 16, as the lookups give
    them."""
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    base = torch.randn(n - 16, d, generator=gen, device=DEVICE)
    extra = torch.randn(rows, d, generator=gen, device=DEVICE)
    if d <= 16:
        base, extra = l2_normalize(base), l2_normalize(extra)
    return torch.cat([base[:16], extra]).contiguous(), torch.cat([base, base[:16]]).contiguous()


def phase_codebook(gen: torch.Generator) -> dict:
    """Kernel 1 against its plain version at every shape its paths give it:
    SNAC 4096 x 8 at one 10 s stream's stage rows (118/236/472), 1501 and
    the served batch's (472/944/1888); DAC 1024 x 8 at one stream (862) and
    the served batch (3448); Encodec 1024 x 128 at 24k 1 s (75), the 48k
    tail (78), one 48k chunk (150), the 48k two-chunk batch (300), 24k 3 s
    padded to batch 4 (900) and the served batch (3000); then a tie case at
    D = 8 and one at D = 128, each with its duplicated entries in different
    slices. Codes may differ only at near-ties (_compare_codes), and every
    tie must go to the lowest index. Each shape is timed through the wrapper
    (CUDA events over 10 calls, ``ms``), through the kernel's C entry
    (``kernel_ms``) and by its device time (torch.profiler), beside the
    kernel it replaced (tools/codebook_baseline.cu, built here, through its C
    entry and by device time) and the plain version, with its bound at
    the peak of the arithmetic it runs (3xTF32 on the tensor cores for
    D > 16, f32 FMAs otherwise). The kernels line's ms, plain_ms and bound
    are one SNAC stream's three stages, as before; each shape's are in
    ``rows``."""
    from neuralcodecs_tpu_torch.ops.kernels import build
    from neuralcodecs_tpu_torch.ops.kernels.codebook import (
        codebook_argmin, codebook_argmin_plain)

    ablate = _tool("codebook_ablate")
    baseline, lib = ablate.build_baseline(), build.load_library()
    cases = [(4096, 8, t) for t in (118, 236, 472, 944, 1501, 1888)]
    cases += [(1024, 8, t) for t in (862, 3448)]
    cases += [(1024, 128, t) for t in (75, 78, 150, 300, 900, 3000)]
    rows, near, worst, slower = [], 0, 0.0, []
    stream_ms = stream_plain_ms = stream_flops = stream_bytes = 0.0
    for n, d, t in cases:
        flat, cb = ablate.inputs(gen, n, d, t)
        got = codebook_argmin(flat, cb)
        want = codebook_argmin_plain(flat, cb)
        torch.cuda.synchronize()
        k, gap = _compare_codes(flat, cb, got, want)
        near, worst = near + k, max(worst, gap)
        ms = time_ms(lambda: codebook_argmin(flat, cb))
        device_ms = ablate.device_ms(lambda: codebook_argmin(flat, cb))
        kernel_ms = time_ms(ablate.runner(lib, flat, cb, torch.empty_like(got)))
        run_base = ablate.runner(baseline, flat, cb, torch.empty_like(got))
        base_ms, base_device_ms = time_ms(run_base), ablate.device_ms(run_base)
        plain_ms = time_ms(lambda: codebook_argmin_plain(flat, cb))
        flops, nbytes = 2.0 * t * n * d + 2.0 * n * d, 4.0 * (t * d + n * d + t)  # x.e, |e|^2
        b = bound(3 * flops, nbytes, TF32_FLOPS) if d > 16 else bound(flops, nbytes)
        served = (n, d, t) in CODEBOOK_SERVED
        # against the earlier kernel through the same C entry and by device
        # time, against plain through the wrapper
        faster = device_ms < base_device_ms and kernel_ms < base_ms and ms < plain_ms
        if served and not faster:
            slower.append((n, d, t))
        if n == 4096 and t in (118, 236, 472):
            stream_ms += ms
            stream_plain_ms += plain_ms
            stream_flops += flops
            stream_bytes += nbytes
        rows.append({"N": n, "D": d, "T": t, "served": served, "ms": ms, "kernel_ms": kernel_ms,
                     "device_ms": device_ms, "baseline_ms": base_ms,
                     "baseline_device_ms": base_device_ms, "plain_ms": plain_ms, "near_ties": k,
                     **b})
        print(f"    codebook N={n} D={d} T={t}: kernel {ms:.4f} ms (C entry {kernel_ms:.4f}, "
              f"device {device_ms:.4f}), "
              f"baseline {base_ms:.4f} ms (device {base_device_ms:.4f}), plain {plain_ms:.4f} "
              f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{'3xTF32' if d > 16 else 'f32'}); near-tie rows {k}"
              + ("" if not served else "; served shape, faster than the baseline and plain: "
                 + ("yes" if faster else "NO")))

    ties = []
    for n, d in ((4096, 8), (1024, 128)):
        flat, cb = _tie_case(gen, n, d, 301)
        got = codebook_argmin(flat, cb)
        want = codebook_argmin_plain(flat, cb)
        torch.cuda.synchronize()
        ties.append(bool((got[:16].long() == torch.arange(16, device=DEVICE)).all()))
        k, gap = _compare_codes(flat, cb, got, want)
        near, worst = near + k, max(worst, gap)
    phase("codebook kernel vs plain", all(ties),
          f"{len(cases)} shapes + 2 tie cases equal (near-tie rows allowed: {near}, max score "
          f"gap {worst:.2e}); ties across slices -> lowest index at D = 8, 128: {ties}; served "
          f"shapes where the kernel is not faster than the baseline and plain: "
          f"{slower or 'none'}")
    return {"rows": rows, "near_tie_rows": near, "max_abs_err": worst,
            "ms": stream_ms, "plain_ms": stream_plain_ms, "library_ms": None,
            **bound(stream_flops, stream_bytes)}


# ---------------------------------------------------------------- phase 4


def _residual_units(model) -> list:
    from neuralcodecs_tpu_torch.models.layers import ResidualUnit

    return [m for m in model.modules() if isinstance(m, ResidualUnit)]


def _unit_args(unit) -> tuple:
    s1, c1, s2, c2 = unit.block
    return (s1.alpha, c1.weight, c1.bias, s2.alpha, c2.weight, c2.bias)


def _unit_lengths(model, samples: int) -> list[int]:
    """Time length at each residual unit of one round trip, in module order."""
    lengths: list[int] = []
    handles = [u.register_forward_hook(lambda m, inp, out: lengths.append(inp[0].shape[-1]))
               for u in _residual_units(model)]
    try:
        model._forward_fn(torch.zeros(1, 1, samples, device=model.device), None)
    finally:
        for h in handles:
            h.remove()
    return lengths


def _hold_resunits(label: str, cases: list, n_stream: int, gen: torch.Generator) -> dict:
    """Hold fused_residual_unit against the plain chain for each (unit, T, B)
    case, within rtol 1e-4/atol 1e-5; time both. The first ``n_stream``
    cases are one stream's units, whose times and bound are summed, and
    summed again per C (``per_c``, with a flag where the kernel is slower
    than plain). A unit does 2 B T C 7 C/g flops in its dilated conv and
    2 B T C^2 in its C x C pointwise product, and reads x and its weights
    once and writes out once. The kernels run on the tensor cores as three TF32
    passes: the dense form both products, the depthwise form the pointwise
    one (its taps stay f32 FMAs). Their bound counts that work at those
    peaks, with the f32 FMA bound (every flop once at the f32 peak) beside
    it as ``bound_f32_ms``."""
    from neuralcodecs_tpu_torch.ops.kernels.resunit import (
        fused_residual_unit, residual_unit_plain)

    rows, err, bad = [], 0.0, []
    total_ms = total_plain_ms = flops = tc_flops = nbytes = 0.0
    for unit, t, b in cases:
        args = _unit_args(unit)
        c, w_dil = args[0].shape[1], args[1]
        x = torch.randn(b, c, t, generator=gen, device=w_dil.device)
        got = fused_residual_unit(x, *args, dilation=unit.dilation)
        want = residual_unit_plain(x, *args, dilation=unit.dilation)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        close = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
        err = max(err, e)
        if not close:
            bad.append((c, unit.dilation, t, b, e))
        # 20 launches: a mean over 3 read 13-20% above the launches' profiled
        # sum (tools/resunit_ablate.py) at SNAC's long units
        ms = time_ms(lambda: fused_residual_unit(x, *args, dilation=unit.dilation), 20, 3)
        plain_ms = time_ms(lambda: residual_unit_plain(x, *args, dilation=unit.dilation), 20, 3)
        if len(rows) < n_stream:
            total_ms += ms
            total_plain_ms += plain_ms
            bt = b * t
            conv, pointwise = 2.0 * bt * c * KERNEL_TAPS * w_dil.shape[1], 2.0 * bt * c * c
            flops += conv + pointwise
            # in TF32-peak operations: three passes of each product on the
            # tensor cores, the depthwise taps at the f32 rate
            dense = w_dil.shape[1] != 1
            tc_flops += 3 * pointwise + (3 * conv if dense else conv * TF32_FLOPS / F32_FLOPS)
            nbytes += 4.0 * (2 * c * bt + w_dil.numel() + c * c + 4 * c)
        rows.append({"C": c, "dilation": unit.dilation, "T": t, "B": b, "ms": ms,
                     "plain_ms": plain_ms, "max_abs_err": e})
        print(f"    {label} C={c} d={unit.dilation} T={t} B={b}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, max|err| {e:.2e}{'' if close else '  MISMATCH'}")
    per_c: dict[int, list[float]] = {}
    for row in rows[:n_stream]:
        ms = per_c.setdefault(row["C"], [0.0, 0.0])
        ms[0] += row["ms"]
        ms[1] += row["plain_ms"]
    for c, (k, p) in per_c.items():
        print(f"    {label} C={c}, one stream's units: kernel {k:.3f} ms, plain {p:.3f} ms"
              + ("  SLOWER THAN PLAIN" if k > p else ""))
    return {"rows": rows, "max_abs_err": err, "ms": total_ms, "plain_ms": total_plain_ms,
            "library_ms": None, "mismatches": bad,
            "per_c": {c: {"ms": k, "plain_ms": p, "slower": k > p} for c, (k, p) in per_c.items()},
            "bound_f32_ms": bound(flops, nbytes)["bound_ms"],
            **bound(tc_flops, nbytes, TF32_FLOPS)}


def phase_resunit(model, gen: torch.Generator, samples: int) -> dict:
    """The depthwise kernels (a depthwise launch, then the pointwise GEMM on
    the tensor cores, 3xTF32) against the plain chain at every unit shape of
    one SNAC-24k 10 s stream, at a ragged tail at B = 2, and at a
    SNAC-44k-wide unit (C = 768, d = 9) at T % 4 != 0, where the GEMM copies
    its windows with cp.async instead of TMA."""
    from neuralcodecs_tpu_torch.models.layers import ResidualUnit

    units = _residual_units(model)
    cases = [(u, t, 1) for u, t in zip(units, _unit_lengths(model, samples))]
    cases.append((units[0], 1037, 2))  # ragged tail, two streams
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        wide = ResidualUnit(768, dilation=9, groups=768).to(DEVICE)
    cases.append((wide, 6899, 1))
    res = _hold_resunits("resunit", cases, len(units), gen)
    slower = [c for c, r in res["per_c"].items() if r["slower"]]
    phase("resunit kernel vs plain", not res["mismatches"],
          f"{len(cases)} shapes within rtol 1e-4/atol 1e-5 (max|err| {res['max_abs_err']:.2e}); "
          f"one 10 s stream's 24 units: kernel {res['ms']:.2f} ms, plain {res['plain_ms']:.2f} "
          f"ms, bound {res['bound_ms']:.2f} ms ({res['bound_by']}; f32 FMA bound "
          f"{res['bound_f32_ms']:.2f} ms); slower than plain at C = {slower or 'none'}"
          + (f"; mismatches {res['mismatches']}" if res["mismatches"] else ""))
    return res


# ---------------------------------------------------------------- phase 5


def _snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    noise = np.mean((ref - got) ** 2)
    return float(10 * np.log10(np.mean(ref ** 2) / max(noise, 1e-20)))


def _top2_gaps(model, audio) -> list[list[float]]:
    """Per RVQ stage, the gap between the two best plain scores of each row."""
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    a, _ = model._prepare(audio)
    residual = model.encoder(a).float()
    gaps = []
    for vq in model.quantizer.quantizers:
        z = residual
        if vq.stride > 1:
            b, c, t = z.shape
            z = z.reshape(b, c, t // vq.stride, vq.stride).mean(dim=-1)
        z_e = vq.in_proj(z).float().transpose(1, 2).reshape(-1, vq.codebook.weight.shape[1])
        scores = _plain_scores(l2_normalize(z_e), l2_normalize(vq.codebook.weight))
        top2 = torch.topk(scores, 2, dim=-1, largest=False).values
        gaps.append((top2[:, 1] - top2[:, 0]).tolist())
        residual = residual - vq(residual)[0]
    return gaps


def phase_golden() -> None:
    from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

    g = np.load(ROOT / "tests" / "goldens" / "snac_golden.npz")
    cfg = SNACConfig(sampling_rate=44100, encoder_dim=8, encoder_rates=[2, 3, 8, 8],
                     decoder_dim=128, decoder_rates=[8, 8, 3, 2], attn_window_size=8,
                     codebook_size=4096, codebook_dim=8, vq_strides=[8, 4, 2, 1],
                     noise=False, depthwise=True)
    model = SNAC(cfg, device=DEVICE)
    model.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files
                           if k.startswith("sd/")}, strict=True)
    with torch.no_grad():
        audio_hat, codes = model.forward(g["audio"])
    mismatched = []
    for i, c in enumerate(codes):
        ref = g[f"codes/{i}"].astype(np.int32)
        bad = np.nonzero(c.cpu().numpy() != ref)
        if len(bad[0]):
            mismatched.append((i, bad))
    if mismatched:
        with torch.no_grad():
            gaps = _top2_gaps(model, g["audio"])
        for i, bad in mismatched:
            print(f"    golden stage {i}: {len(bad[0])} codes differ, top-2 score gaps "
                  f"{[gaps[i][j] for j in bad[-1]]}")
    ref_audio = g["decoded"][: g["audio"].shape[0]]
    got_audio = audio_hat[0].cpu().numpy()
    close = np.allclose(got_audio, ref_audio, rtol=1e-3, atol=1e-4)
    snr = _snr_db(ref_audio, got_audio)
    phase("golden", not mismatched and close and snr > 55.0,
          f"4 stages bit-exact={not mismatched}, audio within rtol 1e-3/atol 1e-4={close}, "
          f"SNR {snr:.1f} dB (> 55), max|err| {np.abs(got_audio - ref_audio).max():.2e}")


def phase_card_vs_cpu(model) -> None:
    """Full-width SNAC-24k, noise off: the port on the card (kernels) against
    the port on the CPU (plain versions), on 1 s of audio."""
    from neuralcodecs_tpu_torch.models.snac import SNAC

    rng = np.random.default_rng(SEED)
    audio = (0.3 * rng.standard_normal(24000)).astype(np.float32)
    cpu = SNAC(model.config, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        a_gpu, _ = model._prepare(audio)
        out_gpu, codes_gpu = model._forward_fn(a_gpu, None)
        out_cpu, codes_cpu = cpu._forward_fn(a_gpu.cpu(), None)
    same = [bool((cg.cpu() == cc).all()) for cg, cc in zip(codes_gpu, codes_cpu)]
    ref, got = out_cpu.numpy().ravel(), out_gpu.cpu().numpy().ravel()
    snr = _snr_db(ref, got)
    phase("full-width card vs cpu", all(same) and snr > 55.0,
          f"codes equal per stage {same}, SNR {snr:.1f} dB, "
          f"max|err| {np.abs(ref - got).max():.2e}")


# ---------------------------------------------------------------- phase 6


def _snac_rows(model, generator: torch.Generator):
    """SNAC's forward on a stacked batch, split into per-request results."""
    def forward(stacked: np.ndarray) -> list:
        out, codes = model.forward(stacked, generator)
        return [(out[i], [c[i] for c in codes]) for i in range(stacked.shape[0])]
    return forward


def _serve(forward, requests: list[np.ndarray]) -> tuple[list, int]:
    """Answer concurrent requests as the HTTP server does: equal-length
    requests are stacked into one forward, the batch padded to a power of
    two by repeating the last request. ``forward`` maps a stacked [B, T]
    batch to B per-request results. Returns (results, forward calls)."""
    inbox: queue.Queue = queue.Queue()

    def client(x):
        fut: Future = Future()
        inbox.put((x, fut))
        return fut.result(timeout=600)

    results: list = [None] * len(requests)

    def run_client(i):
        results[i] = client(requests[i])

    threads = [threading.Thread(target=run_client, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    items = [inbox.get(timeout=60) for _ in requests]
    forwards = 0
    by_len: dict[int, list] = {}
    for x, fut in items:
        by_len.setdefault(x.shape[-1], []).append((x, fut))
    for group in by_len.values():
        xs = [x for x, _ in group]
        target = 1 << (len(xs) - 1).bit_length()
        rows = forward(np.stack(xs + [xs[-1]] * (target - len(xs))))
        forwards += 1
        for row, (_, fut) in zip(rows, group):
            fut.set_result(row)
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise PhaseError("a client thread did not finish")
    return results, forwards


def _check_result(model, out, codes, n: int) -> None:
    cfg = model.config
    if tuple(out.shape) != (n,) or not bool(torch.isfinite(out).all()):
        raise PhaseError(f"bad audio: shape {tuple(out.shape)}, want ({n},), finite "
                         f"{bool(torch.isfinite(out).all())}")
    frames = model._pad_length(n) // cfg.hop_length
    for c, s in zip(codes, cfg.vq_strides):
        if tuple(c.shape) != (frames // s,) or int(c.min()) < 0 or int(c.max()) >= cfg.codebook_size:
            raise PhaseError(f"bad codes: shape {tuple(c.shape)} range "
                             f"[{int(c.min())}, {int(c.max())}]")


def phase_serve(model, card: str) -> dict:
    from neuralcodecs_tpu_torch.ops import kernels

    sr = model.config.sample_rate
    rng = np.random.default_rng(SEED + 1)
    long_reqs = [(0.3 * rng.standard_normal(10 * sr)).astype(np.float32) for _ in range(4)]
    short_reqs = [(0.3 * rng.standard_normal(3 * sr)).astype(np.float32) for _ in range(3)]
    foreign = (0.3 * rng.standard_normal(44100 * 2)).astype(np.float32)
    gen = torch.Generator(device=model.device).manual_seed(SEED)

    kernels.reset_launch_counts()
    forwards = 0
    forward = _snac_rows(model, gen)
    results, f = _serve(forward, long_reqs)  # cold: one batch-4 forward
    forwards += f
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results, f = _serve(forward, long_reqs)  # warm
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    forwards += f
    warm_ms = start.elapsed_time(end)
    for (out, codes), x in zip(results, long_reqs):
        _check_result(model, out, codes, x.shape[-1])
    short, f = _serve(forward, short_reqs)  # 3 requests padded to batch 4
    forwards += f
    for (out, codes), x in zip(short, short_reqs):
        _check_result(model, out, codes, x.shape[-1])
    resampled = model.process_audio(foreign, 44100)
    forwards += 1
    n_out = int(foreign.shape[-1] * sr / 44100)
    if resampled.shape != (n_out,) or not np.isfinite(resampled).all():
        raise PhaseError(f"process_audio: shape {resampled.shape}, want ({n_out},)")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n_stages, n_units = len(model.config.vq_strides), len(_residual_units(model))
    want = {**_NO_LAUNCHES, "codebook_argmin": n_stages * forwards,
            "fused_residual_unit": n_units * forwards}
    xrt = 40.0 / (warm_ms / 1e3)
    # device time by kernel of the warm batch-4 forward (K0d, one a unit)
    batch = np.stack(long_reqs)
    prof = _device_profile(lambda: model.forward(batch, gen), warm_ms, "depthwise_rows", n_units)
    _print_profile("snac", prof, warm_ms)
    phase("serve", counts == want,
          f"{forwards} forwards (2x 4x10 s batch, 3x3 s padded to 4, process_audio 44.1k); "
          f"launches {counts} == {want}; warm batch-4 10 s round trip {warm_ms:.1f} ms "
          f"(CUDA events; host {wall_s * 1e3:.1f} ms) = {xrt:.1f}x realtime on {card}")
    return {"counts": counts, "forwards": forwards, "warm_ms": warm_ms,
            "host_ms": wall_s * 1e3, "xrt": xrt, "profile": prof}


# ------------------------------------------------------- Encodec phases


# max |err| over ys, h_f and c_f measured 1.5e-7 at these shapes on an
# H100 80GB HBM3 at 700 W (PERF.md, kernel table)
LSTM_TOL = dict(rtol=1e-5, atol=1e-6)


def _slstm(model, which: str):
    from neuralcodecs_tpu_torch.models.encodec.seanet import SLSTM

    return next(m for m in getattr(model, which).modules() if isinstance(m, SLSTM))


def _lstm_captured(w_hh: torch.Tensor, gen: torch.Generator) -> list:
    """Kernel 3 captured into a CUDA graph (ops/graphs.StepGraph), at T = 750
    and T = 1 (B = 4): three replays, each after two eager launches of its
    own, must return and equal the eager launch bit for bit (a launch zeroes
    the handoff counter on its stream, so a replay needs nothing of the
    host). Each row: the eager and the replayed launch's ms (CUDA events),
    and the device µs of a launch's two nodes, the counter's memset and the
    kernel (torch.profiler over 20 eager launches)."""
    from torch.profiler import ProfilerActivity, profile

    from neuralcodecs_tpu_torch.ops.graphs import StepGraph
    from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan

    dev, h, rows = torch.device(DEVICE), w_hh.shape[1], []
    for t in (750, 1):
        gx = 0.5 * torch.randn(t, 4, 4 * h, generator=gen, device=dev)
        h0 = 0.1 * torch.randn(4, h, generator=gen, device=dev)
        c0 = 0.1 * torch.randn(4, h, generator=gen, device=dev)
        launch = functools.partial(lstm_scan, gx, w_hh, h0, c0)
        want = launch()
        graph = StepGraph(launch)
        equal = []
        for _ in range(3):
            launch()
            launch()
            got = graph.replay()
            torch.cuda.synchronize()
            equal.append(all(torch.equal(g, w) for g, w in zip(got, want)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        rows.append({"T": t, "B": 4, "H": h, "replays_equal": equal,
                     "launches_a_replay": graph.launches, "ms": time_ms(launch, 20),
                     "replay_ms": time_ms(graph.replay, 20),
                     "memset_us": sum(e.self_device_time_total for e in events
                                      if "emset" in e.key) / 20,
                     "kernel_us": sum(e.self_device_time_total for e in events
                                      if "lstm" in e.key) / 20})
    return rows


def phase_lstm(model, gen: torch.Generator) -> dict:
    """Kernel 3 against its plain loop at the slice's shapes: the 24 kHz
    4 x 10 s batch and 1 s stream, the 48 kHz chunk batch and tail; and at
    the kernel's edge cases: H = 128 with B = 3 rows of an 8-row tile, B = 96
    at H = 512 (more rows than one pass stages, so each step takes two), and
    H = 518 (the last block owns fewer units than the others); and T = 1
    from a given h0 / c0, as a streaming step calls it. The phase
    fails unless the launch plans show those last two paths taken. Each case
    reports its time a step and ``floor_ms``: the time of the kernel with
    everything but its per-step handoff taken out (tools/lstm_ablate.py's
    handoff_only variant, built here), which T steps cannot beat."""
    from neuralcodecs_tpu_torch.ops.kernels.lstm import (
        lstm_scan, lstm_scan_plain, lstm_scan_plan)

    ablate = _tool("lstm_ablate")
    handoff = ablate.build_variants(["handoff_only"])["handoff_only"]

    dev = torch.device(DEVICE)
    w512 = _slstm(model, "encoder").lstm.weight_hh_l0.detach()
    cases = [("24k 4x10 s", 750, 4, 512), ("24k 1 s", 75, 1, 512),
             ("48k 10 chunks", 150, 10, 512), ("48k tail", 15, 1, 512),
             ("H=128 B=3", 37, 3, 128), ("B=96, two passes a step", 40, 96, 512),
             ("H=518, ragged last block", 50, 2, 518),
             ("T=1 from h0/c0, a streaming step", 1, 2, 512)]
    rows, err, bad = [], 0.0, []
    chunked = ragged = False
    for name, t, b, h in cases:
        u, blocks, bs = lstm_scan_plan(b, h, dev)
        chunked, ragged = chunked or b > bs, ragged or h % u != 0
        w_hh = w512 if h == 512 else (torch.rand(4 * h, h, generator=gen, device=dev)
                                      * 2 - 1) * h ** -0.5
        gx = 0.5 * torch.randn(t, b, 4 * h, generator=gen, device=dev)
        h0 = 0.1 * torch.randn(b, h, generator=gen, device=dev)
        c0 = 0.1 * torch.randn(b, h, generator=gen, device=dev)
        got = lstm_scan(gx, w_hh, h0, c0)
        want = lstm_scan_plain(gx, w_hh, h0, c0)
        torch.cuda.synchronize()
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        close = all(torch.allclose(g, w, **LSTM_TOL) for g, w in zip(got, want))
        err = max(err, e)
        if not close:
            bad.append((name, e))
        ms = time_ms(lambda: lstm_scan(gx, w_hh, h0, c0), 10)
        plain_ms = time_ms(lambda: lstm_scan_plain(gx, w_hh, h0, c0), 3, 1)
        floor_ms = time_ms(ablate.launcher(handoff, gx, w_hh, h0, c0)[0], 10)
        rows.append({"case": name, "T": t, "B": b, "H": h, "U": u, "blocks": blocks, "BS": bs,
                     "ms": ms, "step_us": ms / t * 1e3, "floor_ms": floor_ms,
                     "plain_ms": plain_ms, "max_abs_err": e})
        print(f"    lstm {name}: T={t} B={b} H={h} (U={u}, {blocks} blocks, BS={bs}): "
              f"kernel {ms:.3f} ms ({ms / t * 1e3:.2f} us a step; handoff floor "
              f"{floor_ms:.3f} ms), plain {plain_ms:.3f} ms, "
              f"max|err| {e:.2e}{'' if close else '  MISMATCH'}")
    # the main path's shape (24 kHz 4 x 10 s): the bound of the recurrence
    # (h @ W_hh and the gate arithmetic) and cuDNN's LSTM, which also runs
    # the input projection the kernel is handed precomputed
    t, b, h = cases[0][1:]
    flops = 2.0 * t * b * 4 * h * h + 10.0 * t * b * h
    nbytes = 4.0 * (t * b * 4 * h + 4 * h * h + 4 * b * h + t * b * h)
    lib = torch.nn.LSTM(h, h).to(dev)
    seq = torch.randn(t, b, h, generator=gen, device=dev)
    library_ms = time_ms(lambda: lib(seq), 10)
    captured = _lstm_captured(w512, gen)
    for r in captured:
        print(f"    lstm captured T={r['T']} B=4: 3 replays after eager launches equal "
              f"{r['replays_equal']}; eager {r['ms']:.4f} ms, replay {r['replay_ms']:.4f} ms; "
              f"device: counter memset {r['memset_us']:.2f} us + kernel {r['kernel_us']:.2f} us")
    replays_ok = all(all(r["replays_equal"]) and r["launches_a_replay"] == {"lstm_scan": 1}
                     for r in captured)
    phase("lstm kernel vs plain", not bad and chunked and ragged and replays_ok,
          f"{len(cases)} shapes (ys, h_f, c_f) within rtol 1e-5/atol 1e-6 "
          f"(max|err| {err:.2e}); a case with B > BS: {chunked}, with a ragged last "
          f"block: {ragged}; torch.nn.LSTM (cuDNN, with its input projection) at "
          f"T={t} B={b} H={h}: {library_ms:.3f} ms; the kernel there {rows[0]['ms']:.3f} ms, "
          f"{rows[0]['step_us']:.2f} us a step, handoff floor {rows[0]['floor_ms']:.3f} ms; "
          f"a captured launch replayed after eager ones, bit for bit: {replays_ok}"
          + (f"; mismatches {bad}" if bad else ""))
    return {"rows": rows, "captured": captured, "max_abs_err": err, "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"], "library_ms": library_ms,
            "step_us": rows[0]["step_us"], "floor_ms": rows[0]["floor_ms"],
            **bound(flops, nbytes)}


def _golden_encodec_config():
    """tests/test_encodec.py's tiny_config, the config of ecdc_golden.npz."""
    from neuralcodecs_tpu_torch.models.encodec import EncodecConfig

    return EncodecConfig(sampling_rate=16000, channels=1, bandwidth=80.0,
                         target_bandwidths=[20.0, 80.0], codebook_size=32, codebook_dim=16,
                         hidden_size=16, num_filters=8, num_lstm_layers=2,
                         num_residual_layers=1, upsampling_ratios=[4, 2],
                         use_causal_conv=True, norm_type="weight_norm")


def phase_ecdc_golden() -> None:
    """The port on the card reproduces the frozen raw .ecdc stream byte for
    byte, and decompresses it to the direct decode (the SLSTMs at H = 32)."""
    from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
    from neuralcodecs_tpu_torch.models.encodec import Encodec

    g = np.load(ROOT / "tests" / "goldens" / "ecdc_golden.npz")
    model = Encodec(_golden_encodec_config(), device=DEVICE).eval()
    sd = from_jax_params({k[3:]: g[k] for k in g.files if k.startswith("sd/")},
                         transposed_groups(model))
    model.load_state_dict(sd, strict=True)
    audio = g["audio"]
    blob = model.compress(audio, use_lm=False)
    same = blob == g["blob_raw"].tobytes()
    direct = model.decode(model.encode(audio))[..., : audio.shape[0]]
    out = model.decompress(g["blob_raw"].tobytes())
    close = torch.allclose(out, direct, rtol=1e-5, atol=1e-6)
    phase("ecdc golden", same and close,
          f"compress == blob_raw ({len(blob)} B): {same}; decompress vs direct decode within "
          f"rtol 1e-5/atol 1e-6: {close} (max|err| {float((out - direct).abs().max()):.2e})")


def _encodec_near_ties(model, audio: np.ndarray) -> tuple[int, int]:
    """(rows whose two best plain-L2 scores lie within 1e-5 relative, rows),
    over every RVQ stage of encode(audio)."""
    from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin_plain

    x = model._prepare(audio)
    residual = model.encoder(x).float().transpose(1, 2).reshape(-1, model.config.codebook_dim)
    near = rows = 0
    for layer in model.quantizer.layers[: model._n_q()]:
        embed = layer.codebook.embed
        scores = _plain_scores(residual, embed)
        top2 = torch.topk(scores, 2, dim=-1, largest=False).values
        near += int(((top2[:, 1] - top2[:, 0]) < 1e-5 * top2[:, 0].abs().clamp_min(1e-12)).sum())
        rows += residual.shape[0]
        residual = residual - embed[codebook_argmin_plain(residual, embed).long()]
    return near, rows


def phase_encodec_card_vs_cpu(model) -> None:
    """Full-width Encodec-24k: the port on the card (kernels) against the
    port on the CPU (plain versions), on 1 s of audio."""
    from neuralcodecs_tpu_torch.models.encodec import Encodec

    rng = np.random.default_rng(SEED + 2)
    audio = (0.3 * rng.standard_normal(model.config.sample_rate)).astype(np.float32)
    cpu = Encodec(model.config, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    codes_gpu = model.encode(audio)[0].codes.cpu()
    codes_cpu = cpu.encode(audio)[0].codes
    same = [bool((codes_gpu[:, k] == codes_cpu[:, k]).all()) for k in range(codes_cpu.shape[1])]
    near, rows = _encodec_near_ties(model, audio)
    ref, got = cpu.forward(audio).numpy().ravel(), model.forward(audio).cpu().numpy().ravel()
    snr = _snr_db(ref, got)
    phase("encodec full-width card vs cpu", all(same) and snr > 55.0,
          f"codes equal per stage {same}; near-tie rows (top-2 gap < 1e-5 rel.) {near} of "
          f"{rows}; SNR {snr:.1f} dB (> 55), max|err| {np.abs(ref - got).max():.2e}")


@contextlib.contextmanager
def _plain_kernels():
    """Swap the plain versions in where the codecs call the LSTM, codebook
    and residual-unit kernels, for a kernel-vs-plain timing of the same
    round trip (in grad mode, autograd through the plain chain in place of
    the dense unit's Function)."""
    from neuralcodecs_tpu_torch.models import layers
    from neuralcodecs_tpu_torch.models.encodec import seanet
    from neuralcodecs_tpu_torch.ops import vq
    from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin_plain
    from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan_plain
    from neuralcodecs_tpu_torch.ops.kernels.resunit import residual_unit_plain

    saved = seanet.lstm_scan, vq.codebook_argmin, layers.fused_residual_unit
    seanet.lstm_scan, vq.codebook_argmin = lstm_scan_plain, codebook_argmin_plain
    layers.fused_residual_unit = residual_unit_plain
    try:
        yield
    finally:
        seanet.lstm_scan, vq.codebook_argmin, layers.fused_residual_unit = saved


def _encodec_rows(model):
    def forward(stacked: np.ndarray) -> list:
        out = model.forward(stacked[:, None, :])
        return [out[i, 0] for i in range(stacked.shape[0])]
    return forward


def _timed_roundtrip(model, batch: np.ndarray) -> tuple[float, float]:
    """(ms by CUDA events, peak GB) of one warm forward of ``batch``."""
    model.forward(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model.forward(batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), torch.cuda.max_memory_allocated() / 1e9


def phase_encodec_serve(model, card: str) -> dict:
    from neuralcodecs_tpu_torch.ops import kernels

    sr = model.config.sample_rate
    rng = np.random.default_rng(SEED + 3)
    long_reqs = [(0.3 * rng.standard_normal(10 * sr)).astype(np.float32) for _ in range(4)]
    short_reqs = [(0.3 * rng.standard_normal(3 * sr)).astype(np.float32) for _ in range(3)]
    foreign = (0.3 * rng.standard_normal(16000 * 2)).astype(np.float32)
    n_q = model._n_q()
    forward = _encodec_rows(model)

    kernels.reset_launch_counts()
    results, forwards = _serve(forward, long_reqs)
    for out, x in zip(results, long_reqs):
        if tuple(out.shape) != x.shape or not bool(torch.isfinite(out).all()):
            raise PhaseError(f"bad audio: shape {tuple(out.shape)}, want {x.shape}")
    short, f = _serve(forward, short_reqs)  # 3 requests padded to batch 4
    forwards += f
    for out, x in zip(short, short_reqs):
        if tuple(out.shape) != x.shape or not bool(torch.isfinite(out).all()):
            raise PhaseError(f"bad audio: shape {tuple(out.shape)}, want {x.shape}")
    resampled = model.process_audio(foreign, 16000)
    forwards += 1
    if resampled.shape != (2 * sr,) or not np.isfinite(resampled).all():
        raise PhaseError(f"process_audio: shape {resampled.shape}, want ({2 * sr},)")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {**_NO_LAUNCHES, "codebook_argmin": n_q * forwards, "lstm_scan": 4 * forwards}
    ok = counts == want

    # the warm batch-4 x 10 s round trip, kernels against plain versions, in
    # turns plain, kernel, kernel, plain
    batch = np.stack(long_reqs)[:, None, :]
    times = {"kernel": [], "plain": []}
    peak = {}
    for mode in ("plain", "kernel", "kernel", "plain"):
        if mode == "plain":
            with _plain_kernels():
                ms, gb = _timed_roundtrip(model, batch)
        else:
            ms, gb = _timed_roundtrip(model, batch)
        times[mode].append(ms)
        peak[mode] = gb
    kernel_ms, plain_ms = min(times["kernel"]), min(times["plain"])
    prof = _profile_roundtrip(model, batch, {"kernel": kernel_ms, "plain": plain_ms})
    phase("encodec serve", ok,
          f"{forwards} forwards (4x10 s batch, 3x3 s padded to 4, process_audio 16k); "
          f"launches {counts} == {want}; warm batch-4 10 s round trip (CUDA events) kernels "
          f"{times['kernel']} ms, plain {times['plain']} ms; peak {peak['kernel']:.2f} vs "
          f"{peak['plain']:.2f} GB; {40.0 / (kernel_ms / 1e3):.1f}x realtime on {card}")
    return {"counts": counts, "forwards": forwards, "times_ms": times, "peak_gb": peak,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "profile": prof}


def _device_profile(fn, wall_ms: float, kernel: str | None, launches: int = 0,
                    reps: int = 3) -> dict:
    """torch.profiler (device activity) over ``reps`` warm calls of fn():
    device time per call, its top kernels, and the idle share against the
    unprofiled ``wall_ms`` of one call (the profiler's own host cost would
    inflate a wall time taken under it). A trace without a warm-up step has
    been seen to lose the first call's launches, so one call runs as the
    profiler's warm-up step, and where ``kernel`` is named the trace counts
    as complete only if it holds ``launches`` launches of it per call; an
    incomplete trace keeps neither its device time nor the idle share. With
    no kernel named (a path of plain versions) completeness is not checked
    (None)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
        for _ in range(1 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    seen = sum(e.count for e in events if kernel and kernel in e.key)
    complete = seen == launches * reps if kernel else None
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    return {"complete": complete, "launches_seen": seen, "launches_expected": launches * reps,
            "device_ms": device_ms if complete is not False else None,
            "idle": 1.0 - device_ms / wall_ms if complete is not False else None,
            "top": [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
                    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]]}


def _print_profile(label: str, prof: dict, wall_ms: float) -> None:
    if prof["complete"] is False:
        print(f"    profile {label}: incomplete trace ({prof['launches_seen']} of "
              f"{prof['launches_expected']} launches of the path's kernel), not kept")
        return
    print(f"    profile {label}: device {prof['device_ms']:.2f} ms per call, idle "
          f"{prof['idle']:.1%} of the unprofiled {wall_ms:.2f} ms; top: " + ", ".join(
              f"{k[:40]} {ms:.2f}" for k, ms, _ in prof["top"][:4]))


def _profile_roundtrip(model, batch: np.ndarray, wall_ms: dict) -> dict:
    """The device profile of 3 warm forwards on each path."""
    out = {}
    for mode in ("kernel", "plain"):
        ctx = _plain_kernels() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            out[mode] = _device_profile(lambda: model.forward(batch), wall_ms[mode],
                                        "lstm_scan_kernel" if mode == "kernel" else None, 4)
        _print_profile(mode, out[mode], wall_ms[mode])
    return out


def phase_encodec_48k(card: str) -> dict:
    """Full-width Encodec-48k, stereo, 2.5 s at batch 1 through forward: two
    full chunks in one batch and a tail on its own."""
    from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
    from neuralcodecs_tpu_torch.ops import kernels

    model = Encodec(EncodecConfig.encodec_48khz(), device=DEVICE, seed=SEED).eval()
    rng = np.random.default_rng(SEED + 4)
    n = int(2.5 * model.config.sample_rate)
    audio = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    model.forward(audio)  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = model.forward(audio)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n_q = model._n_q()
    want = {**_NO_LAUNCHES, "codebook_argmin": 2 * n_q, "lstm_scan": 8}
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(lambda: model.forward(audio), 5, 0)
    phase("encodec-48k", tuple(out.shape) == (1, 2, n) and finite and counts == want,
          f"forward of 2.5 s stereo -> {tuple(out.shape)}, finite {finite}; launches {counts} "
          f"== {want}; {ms:.1f} ms per forward (CUDA events, mean of 5) on {card}")
    return {"counts": counts, "ms": ms}, model


# ------------------------------------------------- Encodec streaming phase


STREAM_SECONDS = 10
SHORT_SECONDS = 2  # the one-hop session from the first push
# the first push of a session: a first push reflects its own samples at
# each conv's left edge and, where a conv's input is no longer than its
# context, takes the short-input fallback there; Encodec-24k's last encoder
# conv and first decoder conv (k = 7, one frame a hop) do so below 7 hops,
# and the session then differs from the full forward (reported, not held)
FIRST_HOPS = 8
# the ragged session's client chunks, in hops, after its first push; cycled
RAGGED_HOPS = (3, 13, 1, 8, 21, 5, 2, 34)


def _pushes(first: int, chunk: int, total: int) -> list[tuple[int, int]]:
    """(start, end) in hops: a first push, then pushes of ``chunk``."""
    return [(0, first)] + [(o, min(o + chunk, total)) for o in range(first, total, chunk)]


def _ragged_pushes(total: int) -> list[tuple[int, int]]:
    out, o, i = [(0, FIRST_HOPS)], FIRST_HOPS, 0
    while o < total:
        n = min(RAGGED_HOPS[i % len(RAGGED_HOPS)], total - o)
        out.append((o, o + n))
        o, i = o + n, i + 1
    return out


def _session_run(model, audio: np.ndarray, pushes, n_q: int, block_hops=None) -> dict:
    """Paired encode and decode sessions over ``audio`` [B, T] at ``pushes``
    ((start, end) in hops): the codes [B, n_q, F] and audio [B, 1, T] they
    emit, and for each push the CUDA-event time of its encode and decode and
    its wall time, with a synchronise at its end as a server's reply needs."""
    from neuralcodecs_tpu_torch.models.encodec import StreamingDecoder, StreamingEncoder

    hop = model.encoder.hop_length
    enc = StreamingEncoder(model, n_q=n_q, block_hops=block_hops)
    dec = StreamingDecoder(model, block_hops=block_hops)
    codes, outs, enc_ms, dec_ms, wall_ms = [], [], [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    for a, b in pushes:
        t0 = time.perf_counter()
        ev[0].record()
        c = enc.push(audio[:, a * hop: b * hop])
        ev[1].record()
        y = dec.push(c)
        ev[2].record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        enc_ms.append(ev[0].elapsed_time(ev[1]))
        dec_ms.append(ev[1].elapsed_time(ev[2]))
        codes.append(c)
        outs.append(y)
    return {"codes": torch.cat(codes, -1), "audio": torch.cat(outs, 1).transpose(1, 2),
            "enc_ms": enc_ms, "dec_ms": dec_ms, "wall_ms": wall_ms, "pushes": len(pushes)}


def _stream_code_gaps(model, x: torch.Tensor, full: torch.Tensor,
                      got: torch.Tensor) -> tuple[int, float]:
    """(frames whose streamed codes differ from the full encode's ``full``,
    largest relative top-2 score gap at the first stage where each differs):
    the full encode's residual at that stage, scored with plain L2 as
    ``_encodec_near_ties`` does. Later stages of such a frame follow from
    the first and are not held."""
    emb = model.encoder(x).float().transpose(1, 2).reshape(-1, model.config.codebook_dim)
    n_q = full.shape[1]
    full_rows = full.permute(0, 2, 1).reshape(-1, n_q).long()
    got_rows = got.permute(0, 2, 1).reshape(-1, n_q).long()
    pending = torch.ones(emb.shape[0], dtype=torch.bool, device=emb.device)
    residual, frames, worst = emb, 0, 0.0
    for s, layer in enumerate(model.quantizer.layers[:n_q]):
        embed = layer.codebook.embed
        diff = pending & (got_rows[:, s] != full_rows[:, s])
        if bool(diff.any()):
            scores = _plain_scores(residual[diff], embed)
            s_got = scores.gather(1, got_rows[diff, s:s + 1])[:, 0]
            s_full = scores.gather(1, full_rows[diff, s:s + 1])[:, 0]
            worst = max(worst, float(((s_got - s_full).abs() / (1 + s_full.abs())).max()))
            frames += int(diff.sum())
            pending &= ~diff
        residual = residual - embed[full_rows[:, s]]
    return frames, worst


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def _stream_kernel3(model, gen: torch.Generator) -> tuple[list, float, dict]:
    """Kernel 3 at the streaming shapes against its plain loop: T = 1, 8, 75
    at B = 1 and 4 from non-zero h0 / c0, then 750 chained T = 1 launches
    against one T = 750 launch. Returns (rows, max error, the T = 1, B = 4
    row with cuDNN's time on the same step)."""
    from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan, lstm_scan_plain

    dev = torch.device(DEVICE)
    w_hh = _slstm(model, "encoder").lstm.weight_hh_l0.detach()
    h = w_hh.shape[1]
    rows, err, bad = [], 0.0, []
    for t in (1, 8, 75):
        for b in (1, 4):
            gx = 0.5 * torch.randn(t, b, 4 * h, generator=gen, device=dev)
            h0 = 0.1 * torch.randn(b, h, generator=gen, device=dev)
            c0 = 0.1 * torch.randn(b, h, generator=gen, device=dev)
            got, want = lstm_scan(gx, w_hh, h0, c0), lstm_scan_plain(gx, w_hh, h0, c0)
            torch.cuda.synchronize()
            e = max(float((g - w).abs().max()) for g, w in zip(got, want))
            if not all(torch.allclose(g, w, **LSTM_TOL) for g, w in zip(got, want)):
                bad.append((t, b, e))
            err = max(err, e)
            ms = time_ms(lambda: lstm_scan(gx, w_hh, h0, c0), 20)
            plain_ms = time_ms(lambda: lstm_scan_plain(gx, w_hh, h0, c0), 5, 1)
            flops = 2.0 * t * b * 4 * h * h + 10.0 * t * b * h
            nbytes = 4.0 * (t * b * 4 * h + 4 * h * h + 4 * b * h + t * b * h)
            rows.append({"case": f"stream T={t} B={b} from h0/c0", "T": t, "B": b, "H": h,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": e, **bound(flops, nbytes)})
    # 750 chained T = 1 launches, as a 10 s session of one-hop pushes makes
    gx = 0.5 * torch.randn(750, 4, 4 * h, generator=gen, device=dev)
    h0 = 0.1 * torch.randn(4, h, generator=gen, device=dev)
    c0 = 0.1 * torch.randn(4, h, generator=gen, device=dev)
    ys, hh, cc = [], h0, c0
    for t in range(750):
        y, hh, cc = lstm_scan(gx[t:t + 1], w_hh, hh, cc)
        ys.append(y)
    whole = lstm_scan(gx, w_hh, h0, c0)
    torch.cuda.synchronize()
    chained = (torch.cat(ys), hh, cc)
    e = max(float((g - w).abs().max()) for g, w in zip(chained, whole))
    chain_ok = all(torch.allclose(g, w, **LSTM_TOL) for g, w in zip(chained, whole))
    err = max(err, e)
    if bad or not chain_ok:
        raise PhaseError(f"kernel 3 at streaming shapes beyond rtol 1e-5/atol 1e-6: {bad}; "
                         f"750 chained T=1 vs one T=750: max|err| {e:.2e}")
    step = next(r for r in rows if r["T"] == 1 and r["B"] == 4)
    lib = torch.nn.LSTM(h, h).to(dev)
    x1 = torch.randn(1, 4, h, generator=gen, device=dev)
    state = (0.1 * torch.randn(1, 4, h, generator=gen, device=dev),
             0.1 * torch.randn(1, 4, h, generator=gen, device=dev))
    step["library_ms"] = time_ms(lambda: lib(x1, state), 20)
    # a step is a few µs of device work: back-to-back events time the host,
    # so the device times come from torch.profiler
    device_ms = _tool("codebook_ablate").device_ms
    gx1 = 0.5 * torch.randn(1, 4, 4 * h, generator=gen, device=dev)
    step["device_ms"] = device_ms(lambda: lstm_scan(gx1, w_hh, state[0][0], state[1][0]))
    step["library_device_ms"] = device_ms(lambda: lib(x1, state))
    step["chain_750_max_abs_err"] = e
    return rows, err, step


def _stream_codebook(gen: torch.Generator) -> list:
    """Kernel 1 at a one-hop push's rows (4: B = 4 sessions) and an 8-hop
    push's (32), 1024 x 128, against its plain version."""
    from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin, codebook_argmin_plain

    ablate = _tool("codebook_ablate")
    rows = []
    for t in (4, 32):
        flat, cb = ablate.inputs(gen, 1024, 128, t)
        got, want = codebook_argmin(flat, cb), codebook_argmin_plain(flat, cb)
        torch.cuda.synchronize()
        k, gap = _compare_codes(flat, cb, got, want)
        flops, nbytes = 2.0 * t * 1024 * 128 + 2.0 * 1024 * 128, 4.0 * (t * 128 + 1024 * 128 + t)
        rows.append({"N": 1024, "D": 128, "T": t, "served": False, "stream": True,
                     "ms": time_ms(lambda: codebook_argmin(flat, cb)),
                     "device_ms": ablate.device_ms(lambda: codebook_argmin(flat, cb)),
                     "plain_ms": time_ms(lambda: codebook_argmin_plain(flat, cb)),
                     "near_ties": k, "max_gap": gap, **bound(3 * flops, nbytes, TF32_FLOPS)})
    return rows


def phase_encodec_stream(model, gen: torch.Generator, card: str) -> dict:
    """Streaming sessions of full-width Encodec-24k at 6 kbps (n_q = 8):
    4 sessions as one B = 4 batch of 10 s clips, pushed in chunks of 1 hop
    (13.3 ms; after the 8-hop first push), 8 hops and 75 hops (1 s), and one
    session with ``block_hops=(8, 1)`` fed ragged client chunks. Each run's
    codes must equal the card's full encode of the clips apart from
    near-ties (the first differing stage of a frame within 1e-5 relative of
    its top-2 gap), and its audio the full decode of its own codes within
    rtol 1e-4 / atol 1e-5. Kernel 3 is held to its plain loop at T = 1, 8
    and 75 from carried state and over 750 chained T = 1 launches, kernel 1
    at 4 and 32 rows. A one-hop session from the very first push is run on
    2 s and its difference from the full forward reported (not held). The
    kernels' launches are counted per run. Every push after a session's
    first replays a CUDA graph (captured in the warm-up runs); each run is
    repeated with the graphs off, and its codes and audio must be the
    graphed run's bit for bit."""
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.ops.graphs import graphs_disabled

    lstm_rows, lstm_err, step = _stream_kernel3(model, gen)
    cb_rows = _stream_codebook(gen)
    sr, hop, n_q = model.config.sample_rate, model.encoder.hop_length, model._n_q()
    hops = int(STREAM_SECONDS * sr) // hop
    rng = np.random.default_rng(SEED + 5)
    audio = (0.3 * rng.standard_normal((4, hops * hop))).astype(np.float32)
    x = torch.as_tensor(audio[:, None, :], device=DEVICE)
    full = model.encode(x)[0].codes
    runs = {"1 hop": (audio, _pushes(FIRST_HOPS, 1, hops), None),
            "8 hops": (audio, _pushes(8, 8, hops), None),
            "75 hops": (audio, _pushes(75, 75, hops), None),
            "ragged, block_hops=(8, 1)": (audio[:1], _ragged_pushes(hops), (8, 1))}
    # warm: cuDNN picks its algorithms and the steady pushes' graphs are
    # captured, the last (shorter) push's too, outside the counted runs
    for name, (a, pushes, blocks) in runs.items():
        _session_run(model, a, pushes[:3] + pushes[-1:], n_q, blocks)
    counts, want, summary, failures = dict(_NO_LAUNCHES), dict(_NO_LAUNCHES), {}, []
    for name, (a, pushes, blocks) in runs.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = _session_run(model, a, pushes, n_q, blocks)
        torch.cuda.synchronize()
        run_counts = kernels.launch_counts()
        with graphs_disabled():
            eager = _session_run(model, a, pushes, n_q, blocks)
        same = (torch.equal(eager["codes"], res["codes"])
                and torch.equal(eager["audio"], res["audio"]))
        # a sub-step: n_q codebook launches and 2 LSTM layers, encode and decode
        steps = len(_decompose_pushes(pushes, blocks))
        run_want = {**_NO_LAUNCHES, "codebook_argmin": n_q * steps, "lstm_scan": 4 * steps}
        for key in KERNELS:
            counts[key] += run_counts[key]
            want[key] += run_want[key]
        b = a.shape[0]
        frames, gap = _stream_code_gaps(model, x[:b], full[:b], res["codes"])
        ref = model.decoder(model.quantizer.decode(res["codes"]))
        err = float((res["audio"] - ref).abs().max())
        close = torch.allclose(res["audio"], ref, rtol=1e-4, atol=1e-5)
        # the mean chunk after the first push
        chunk_ms = (hops - pushes[0][1]) / (len(pushes) - 1) * hop / sr * 1e3
        row = {"sessions": b, "pushes": res["pushes"], "chunk_ms": chunk_ms,
               "launches_a_push": sum(run_counts.values()) / res["pushes"],
               "enc_ms_p50": _pct(res["enc_ms"], 50), "enc_ms_p90": _pct(res["enc_ms"], 90),
               "dec_ms_p50": _pct(res["dec_ms"], 50), "dec_ms_p90": _pct(res["dec_ms"], 90),
               "wall_ms_p50": _pct(res["wall_ms"], 50), "wall_ms_p90": _pct(res["wall_ms"], 90),
               "frames_differing": frames, "max_rel_gap": gap, "audio_max_abs_err": err,
               "graphed_equals_eager": same,
               "eager_wall_ms_p50": _pct(eager["wall_ms"], 50),
               "eager_wall_ms_p90": _pct(eager["wall_ms"], 90),
               "eager_enc_ms_p50": _pct(eager["enc_ms"], 50),
               "eager_dec_ms_p50": _pct(eager["dec_ms"], 50)}
        summary[name] = row
        if gap > 1e-5 or not close or res["codes"].shape != (b, n_q, hops) or not same:
            failures.append((name, frames, gap, err, same))
        print(f"    stream {name}: {b} session(s), {res['pushes']} pushes; a push (enc + dec, "
              f"CUDA events) p50 {row['enc_ms_p50']:.2f} + {row['dec_ms_p50']:.2f} ms, p90 "
              f"{row['enc_ms_p90']:.2f} + {row['dec_ms_p90']:.2f} ms; wall p50 "
              f"{row['wall_ms_p50']:.2f} / p90 {row['wall_ms_p90']:.2f} ms against a "
              f"{chunk_ms:.1f} ms chunk; {row['launches_a_push']:.1f} kernel launches a push "
              f"({run_counts['codebook_argmin']} codebook + {run_counts['lstm_scan']} LSTM in "
              f"all); "
              f"frames whose codes differ from the full encode "
              f"{frames} of {b * hops} (largest first-stage gap {gap:.1e} rel.); audio vs "
              f"full decode max|err| {err:.2e}; graphed == eager (codes, audio bit for bit): "
              f"{same}, eager wall p50 {row['eager_wall_ms_p50']:.2f} / p90 "
              f"{row['eager_wall_ms_p90']:.2f} ms")
    # a one-hop session from the very first push
    short_hops = min(hops, int(SHORT_SECONDS * sr) // hop)
    short = audio[:, : short_hops * hop]
    res = _session_run(model, short, _pushes(1, 1, short_hops), n_q)
    xs = torch.as_tensor(short[:, None, :], device=DEVICE)
    frames, gap = _stream_code_gaps(model, xs, model.encode(xs)[0].codes, res["codes"])
    err = float((res["audio"] - model.decoder(model.quantizer.decode(res["codes"]))).abs().max())
    summary["1 hop from the first push (not held)"] = {
        "hops": short_hops, "frames_differing": frames, "max_rel_gap": gap,
        "audio_max_abs_err": err}
    print(f"    stream 1 hop from the first push ({short_hops} hops, not held): frames "
          f"differing from the full encode {frames} of {4 * short_hops} (largest first-stage "
          f"gap {gap:.1e}); audio vs full decode max|err| {err:.2e}")
    print(f"    kernel 3 at T=1 B=4: {step['ms'] * 1e3:.1f} us a call (device "
          f"{step['device_ms'] * 1e3:.1f}), plain {step['plain_ms'] * 1e3:.1f} us, "
          f"torch.nn.LSTM (cuDNN) one step {step['library_ms'] * 1e3:.1f} us (device "
          f"{step['library_device_ms'] * 1e3:.1f}), bound {step['bound_ms'] * 1e3:.2f} us "
          f"({step['bound_by']}); 750 chained T=1 launches vs one T=750 max|err| "
          f"{step['chain_750_max_abs_err']:.2e}")
    for r in cb_rows:
        print(f"    codebook at {r['T']} rows x 1024 x 128: {r['ms'] * 1e3:.1f} us a call "
              f"(device {r['device_ms'] * 1e3:.1f}), plain {r['plain_ms'] * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us; near-tie rows {r['near_ties']}")
    failed = f"; FAILED {failures}" if failures else ""
    phase("encodec stream", not failures and counts == want,
          f"{len(runs)} runs, codes equal to the full encode apart from near-ties, audio within "
          f"rtol 1e-4/atol 1e-5 of the full decode, graphed pushes bit for bit the eager "
          f"ones{failed}; "
          f"launches {counts} == {want}; kernel 3 at T = 1/8/75 and chained vs plain max|err| "
          f"{lstm_err:.2e}; on {card}")
    return {"counts": counts, "runs": summary, "lstm_rows": lstm_rows, "codebook_rows": cb_rows,
            "lstm_step": step}


def _decompose_pushes(pushes, blocks) -> list[int]:
    """The encoder sub-steps a session runs for ``pushes``: the first whole,
    each later one split by ``blocks`` (streaming._decompose)."""
    from neuralcodecs_tpu_torch.models.encodec.streaming import _decompose, _norm_blocks

    blocks = _norm_blocks(blocks)
    out = [pushes[0][1] - pushes[0][0]]
    for a, b in pushes[1:]:
        n = b - a
        out += [n] if blocks is None or n in blocks else _decompose(n, blocks)
    return out


# ------------------------------------------------ LM-coded .ecdc phase


@contextlib.contextmanager
def _decoded_codes():
    """Record the codes the LM-coded decode path returns, as it runs."""
    from neuralcodecs_tpu_torch.models.encodec import compressor

    seen, original = [], compressor._lm_decode_entries

    def record(*args, **kwargs):
        out = original(*args, **kwargs)
        seen.extend(out)
        return out

    compressor._lm_decode_entries = record
    try:
        yield seen
    finally:
        compressor._lm_decode_entries = original


def _timed_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _lm_step_ms(lm, batch: int, k: int, steps: int = 100) -> float:
    """Mean CUDA-event time of an LM step at ``batch`` rows of k codebooks."""
    inp = torch.zeros(batch, k, 1, dtype=torch.long, device=DEVICE)
    state = lm.init_state(batch)
    for _ in range(3):
        _, state = lm.step(inp, state)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        _, state = lm.step(inp, state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _lm_pdfs(lm, codes: list) -> torch.Tensor:
    """The LM's pdfs [T, B, card, K, 1], teacher-forced over clips' codes
    ([K, T] each, one a batch row), as the .ecdc encoder feeds them."""
    k, t = codes[0].shape
    inputs = np.zeros((t, len(codes), k, 1), np.int64)
    for j, c in enumerate(codes):
        inputs[1:, j, :, 0] = c[:, :-1].T + 1
    inputs = torch.as_tensor(inputs, device=DEVICE)
    state, out = lm.init_state(len(codes)), []
    for step in range(t):
        probas, state = lm.step(inputs[step], state)
        out.append(probas)
    return torch.stack(out)


def _cdf_rows_differing(lm, codes: np.ndarray) -> tuple[int, int, float]:
    """(CDF rows that differ between the card's LM and the same LM on the
    CPU, rows, max relative pdf difference), teacher-forced over one clip's
    codes [K, T] at batch 1."""
    from neuralcodecs_tpu_torch.models.encodec.entropy import build_stable_quantized_cdf_batch
    from neuralcodecs_tpu_torch.models.encodec.lm import EncodecLanguageModel

    cpu = EncodecLanguageModel(lm.config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    k, t = codes.shape
    inputs = np.zeros((t, 1, k, 1), np.int64)
    inputs[1:, 0, :, 0] = codes[:, :-1].T + 1
    pdfs = []
    for model in (lm, cpu):
        state, out = model.init_state(1), []
        for step in range(t):
            probas, state = model.step(torch.as_tensor(inputs[step]), state)
            out.append(probas[0, :, :, 0].T.cpu().numpy())           # [k, card]
        pdfs.append(np.concatenate(out))
    cdfs = [build_stable_quantized_cdf_batch(p, 24) for p in pdfs]
    rel = np.abs(pdfs[0] - pdfs[1]) / np.maximum(np.abs(pdfs[1]), 1e-30)
    return int((cdfs[0] != cdfs[1]).any(axis=1).sum()), k * t, float(rel.max())


def phase_ecdc_lm(model, model48, card: str) -> dict:
    """The LM-coded .ecdc path at full width: Encodec-24k at 6 kbps with the
    24 kHz LM's shape (32 codebooks of 1024, dimension 200, 8 heads, 5
    layers, past context 262; seeded weights). ``compress_batch`` of 4 x 10 s
    clips at lm_batch 4, one clip at lm_batch 1, ``decompress_batch``, and
    Encodec-48k's 2.5 s stereo clip through its own seeded LM (segmented:
    the 'lp' length prefixes; its 3 frames at lm_batch 4: 'lmb'). The decoded
    codes must equal the encoded ones bit for bit and the audio
    decode(encode(x)) within rtol 1e-5 / atol 1e-6, through the native
    range coder. A seeded LM is random: it compresses nothing. The LM step
    replays a CUDA graph for each batch; with the graphs off (the eager
    step) the teacher-forced pdfs of the 4 clips must be the same bit for
    bit, and a clip's stream written eagerly must decode graphed, and the
    graph-written one eagerly."""
    from neuralcodecs_tpu_torch.models.encodec import ecdc
    from neuralcodecs_tpu_torch.native import build as native_build
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.ops.graphs import graphs_disabled

    sr = model.config.sample_rate
    rng = np.random.default_rng(SEED + 6)
    seconds = int(STREAM_SECONDS * sr) / sr
    clips = [(0.3 * rng.standard_normal(int(STREAM_SECONDS * sr))).astype(np.float32)
             for _ in range(4)]
    n48 = int(2.5 * model48.config.sample_rate)
    clip48 = (0.3 * rng.standard_normal((2, n48))).astype(np.float32)
    lm = model.get_language_model(download=False)
    lm48 = model48.get_language_model(download=False)
    codes = [model.encode(c)[0].codes[0].cpu().numpy() for c in clips]
    codes48 = [f.codes[0].cpu().numpy() for f in model48.encode(clip48)]
    direct = [model.decode(model.encode(c))[..., : c.shape[-1]] for c in clips]
    direct48 = model48.decode(model48.encode(clip48))[..., :n48]
    k, k48 = codes[0].shape[0], codes48[0].shape[0]
    step_ms = {b: _lm_step_ms(lm, b, k) for b in (1, 4)}
    with graphs_disabled():
        eager_step_ms = {b: _lm_step_ms(lm, b, k, 30) for b in (1, 4)}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    blobs, enc_s = _timed_s(lambda: model.compress_batch(clips, use_lm=True, lm=lm, lm_batch=4))
    with _decoded_codes() as seen:
        outs, dec_s = _timed_s(lambda: model.decompress_batch(blobs, lm=lm))
    blob1, enc1_s = _timed_s(lambda: model.compress(clips[0], use_lm=True, lm=lm, lm_batch=1))
    with _decoded_codes() as seen1:
        out1, dec1_s = _timed_s(lambda: model.decompress(blob1, lm=lm))
    blob48 = model48.compress(clip48, use_lm=True, lm=lm48, lm_batch=4)
    with _decoded_codes() as seen48:
        out48 = model48.decompress(blob48, lm=lm48)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    pdfs = _lm_pdfs(lm, codes)
    with graphs_disabled():
        pdf_equal = torch.equal(_lm_pdfs(lm, codes), pdfs)
        blob_eager = model.compress(clips[0], use_lm=True, lm=lm, lm_batch=1)
        with _decoded_codes() as eager_of_graphed:
            model.decompress(blob1, lm=lm)
    with _decoded_codes() as graphed_of_eager:
        model.decompress(blob_eager, lm=lm)
    cross = (np.array_equal(eager_of_graphed[0], codes[0])
             and np.array_equal(graphed_of_eager[0], codes[0]))
    n_q48 = model48._n_q()
    # encodes: 4 clips + 1 at 24 kHz (8 stages, 2 LSTM layers each), the 48k
    # clip's full chunks and tail (two calls); decodes: 5 + the 48k's two
    want = {**_NO_LAUNCHES, "codebook_argmin": 5 * k + 2 * n_q48,
            "lstm_scan": 5 * 2 + 5 * 2 + 2 * 2 + 2 * 2}
    headers = [ecdc.read_header(io.BytesIO(b)) for b in (blobs[0], blob1, blob48)]
    framing = (headers[0].get("lmb") == 4 and "lmb" not in headers[1]
               and headers[2].get("lp") is True and headers[2].get("lmb") == 4
               and "lp" not in headers[0])
    same_codes = (len(seen) == 4 and all(np.array_equal(s, c) for s, c in zip(seen, codes))
                  and len(seen1) == 1 and np.array_equal(seen1[0], codes[0])
                  and len(seen48) == len(codes48)
                  and all(np.array_equal(s, c) for s, c in zip(seen48, codes48)))
    pairs = list(zip(outs + [out1, out48], direct + [direct[0], direct48]))
    errs = [float((o - d).abs().max()) for o, d in pairs]
    close = all(torch.allclose(o, d, rtol=1e-5, atol=1e-6) for o, d in pairs)
    native = native_build._lib is not None and native_build.library_path().is_file()
    raw = [len(model.compress(c, use_lm=False)) for c in clips]
    payload = [len(b) for b in blobs]
    cdf_diff, cdf_rows, pdf_rel = _cdf_rows_differing(lm, codes[0])
    res = {"counts": counts, "step_ms": step_ms, "eager_step_ms": eager_step_ms,
           "pdfs_graphed_equal_eager": pdf_equal, "cross_decode": cross,
           "blob_eager_equals_graphed": blob_eager == blob1,
           "encode_s": enc_s, "decode_s": dec_s,
           "encode_1_s": enc1_s, "decode_1_s": dec1_s,
           "encode_xrt": 4 * seconds / enc_s, "decode_xrt": 4 * seconds / dec_s,
           "encode_1_xrt": seconds / enc1_s, "decode_1_xrt": seconds / dec1_s,
           "lm_bytes": payload, "raw_bytes": raw, "blob48_bytes": len(blob48),
           "cdf_rows_differing_card_vs_cpu": cdf_diff, "cdf_rows": cdf_rows,
           "pdf_max_rel_card_vs_cpu": pdf_rel, "audio_max_abs_err": max(errs)}
    print(f"    lm step (CUDA events, mean of 100), graphed: {step_ms[1]:.3f} ms at B=1, "
          f"{step_ms[4]:.3f} ms at B=4 (k={k} codebooks); eager {eager_step_ms[1]:.3f} / "
          f"{eager_step_ms[4]:.3f} ms; teacher-forced pdfs of the 4 clips graphed == eager bit "
          f"for bit: {pdf_equal}; a clip written eagerly decodes graphed and the other way: "
          f"{cross} (the two streams' bytes equal: {blob_eager == blob1})")
    print(f"    lm coding: compress_batch 4 x {seconds} s at lm_batch 4 {enc_s:.2f} s "
          f"({res['encode_xrt']:.1f} s of audio per s), decompress_batch {dec_s:.2f} s "
          f"({res['decode_xrt']:.1f}); one clip at lm_batch 1: {enc1_s:.2f} / {dec1_s:.2f} s "
          f"({res['encode_1_xrt']:.1f} / {res['decode_1_xrt']:.1f})")
    print(f"    lm bytes {payload} against raw {raw} (a seeded, untrained LM compresses "
          f"nothing); 48k stereo 2.5 s: {len(blob48)} B")
    print(f"    card vs CPU LM, one clip teacher-forced: {cdf_diff} of {cdf_rows} CDF rows differ "
          f"(pdfs max rel. {pdf_rel:.1e}); a stream decodes only where it was written "
          f"(informative, not held)")
    phase("ecdc lm", same_codes and close and framing and native and counts == want
          and pdf_equal and cross,
          f"decoded codes == encoded bit for bit (4 at lm_batch 4, 1 at lm_batch 1, 48k's "
          f"{len(codes48)} frames): {same_codes}; audio vs decode(encode(x)) within rtol "
          f"1e-5/atol 1e-6: {close} (max|err| {max(errs):.2e}); headers lmb/lp {framing}; "
          f"native coder {native_build.library_path().name}: {native}; launches {counts} == "
          f"{want}; replayed LM pdfs == eager bit for bit: {pdf_equal}; eager- and "
          f"graph-written streams decode each other: {cross}; on {card}")
    return res


# ----------------------------------------------------------- DSP phases


# BASELINE.json config 4 (bench.py, bench_dsp): 64 clips of 10 s at
# 44.1 kHz, resampled to 24 kHz, compressed, then an 80-band mel
DSP_BATCH, DSP_SECONDS, DSP_SRC, DSP_DST = 64, 10, 44100, 24000
# (N, T) at which kernels 4-5 are held against their plain loops: the
# config-4 batch, one clip, a single sample, rows past whole blocks of 4
# (130 = 32 blocks + 2 rows), a whole number of 512-sample tiles and of
# 1024-sample chunks, and a T that is a multiple of neither the tile nor the
# 4-sample group (so neither the envelope's bulk copies nor the biquad's
# 16-byte copies line up with every row)
RECURRENCE_SHAPES = [(64, 240_000), (1, 24_000), (3, 1), (130, 5000), (32, 2048), (7, 777)]


def _timed(fn):
    """(fn(), ms of that one call by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_envelope(gen: torch.Generator) -> dict:
    """Kernel 4 against its plain loop, bit-exact (torch.equal), at every
    RECURRENCE_SHAPES case with the compressor's gains at 24 kHz; the plain
    loop runs once a case (seconds at the config-4 T) and that run is its
    time. Beside each case, ``floor_ms``: the kernel's step alone, T times
    from registers with no loads, stores or barriers (tools/row_scan_ablate.py's
    chain-only kernel, built here), which the kernel cannot beat. The bound
    is the config-4 case's: a step's 4 f32 operations (subtract, multiply,
    add, select), one read and one write a sample."""
    from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow, envelope_follow_plain

    tool = _tool("row_scan_ablate")
    chains = tool.build_chains()
    gains = tuple(float(np.float32(g)) for g in _compressor_gains(DSP_DST))
    rows, bad, err = [], [], 0.0
    for n, t in RECURRENCE_SHAPES:
        x = 0.25 * torch.randn(n, t, generator=gen, device=DEVICE)
        got = envelope_follow(x, *gains)
        want, plain_ms = _timed(lambda: envelope_follow_plain(x, *gains))
        exact = torch.equal(got, want)
        e = float((got - want).abs().max())
        err = max(err, e)
        if not exact:
            bad.append(((n, t), e))
        ms = time_ms(lambda: envelope_follow(x, *gains), 10)
        floor_ms, cycles = tool.chain_floor(chains, x, gains)
        rows.append({"case": "compressor 24k", "N": n, "T": t, "ms": ms, "plain_ms": plain_ms,
                     "floor_ms": floor_ms, "floor_cycles_per_step": cycles, "max_abs_err": e})
        print(f"    envelope N={n} T={t}: kernel {ms:.4f} ms (chain floor {floor_ms:.4f} ms, "
              f"{cycles:.2f} cycles a step), plain {plain_ms:.1f} ms, "
              + ("bit-exact" if exact else f"MISMATCH max|err| {e:.2e}"))
    phase("envelope kernel vs plain", not bad,
          f"{len(rows)} cases bit-exact (torch.equal); at N={rows[0]['N']} T={rows[0]['T']} "
          f"{rows[0]['ms']:.4f} ms against its chain floor {rows[0]['floor_ms']:.4f} ms "
          f"({rows[0]['ms'] / rows[0]['floor_ms']:.2f}x)" + (f"; mismatches {bad}" if bad else ""))
    numel = RECURRENCE_SHAPES[0][0] * RECURRENCE_SHAPES[0][1]
    return {"rows": rows, "max_abs_err": err, "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "floor_ms": rows[0]["floor_ms"], "library_ms": None,
            **bound(4.0 * numel, 8.0 * numel)}


def _biquads() -> dict:
    """The K-weighting's two sections and one random stable biquad (poles
    at radius 0.95)."""
    from neuralcodecs_tpu_torch.dsp import loudness

    rng = np.random.default_rng(SEED + 6)
    theta = rng.uniform(0.1, 3.0)
    rand = (tuple(0.5 * rng.standard_normal(3)), (1.0, -1.9 * math.cos(theta), 0.95 ** 2))
    return {"k-shelf": (loudness._HIGH_SHELF_B, loudness._HIGH_SHELF_A),
            "k-highpass": (loudness._HIGH_PASS_B, loudness._HIGH_PASS_A), "random": rand}


def _lfilter_f64(x: np.ndarray, sections) -> np.ndarray:
    """The exact filter: the sections' f32 coefficients, applied in f64 on
    the host (scipy.signal.lfilter)."""
    from scipy.signal import lfilter

    from neuralcodecs_tpu_torch.ops.kernels.biquad import section_coefs

    y = x.astype(np.float64)
    for b0, b1, b2, a1, a2 in section_coefs(sections):
        y = lfilter([b0, b1, b2], [1.0, a1, a2], y, axis=-1)
    return y


# the biquad kernel against the exact filter where T > the chunk length: on
# its first rows, its max error may be at most this many times the plain
# f32 loop's
BIQUAD_F64_RATIO = 1.5
BIQUAD_F64_ROWS = 4


def phase_biquad(gen: torch.Generator) -> dict:
    """Kernel 5 (the cascade) at every RECURRENCE_SHAPES case: at the config-4
    shape the K-weighting cascade and the random biquad; at the others each
    of the three biquads alone and the K-weighting cascade. Where T <= the
    chunk length L (one chunk, zero start) the kernel must equal the plain
    loop bit for bit (torch.equal); where T > L it is a chunked scan, not
    bit-equal to the loop, and on rows 0-3 its max error against the exact
    filter (f64 on the host) must be at most 1.5 x the plain f32 loop's.
    Prints the kernel's max abs and relative difference to the plain loop
    per case. The plain loop runs once a case (its time). The bound is the
    config-4 cascade's: 9 f32 operations a sample a section, x read once and
    y written once."""
    from neuralcodecs_tpu_torch.ops.kernels.biquad import (
        CHUNK, biquad_cascade_plain, biquad_df2t)

    filt = _biquads()
    cascade = ("K-weighting cascade", [filt["k-shelf"], filt["k-highpass"]])
    rows, bad, err = [], [], 0.0
    for n, t in RECURRENCE_SHAPES:
        x = 0.25 * torch.randn(n, t, generator=gen, device=DEVICE)
        cases = ([cascade, ("random", [filt["random"]])] if (n, t) == RECURRENCE_SHAPES[0]
                 else [(name, [f]) for name, f in filt.items()] + [cascade])
        for label, sections in cases:
            got = biquad_df2t(x, sections)
            want, plain_ms = _timed(lambda: biquad_cascade_plain(x, sections))
            e = float((got - want).abs().max())
            rel = e / max(float(want.abs().max()), 1e-30)
            row = {"case": label, "sections": len(sections), "N": n, "T": t,
                   "max_abs_err": e, "max_rel_err": rel, "plain_ms": plain_ms}
            if t <= CHUNK:
                ok = torch.equal(got, want)
                gate = "bit-exact" if ok else "NOT bit-exact"
            else:
                exact = _lfilter_f64(x[:BIQUAD_F64_ROWS].cpu().numpy(), sections)
                e_kernel = float(np.abs(got[:BIQUAD_F64_ROWS].cpu().numpy() - exact).max())
                e_plain = float(np.abs(want[:BIQUAD_F64_ROWS].cpu().numpy() - exact).max())
                ok = e_kernel <= BIQUAD_F64_RATIO * e_plain
                row.update(f64_err_kernel=e_kernel, f64_err_plain=e_plain)
                gate = (f"vs f64 on rows 0-{BIQUAD_F64_ROWS - 1}: kernel {e_kernel:.3e}, plain "
                        f"{e_plain:.3e} ({e_kernel / max(e_plain, 1e-30):.3f}x)")
            err = max(err, e)
            if not ok:
                bad.append((label, (n, t)))
            row["ms"] = time_ms(lambda: biquad_df2t(x, sections), 10)
            rows.append(row)
            print(f"    biquad {label} N={n} T={t}: kernel {row['ms']:.4f} ms, plain "
                  f"{plain_ms:.1f} ms; vs plain max|err| {e:.2e} (rel {rel:.2e}); {gate}"
                  + ("" if ok else "  FAIL"))
    phase("biquad kernel vs plain and f64", not bad,
          f"{len(rows)} cases: T <= {CHUNK} bit-exact, T > {CHUNK} within "
          f"{BIQUAD_F64_RATIO} x the plain loop's error against f64; the cascade at "
          f"N={rows[0]['N']} T={rows[0]['T']} {rows[0]['ms']:.4f} ms"
          + (f"; failed {bad}" if bad else ""))
    numel = RECURRENCE_SHAPES[0][0] * RECURRENCE_SHAPES[0][1]
    return {"rows": rows, "max_abs_err": err, "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "library_ms": None, **bound(2 * 9.0 * numel, 8.0 * numel)}


@contextlib.contextmanager
def _plain_dsp_kernels():
    """Swap the plain versions in where the DSP filters call the envelope
    and biquad kernels, for a kernel-vs-plain timing of the same path."""
    from neuralcodecs_tpu_torch.dsp import filters
    from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_cascade_plain
    from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow_plain

    saved = filters.envelope_follow, filters.biquad_df2t
    filters.envelope_follow, filters.biquad_df2t = envelope_follow_plain, biquad_cascade_plain
    try:
        yield
    finally:
        filters.envelope_follow, filters.biquad_df2t = saved


def _dsp_stages():
    from neuralcodecs_tpu_torch.dsp.effects import apply_compressor
    from neuralcodecs_tpu_torch.dsp.mel import mel_spectrogram
    from neuralcodecs_tpu_torch.dsp.resample import resample_poly

    return (lambda x: resample_poly(x, DSP_SRC, DSP_DST),
            lambda y: apply_compressor(y, DSP_DST, threshold=-20.0, ratio=4.0),
            lambda c: mel_spectrogram(c, DSP_DST, n_mels=80))


def _dsp_chain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(resampled, mel) of the config-4 chain on [B, T] audio at 44.1 kHz."""
    resample, compress, mel = _dsp_stages()
    y = resample(x)
    return y, mel(compress(y))


def _peak_gb(fn) -> float:
    """Peak device memory of one call of fn(), above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_dsp_pipeline(card: str) -> tuple[dict, torch.Tensor]:
    """The config-4 chain at 64 x 10 s through the port's public functions;
    returns its details and the resampled batch."""
    from neuralcodecs_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 5)
    audio = 0.25 * rng.standard_normal((DSP_BATCH, DSP_SRC * DSP_SECONDS), dtype=np.float32)
    x = torch.from_numpy(audio).to(DEVICE)
    _dsp_chain(x)  # warm: cuDNN and cuFFT plans
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (y, mel), ms = _timed(lambda: _dsp_chain(x))
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    want = {**_NO_LAUNCHES, "envelope_follow": 1}
    frames = 1 + y.shape[-1] // 512
    shape_ok = tuple(mel.shape) == (DSP_BATCH, 80, frames) and bool(torch.isfinite(mel).all())

    y_cpu, mel_cpu = _dsp_chain(x[:2].cpu())  # the CPU runs the plain loops
    close = torch.allclose(mel[:2].cpu(), mel_cpu, rtol=1e-4, atol=1e-5)
    mel_err = float((mel[:2].cpu() - mel_cpu).abs().max())

    stages = {}
    resample, compress, to_mel = _dsp_stages()
    for name, fn in (("resample", lambda: resample(x)), ("compressor", lambda: compress(y)),
                     ("mel", lambda: to_mel(y))):
        stages[name] = {"ms": time_ms(fn, 5, 1), "peak_gb": _peak_gb(fn)}
    peak = _peak_gb(lambda: _dsp_chain(x))
    with _plain_dsp_kernels():
        _, plain_ms = _timed(lambda: _dsp_chain(x))
    prof = _device_profile(lambda: _dsp_chain(x), ms, "envelope_kernel", 1)
    _print_profile("dsp pipeline", prof, ms)
    audio_s = DSP_BATCH * DSP_SECONDS
    phase("dsp pipeline", counts == want and shape_ok and close,
          f"resample 44.1k->24k, compressor, mel of {DSP_BATCH} x {DSP_SECONDS} s -> "
          f"{tuple(mel.shape)}, finite; launches {counts} == {want}; first 2 clips card vs "
          f"cpu mel within rtol 1e-4/atol 1e-5: {close} (max|err| {mel_err:.2e}); warm chain "
          f"{ms:.2f} ms (CUDA events; host {host_ms:.2f} ms) = {audio_s / (ms / 1e3):.0f} s of "
          f"audio per s, plain versions {plain_ms:.1f} ms; stages " + ", ".join(
              f"{k} {v['ms']:.2f} ms / {v['peak_gb']:.3f} GB" for k, v in stages.items())
          + f"; peak {peak:.3f} GB on {card}")
    return ({"counts": counts, "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
             "audio_s_per_s": audio_s / (ms / 1e3), "peak_gb": peak, "stages": stages,
             "mel_max_abs_err": mel_err, "profile": prof}, y)


def phase_loudness(resampled: torch.Tensor, card: str) -> dict:
    """BS.1770 loudness and normalisation of the resampled config-4 batch as
    [64, 1, 240 000] at 24 kHz. The K-weighting is one biquad-cascade launch
    a measurement; the kernel is a chunked scan, so its LUFS are held within
    1e-4 LU of the plain loops', not bit-equal."""
    from neuralcodecs_tpu_torch.dsp import AudioSignal
    from neuralcodecs_tpu_torch.ops import kernels

    from neuralcodecs_tpu_torch.dsp.loudness import integrated_loudness

    sig = AudioSignal(resampled[:, None, :], DSP_DST)
    sig.loudness()  # warm
    # a numpy batch goes to the card, as jnp.asarray puts it on the TPU
    kernels.reset_launch_counts()
    lufs_np = integrated_loudness(resampled[:, None, :].cpu().numpy(), DSP_DST)
    counts_np = kernels.launch_counts()
    np_on_card = lufs_np.device.type == "cuda" and counts_np["biquad_df2t"] == 1
    kernels.reset_launch_counts()
    lufs, ms = _timed(sig.loudness)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    relufs = sig.normalize(-24.0).loudness()
    counts_norm = kernels.launch_counts()
    want = {**_NO_LAUNCHES, "biquad_df2t": 1}
    want_norm = {**_NO_LAUNCHES, "biquad_df2t": 2}
    cpu = AudioSignal(resampled[:2, None, :].cpu(), DSP_DST).loudness()
    diff = float((lufs[:2].cpu() - cpu).abs().max())
    off = float((relufs + 24.0).abs().max())
    peak = _peak_gb(sig.loudness)
    warm_ms = time_ms(sig.loudness, 10)
    with _plain_dsp_kernels():
        lufs_plain, plain_ms = _timed(sig.loudness)
    plain_diff = float((lufs - lufs_plain).abs().max())
    same = torch.equal(lufs_np, lufs) and plain_diff <= 1e-4
    finite = bool(torch.isfinite(lufs).all())
    prof = _device_profile(sig.loudness, ms, "chunk_outputs", 1)
    _print_profile("loudness", prof, ms)
    phase("loudness", counts == want and counts_norm == want_norm and diff <= 1e-3
          and off <= 0.1 and same and finite and np_on_card,
          f"{tuple(sig.audio_data.shape)} at {DSP_DST} Hz: LUFS {float(lufs.min()):.3f} .. "
          f"{float(lufs.max()):.3f}; launches per loudness() {counts} == {want}, normalize + "
          f"loudness {counts_norm} == {want_norm}; first 2 clips card vs cpu |dLUFS| "
          f"{diff:.2e} (<= 1e-3); after normalize(-24) max |LUFS + 24| {off:.2e} (<= 0.1); "
          f"numpy input on the card, kernel launched: {np_on_card} ({counts_np['biquad_df2t']} "
          f"biquad launches); numpy call equal to the tensor call and |dLUFS| vs the plain "
          f"loops {plain_diff:.2e} (<= 1e-4): {same}; {ms:.3f} ms (CUDA events; mean of 10 "
          f"warm calls {warm_ms:.3f} ms), plain versions {plain_ms:.1f} ms; peak {peak:.3f} GB "
          f"on {card}")
    return {"counts": counts, "counts_normalize": counts_norm, "counts_numpy": counts_np,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "lufs_plain_diff": plain_diff,
            "lufs_cpu_diff": diff, "normalize_off": off, "peak_gb": peak, "profile": prof}


# ----------------------------------------------------------- DAC phases


def phase_resunit_dense(model, gen: torch.Generator) -> dict:
    """The dense kernels against the plain chain at every dense unit shape of
    one DAC-44k 10 s stream (B = 1, the 24 units of its forward), and at the
    edge cases: C = 8 and C = 96 at T = 1037, B = 2 (ragged channel tile and
    time tail), and C = 768, d = 9, T = 6896, B = 4 (the server's batch).
    The kernels' 3xTF32 products sum in another order than cuDNN's f32 FMAs,
    so they agree within rtol 1e-4/atol 1e-5, not bit for bit. Prints each
    C's kernel and plain time over its three units and flags every C where
    the kernel is slower; times the wrapper's weight split and re-layout at
    C = 768."""
    from neuralcodecs_tpu_torch.models.layers import ResidualUnit
    from neuralcodecs_tpu_torch.ops.kernels.resunit import pack_dense_weights

    units = _residual_units(model)
    lengths = _unit_lengths(model, _dac_padded(10 * model.config.sample_rate, model))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        narrow = ResidualUnit(8, dilation=9).to(DEVICE)
    by_shape = {(_unit_args(u)[0].shape[1], u.dilation): u for u in units}
    cases = [(u, t, 1) for u, t in zip(units, lengths)]
    cases += [(narrow, 1037, 2), (by_shape[(96, 9)], 1037, 2), (by_shape[(768, 9)], 6896, 4)]
    res = _hold_resunits("resunit dense", cases, len(units), gen)
    _, w_dil, _, _, w_pw, _ = _unit_args(by_shape[(768, 9)])
    res["split_ms_c768"] = time_ms(lambda: pack_dense_weights(w_dil, w_pw), 20)
    slower = [c for c, r in res["per_c"].items() if r["slower"]]
    phase("resunit dense kernel vs plain", not res["mismatches"],
          f"{len(cases)} shapes within rtol 1e-4/atol 1e-5 (max|err| {res['max_abs_err']:.2e}); "
          f"one 10 s stream's 24 units: kernel {res['ms']:.2f} ms, plain {res['plain_ms']:.2f} "
          f"ms, bound {res['bound_ms']:.2f} ms ({res['bound_by']}, 3xTF32; f32 FMA bound "
          f"{res['bound_f32_ms']:.2f} ms); slower than plain at C = {slower or 'none'}; the "
          f"wrapper's weight split and re-layout at C = 768: {res['split_ms_c768']:.4f} ms a call"
          + (f"; mismatches {res['mismatches']}" if res["mismatches"] else ""))
    return res


def _dac_padded(samples: int, model) -> int:
    hop = model.config.hop_length
    return -(-samples // hop) * hop


def _dac_golden_model():
    """The DAC of tests/goldens/dac_golden.npz (make_goldens.dac_golden_config:
    reduced widths, the real 44 kHz strides, 9 codebooks) on the card."""
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig

    g = np.load(ROOT / "tests" / "goldens" / "dac_golden.npz")
    cfg = DACConfig(sample_rate=44100, encoder_dim=8, encoder_rates=[2, 4, 8, 8],
                    decoder_dim=128, decoder_rates=[8, 8, 4, 2], n_codebooks=9,
                    codebook_size=1024, codebook_dim=8)
    model = DAC(cfg, device=DEVICE)
    model.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files
                           if k.startswith("sd/")}, strict=True)
    return model, g


def _dac_top2_gaps(model, latents: torch.Tensor) -> list[torch.Tensor]:
    """Per RVQ stage, the gap between the two best plain normalised scores
    of each frame, from the stages' z_e ([B, T, Nq·D] latents)."""
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    gaps = []
    d = model.config.codebook_dim
    for i, vq in enumerate(model.quantizer.quantizers[: latents.shape[-1] // d]):
        cb = vq.codebook.weight
        z_e = latents[..., i * d: (i + 1) * d].reshape(-1, d)
        top2 = torch.topk(_plain_scores(l2_normalize(z_e), l2_normalize(cb)), 2, dim=-1,
                          largest=False).values
        gaps.append(top2[:, 1] - top2[:, 0])
    return gaps


def phase_dac_golden():
    model, g = _dac_golden_model()
    out = model.forward(g["audio"])
    codes = out["codes"].cpu().numpy()
    ref_codes = g["codes"].astype(np.int32)
    bad = np.argwhere(codes != ref_codes)
    if len(bad):
        gaps = _dac_top2_gaps(model, out["latents"])
        for b, stage, f in bad:
            print(f"    dac golden stage {stage} frame {f}: code {codes[b, stage, f]} vs "
                  f"{ref_codes[b, stage, f]}, top-2 score gap {float(gaps[stage][f]):.3e}")
    ref_audio = g["decoded"][: g["audio"].shape[0]]
    got_audio = out["audio"][0].cpu().numpy()
    close = np.allclose(got_audio, ref_audio, rtol=1e-3, atol=1e-4)
    snr = _snr_db(ref_audio, got_audio)
    phase("dac golden", not len(bad) and close and snr > 55.0,
          f"9 stages x {codes.shape[-1]} frames bit-exact={not len(bad)}, audio within rtol "
          f"1e-3/atol 1e-4={close}, SNR {snr:.1f} dB (> 55), max|err| "
          f"{np.abs(got_audio - ref_audio).max():.2e}")
    return model, g


def phase_dac_card_vs_cpu(model) -> dict:
    """Full-width DAC-44k: the port on the card (kernels) against the port on
    the CPU (plain versions), on 1 s of audio. A frame may differ where it
    first differs at a stage whose two best normalised scores lie within the
    near-tie tolerance of _compare_codes (a flip there changes the frame's
    residual for every later stage); every other code must be equal."""
    from neuralcodecs_tpu_torch.models.dac import DAC
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    rng = np.random.default_rng(SEED + 7)
    audio = (0.3 * rng.standard_normal(model.config.sample_rate)).astype(np.float32)
    cpu = DAC(model.config, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    out_gpu = model.forward(audio)
    out_cpu = cpu.forward(audio)
    got, want = out_gpu["codes"].cpu(), out_cpu["codes"]  # [1, 9, F]
    differs = got[0] != want[0]                          # [9, F]
    frames = torch.nonzero(differs.any(dim=0)).flatten()
    near, gap = 0, 0.0
    for stage in range(got.shape[1]):
        first = [int(f) for f in frames if int(torch.nonzero(differs[:, f])[0]) == stage]
        if not first:
            continue
        vq = model.quantizer.quantizers[stage]
        d = vq.codebook.weight.shape[1]
        z_e = out_gpu["latents"][0, first, stage * d: (stage + 1) * d]
        k, g = _compare_codes(l2_normalize(z_e), l2_normalize(vq.codebook.weight),
                              got[0, stage, first].to(DEVICE), want[0, stage, first].to(DEVICE))
        near, gap = near + k, max(gap, g)
    same = [bool((~differs[s]).all()) for s in range(differs.shape[0])]
    ref, out = out_cpu["audio"].numpy().ravel(), out_gpu["audio"].cpu().numpy().ravel()
    snr = _snr_db(ref, out)
    phase("dac full-width card vs cpu", snr > 55.0,
          f"codes equal per stage {same}; frames that differ {len(frames)} of "
          f"{got.shape[-1]}, each first at a near-tie (rows {near}, max score gap {gap:.2e}); "
          f"SNR {snr:.1f} dB (> 55), max|err| {np.abs(ref - out).max():.2e}")
    return {"near_tie_frames": len(frames), "snr_db": snr}


def _dac_rows(model):
    """DAC's forward on a stacked batch, as cli/serve.py calls it, split into
    per-request (audio, codes)."""
    def forward(stacked: np.ndarray) -> list:
        out = model.forward(stacked)
        return [(out["audio"][i], out["codes"][i]) for i in range(stacked.shape[0])]
    return forward


def phase_dac_serve(model, card: str) -> dict:
    from neuralcodecs_tpu_torch.ops import kernels

    cfg = model.config
    sr = cfg.sample_rate
    rng = np.random.default_rng(SEED + 8)
    long_reqs = [(0.3 * rng.standard_normal(10 * sr)).astype(np.float32) for _ in range(4)]
    short_reqs = [(0.3 * rng.standard_normal(3 * sr)).astype(np.float32) for _ in range(3)]
    foreign = (0.3 * rng.standard_normal(48000 * 2)).astype(np.float32)
    n_units, n_stages = len(_residual_units(model)), cfg.n_codebooks

    def check(results, requests):
        for (out, codes), x in zip(results, requests):
            frames = _dac_padded(x.shape[-1], model) // cfg.hop_length
            if (tuple(out.shape) != x.shape or not bool(torch.isfinite(out).all())
                    or tuple(codes.shape) != (n_stages, frames) or int(codes.min()) < 0
                    or int(codes.max()) >= cfg.codebook_size):
                raise PhaseError(f"bad result: audio {tuple(out.shape)} (want {x.shape}), "
                                 f"codes {tuple(codes.shape)}")

    forward = _dac_rows(model)
    kernels.reset_launch_counts()
    results, forwards = _serve(forward, long_reqs)  # cold
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results, f = _serve(forward, long_reqs)  # warm
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    forwards += f
    served_ms = start.elapsed_time(end)
    check(results, long_reqs)
    short, f = _serve(forward, short_reqs)  # 3 requests padded to batch 4
    forwards += f
    check(short, short_reqs)
    resampled = model.process_audio(foreign, 48000)
    forwards += 1
    n_out = int(foreign.shape[-1] * sr / 48000)
    if resampled.shape != (n_out,) or not np.isfinite(resampled).all():
        raise PhaseError(f"process_audio: shape {resampled.shape}, want ({n_out},)")
    codes = torch.stack([c for _, c in results])
    decoded = model.from_codes(codes)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n_dec_units = len(_residual_units(model.decoder))
    want = {**_NO_LAUNCHES, "codebook_argmin": n_stages * forwards,
            "fused_residual_unit_dense": n_units * forwards + n_dec_units}
    if tuple(decoded.shape) != (4, codes.shape[-1] * cfg.hop_length) or not bool(
            torch.isfinite(decoded).all()):
        raise PhaseError(f"from_codes: shape {tuple(decoded.shape)}")

    # the warm batch-4 x 10 s round trip, kernels against plain versions, in
    # turns plain, kernel, kernel, plain
    batch = np.stack(long_reqs)
    times = {"kernel": [], "plain": []}
    peak = {}
    for mode in ("plain", "kernel", "kernel", "plain"):
        ctx = _plain_kernels() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            ms, gb = _timed_roundtrip(model, batch)
        times[mode].append(ms)
        peak[mode] = gb
    kernel_ms, plain_ms = min(times["kernel"]), min(times["plain"])
    prof = _device_profile(lambda: model.forward(batch), kernel_ms, "resunit_gemm",
                           2 * n_units)  # two GEMM launches a unit (and snake_rows)
    _print_profile("dac kernel", prof, kernel_ms)
    if prof["complete"]:
        prof["dense_split_ms"] = {
            part: sum(ms for k, ms, _ in prof["top"] if name in k and tag in k)
            for part, name, tag in (("snake", "snake_rows", ""),
                                    ("conv", "resunit_gemm", "true>"),
                                    ("pointwise", "resunit_gemm", "false>"))}
        split = prof["dense_split_ms"]
        print(f"    profile dac kernel: dense units' snake(x) launches {split['snake']:.2f} ms, "
              f"conv launches {split['conv']:.2f} ms, pointwise launches "
              f"{split['pointwise']:.2f} ms per forward")
    xrt = 40.0 / (kernel_ms / 1e3)
    phase("dac serve", counts == want,
          f"{forwards} forwards (2x 4x10 s batch, 3x3 s padded to 4, process_audio 48k) and "
          f"from_codes of the warm batch; launches {counts} == {want}; served warm batch "
          f"{served_ms:.1f} ms (CUDA events; host {host_ms:.1f} ms); warm batch-4 10 s round "
          f"trip kernels {times['kernel']} ms, plain {times['plain']} ms; peak "
          f"{peak['kernel']:.2f} vs {peak['plain']:.2f} GB; {xrt:.1f}x realtime on {card}")
    return {"counts": counts, "forwards": forwards, "served_ms": served_ms, "host_ms": host_ms,
            "times_ms": times, "peak_gb": peak, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "xrt": xrt, "profile": prof}


def phase_dac_file(model, g, tmp: Path) -> None:
    """encode_to_file on the card writes the bytes the port on the CPU
    writes for the golden's codes; decode_from_file equals from_codes."""
    from neuralcodecs_tpu_torch.models.dac.dacfile import dac_file_bytes

    path = tmp / "golden.dac"
    model.encode_to_file(g["audio"], path)
    want = dac_file_bytes([g["codes"].astype(np.int32)], model.config)
    same = path.read_bytes() == want
    from_file = model.decode_from_file(path)
    direct = model.from_codes(g["codes"].astype(np.int32))
    close = torch.allclose(from_file, direct, rtol=1e-5, atol=1e-6)
    phase("dac file", same and close,
          f"encode_to_file == the CPU's dac_file_bytes of the golden codes ({len(want)} B): "
          f"{same}; decode_from_file vs from_codes within rtol 1e-5/atol 1e-6: {close} "
          f"(max|err| {float((from_file - direct).abs().max()):.2e})")


# ------------------------------------------------- chunked execution phase


CHUNK_AB_ROUNDS = 5  # alternating rounds a mode (order u c c u u c ...)
CHUNK_AB_CALLS = 3   # calls a round, timed together by CUDA events


def _unit_calls(model, run) -> list:
    """(unit, T, B) of every residual-unit call that ``run()`` makes."""
    calls: list = []
    handles = [u.register_forward_hook(
        lambda m, inp, out: calls.append((m, inp[0].shape[-1], inp[0].shape[0])))
        for u in _residual_units(model)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return calls


def _stage_inputs(model, run) -> list[torch.Tensor]:
    """Each RVQ stage's z_e [B, T, D] (its in_proj's output) in ``run()``."""
    z_e: list = []
    handles = [vq.in_proj.register_forward_hook(
        lambda m, inp, out: z_e.append(out.float().transpose(1, 2)))
        for vq in model.quantizer.quantizers]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return z_e


def _first_diffs_near_ties(got: list, want: list, z_e: list, codebooks: list,
                           strides: list) -> tuple[int, int, float]:
    """Codes of two runs per stage ([B, T_s], stage s pooling strides[s]
    frames): (codes that differ, first differences, their largest score
    gap). A first difference is one no earlier stage differs above (a flip
    changes the residual of every later stage there); each must lie within
    _compare_codes' near-tie tolerance on ``z_e`` (got's run), or this
    raises."""
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    b = got[-1].shape[0]
    upstream = torch.zeros(b, got[-1].shape[-1] * strides[-1], dtype=torch.bool,
                           device=got[0].device)
    n_diff = n_first = 0
    gap = 0.0
    for g, w, z, cb, s in zip(got, want, z_e, codebooks, strides):
        diff = g != w
        first = diff & ~upstream.reshape(b, -1, s).any(dim=-1)
        if bool(first.any()):
            k, gmax = _compare_codes(l2_normalize(z[first]), l2_normalize(cb), g[first],
                                     w[first])
            n_first, gap = n_first + k, max(gap, gmax)
        n_diff += int(diff.sum())
        upstream |= diff.repeat_interleave(s, dim=-1)
    return n_diff, n_first, gap


def _chunked_vs_unchunked(label: str, model, a: torch.Tensor, n: int) -> dict:
    """The chunked round trip (n windows) against the unchunked one on the
    same padded batch, noise off: codes equal except first differences at
    near ties, audio above 55 dB SNR."""
    out: dict = {}
    z_e = _stage_inputs(model, lambda: out.update(chunked=model._forward_chunked_fn(a, None, n)))
    ref = model._forward_fn(a, None)
    if isinstance(ref, dict):  # DAC: codes [B, Nq, F], every stage at stride 1
        got = [out["chunked"]["codes"][:, i] for i in range(ref["codes"].shape[1])]
        want = [ref["codes"][:, i] for i in range(ref["codes"].shape[1])]
        audio, ref_audio, strides = out["chunked"]["audio"], ref["audio"], [1] * len(got)
    else:
        (audio, got), (ref_audio, want) = out["chunked"], ref
        strides = list(model.config.vq_strides)
    codebooks = [vq.codebook.weight for vq in model.quantizer.quantizers]
    n_diff, n_first, gap = _first_diffs_near_ties(got, want, z_e, codebooks, strides)
    snr = _snr_db(ref_audio.cpu().numpy().ravel(), audio.cpu().numpy().ravel())
    total = sum(c.numel() for c in want)
    phase(f"{label} chunked vs unchunked", snr > 55.0 and bool(torch.isfinite(audio).all()),
          f"n = {n} at {tuple(a.shape)}: codes that differ {n_diff} of {total}, each first "
          f"difference at a near-tie ({n_first}, max score gap {gap:.2e}); SNR {snr:.1f} dB "
          f"(> 55), max|err| {float((audio - ref_audio).abs().max()):.2e}")
    return {"n": n, "codes_differ": n_diff, "first_near_ties": n_first, "max_gap": gap,
            "codes": total, "snr_db": snr}


def _units_kernel_ms(cases: list) -> float:
    """Summed kernel time of fused_residual_unit over (unit, T, B) cases."""
    from neuralcodecs_tpu_torch.ops.kernels.resunit import fused_residual_unit

    total = 0.0
    for unit, t, b in cases:
        args = _unit_args(unit)
        x = torch.randn(b, args[0].shape[1], t, device=args[1].device)
        total += time_ms(lambda: fused_residual_unit(x, *args, dilation=unit.dilation), 10, 2)
    return total


def _profile_delta(call, n_chunked: int, kernel: str, launches: int, wall_ms: dict) -> dict:
    """torch.profiler's device time of ``call(n)`` at n = 1 and n_chunked
    (3 calls each), and the kernels whose time a call changes most."""
    profs = {mode: _device_profile(lambda n=n: call(n), wall_ms[mode], kernel, launches)
             for mode, n in (("unchunked", 1), ("chunked", n_chunked))}
    ms = {mode: {k: t for k, t, _ in prof["top"]} for mode, prof in profs.items()}
    keys = set(ms["unchunked"]) | set(ms["chunked"])
    delta = sorted(((ms["chunked"].get(k, 0.0) - ms["unchunked"].get(k, 0.0), k) for k in keys),
                   key=lambda d: -abs(d[0]))[:6]
    return {"device_ms": {m: p["device_ms"] for m, p in profs.items()},
            "idle": {m: p["idle"] for m, p in profs.items()},
            "delta_ms": [(k[:60], d) for d, k in delta]}


def _chunk_ab(label: str, call, n_chunked: int) -> dict:
    """Alternating rounds of ``call(n)`` unchunked (n = 1) and chunked
    (n = n_chunked windows): ms a call by CUDA events, each mode's median
    and spread (max - min over its rounds) and launches a call. Chunked
    wins if its median is lower by more than the larger spread."""
    from neuralcodecs_tpu_torch.ops import kernels

    n_of = {"unchunked": 1, "chunked": n_chunked}
    times: dict = {"unchunked": [], "chunked": []}
    launches = {}
    for mode, n in n_of.items():
        call(n)  # warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        call(n)
        torch.cuda.synchronize()
        launches[mode] = {k: v for k, v in kernels.launch_counts().items() if v}
    order = [("unchunked", "chunked"), ("chunked", "unchunked")]
    for r in range(CHUNK_AB_ROUNDS):
        for mode in order[r % 2]:
            times[mode].append(time_ms(lambda n=n_of[mode]: call(n), CHUNK_AB_CALLS, 0))
    med = {m: float(np.median(t)) for m, t in times.items()}
    spread = {m: max(t) - min(t) for m, t in times.items()}
    wins = med["chunked"] < med["unchunked"] and \
        med["unchunked"] - med["chunked"] > max(spread.values())
    print(f"    chunked A/B {label}: n = {n_chunked}; unchunked median "
          f"{med['unchunked']:.3f} ms (spread {spread['unchunked']:.3f}), chunked "
          f"{med['chunked']:.3f} ms (spread {spread['chunked']:.3f}), "
          f"{(med['chunked'] / med['unchunked'] - 1) * 100:+.2f}%; chunked wins: {wins}; "
          f"launches a call {launches['unchunked']} / {launches['chunked']}")
    return {"n": n_chunked, "times_ms": times, "median_ms": med, "spread_ms": spread,
            "chunked_wins": wins, "launches": launches}


def phase_chunked(snac, dac, gen: torch.Generator, card: str) -> dict:
    """Chunked execution on the card (SNAC-24k and DAC-44k, the served
    models): kernels 2a and 2b against their plain chains at the windows'
    (unit, T, B) shapes of a chunked 4 x 10 s round trip; chunked against
    unchunked at 4 x 10 s (codes up to near ties, SNR > 55 dB); the chunked
    round trips and DAC's chunked decode driven once with the launch
    counters (each kernel as often as unchunked); then the A/B of
    alternating rounds at n = 1 and at JAX's chunk count, of the round trip
    at 4 x 10 s and 4 x 3 s and of DAC's decode of codes at Dia's vocoder
    shapes ([4, 9, 862] and a [1, 9, 49] segment)."""
    from neuralcodecs_tpu_torch.ops import kernels

    t0 = time.time()
    rng = np.random.default_rng(SEED + 17)
    batches = {}
    for name, model in (("snac", snac), ("dac", dac)):
        sr = model.config.sample_rate
        for sec in (10, 3):
            x = torch.from_numpy((0.3 * rng.standard_normal((4, sec * sr))).astype(np.float32))
            batches[name, sec] = x.to(DEVICE)
    cb_size = dac.config.codebook_size
    vocode = {shape: torch.from_numpy(rng.integers(0, cb_size, shape).astype(np.int32)).to(DEVICE)
              for shape in ((4, dac.config.n_codebooks, 862), (1, dac.config.n_codebooks, 49))}

    res: dict = {}
    # kernels 2a / 2b at the windows' shapes
    for name, model, label in (("snac", snac, "chunked resunit"),
                               ("dac", dac, "chunked resunit dense")):
        a, _ = model._prepare(batches[name, 10])
        n = model._auto_chunks(a.shape[-1] if name == "snac" else a.shape[-1] // model.hop_length)
        res[f"{name}_check"] = _chunked_vs_unchunked(name, model, a, n)
        cases = _unit_calls(model, lambda: model._forward_chunked_fn(a, None, n))
        units = _hold_resunits(label, cases, len(cases), gen)
        units["unchunked_ms"] = _units_kernel_ms(
            _unit_calls(model, lambda: model._forward_fn(a, None)))
        phase(f"{label} kernel vs plain", not units["mismatches"],
              f"{len(cases)} units of a chunked 4 x 10 s round trip (n = {n}, B = "
              f"{sorted({b for _, _, b in cases})}) within rtol 1e-4/atol 1e-5 (max|err| "
              f"{units['max_abs_err']:.2e}); kernel {units['ms']:.2f} ms (the unchunked round "
              f"trip's units {units['unchunked_ms']:.2f} ms), plain {units['plain_ms']:.2f} ms, "
              f"bound {units['bound_ms']:.2f} ms ({units['bound_by']})"
              + (f"; mismatches {units['mismatches']}" if units["mismatches"] else ""))
        res[f"{name}_units"] = units

    # the chunked round trips and vocoder decode, counted
    snac_a = snac._prepare(batches["snac", 10])[0]
    dac_a = dac._prepare(batches["dac", 10])[0]
    voc_codes = vocode[4, dac.config.n_codebooks, 862]
    n_of = {"snac": snac._auto_chunks(snac_a.shape[-1]),
            "dac": dac._auto_chunks(dac_a.shape[-1] // dac.hop_length),
            "vocoder": dac._auto_chunks(voc_codes.shape[-1])}
    kernels.reset_launch_counts()
    snac_out, snac_codes = snac._forward_chunked_fn(snac_a, snac._noise_generator(gen),
                                                    n_of["snac"])
    dac_out = dac._forward_chunked_fn(dac_a, None, n_of["dac"])
    voc = dac._decode_chunked_fn(dac.quantizer.from_codes(voc_codes), n_of["vocoder"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {**_NO_LAUNCHES, "codebook_argmin": len(snac_codes) + dac.config.n_codebooks,
            "fused_residual_unit": len(_residual_units(snac)),
            "fused_residual_unit_dense": len(_residual_units(dac))
            + len(_residual_units(dac.decoder))}
    shapes_ok = (tuple(snac_out.shape) == tuple(snac_a.shape)
                 and tuple(dac_out["audio"].shape) == tuple(dac_a.shape)
                 and tuple(voc.shape) == (4, 1, 862 * dac.hop_length)
                 and all(bool(torch.isfinite(t).all()) for t in (snac_out, dac_out["audio"], voc)))
    phase("chunked paths", counts == want and shapes_ok and min(n_of.values()) > 1,
          f"SNAC and DAC round trips at 4 x 10 s and DAC's decode of [4, 9, 862] codes, chunked "
          f"(n {n_of}): launches {counts} == {want}; shapes and finite: {shapes_ok}")
    res["counts"] = counts

    # the A/B at n = 1 and at JAX's chunk count
    ab = {}
    for name, model in (("snac", snac), ("dac", dac)):
        for sec in (10, 3):
            a = model._prepare(batches[name, sec])[0]
            if name == "snac":
                n = model._auto_chunks(a.shape[-1])
                call = lambda n, a=a: snac._forward_chunked_fn(a, snac._noise_generator(gen), n)
            else:
                n = model._auto_chunks(a.shape[-1] // model.hop_length)
                call = lambda n, a=a: dac._forward_chunked_fn(a, None, n)
            ab[f"{name}_4x{sec}s"] = _chunk_ab(f"{name} round trip 4 x {sec} s", call, n)
            if sec == 10:  # where the chunked round trip's time goes
                kernel = "resunit_gemm" if name == "dac" else "depthwise_rows"
                prof = _profile_delta(call, n, kernel, len(_residual_units(model)) * (
                    2 if name == "dac" else 1), ab[f"{name}_4x{sec}s"]["median_ms"])
                ab[f"{name}_4x{sec}s"]["profile"] = prof
                print(f"    chunked profile {name} 4 x 10 s: device {prof['device_ms']} ms, "
                      f"idle {prof['idle']}; largest changes a call (chunked - unchunked, ms): "
                      + ", ".join(f"{k} {d:+.3f}" for k, d in prof["delta_ms"]))
    for shape, codes in vocode.items():
        ab[f"dac_from_codes_{list(shape)}"] = _chunk_ab(
            f"dac from_codes {list(shape)}",
            lambda n, codes=codes: dac._decode_chunked_fn(dac.quantizer.from_codes(codes), n),
            dac._auto_chunks(shape[-1]))
    res["ab"] = ab
    res["chunked_wins"] = {name: ab[f"{name}_4x10s"]["chunked_wins"] for name in ("snac", "dac")}
    res["seconds"] = time.time() - t0
    phase("chunked", True,
          "chunked median lower at 4 x 10 s by more than either spread: "
          + ", ".join(f"{k} {v}" for k, v in res["chunked_wins"].items())
          + f" (the public paths run n = 1, PERF.md §5); {res['seconds']:.1f} s on {card}")
    return res


# ------------------------------------------------------- DAC training phase


TRAIN_STEPS = 5          # GAN steps a path in the kernel-vs-plain trajectories
# the trajectories' optimizer: SGD, whose step is lr · g. Adam normalises
# each element's step, so an element whose gradient is near zero moves by a
# whole lr in a direction set by rounding, and two paths that agree to 1e-4
# in their gradients drift apart step by step (default AdamW: the losses
# 2.3e-3 apart by step 5, the first step's within 2.6e-7)
TRAIN_SGD_LR = 1e-3
TRAIN_TIMED = 10         # timed GAN steps, after 2 warm-up steps
# candidate seeds of the trained DAC-44k: the first whose mel-loss gradient is
# stable (see _mel_sensitivity) is used
TRAIN_SEEDS = (SEED + 20, SEED + 21, SEED + 22, SEED + 23)
MEL_STABLE = 1e-4
TRAIN_GRAD_BAR = 1e-3    # ‖g_kernel − g_plain‖ / ‖g_plain‖ per tensor


def _train_batch(tmp: Path, sr: int, hop: int) -> tuple[torch.Tensor, float]:
    """One batch of AudioCropDataset's defaults (8 x 0.5 s) from four seeded
    3 s WAVs, through prefetch, padded to the hop: ([8, 22528, 1] on the
    card, seconds of audio in the batch)."""
    import wave

    from neuralcodecs_tpu_torch.parallel import AudioCropDataset, prefetch

    rng = np.random.default_rng(SEED + 30)
    wav_dir = tmp / "train_wavs"
    wav_dir.mkdir(exist_ok=True)
    t = np.arange(3 * sr) / sr
    for i in range(4):
        tone = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 2000) * t)
        data = np.clip(tone + 0.05 * rng.standard_normal(t.shape), -1, 1)
        with wave.open(str(wav_dir / f"clip{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes((data * 32767).astype("<i2").tobytes())
    dataset = AudioCropDataset(wav_dir, sr, seed=SEED, loop=False)
    batch = next(prefetch(iter(dataset)))
    seconds = batch.shape[0] * batch.shape[1] / sr
    padded = np.pad(batch, ((0, 0), (0, -batch.shape[1] % hop), (0, 0)))
    return torch.from_numpy(padded).to(DEVICE), seconds


def _mel_sensitivity(model, audio: torch.Tensor) -> float:
    """‖Δg‖ / ‖g‖ of the mel loss's gradient at the model's output when that
    output moves by one ulp. Where it is large (mel bins at the FFT's
    rounding floor, whose log10 gradient amplifies f32 rounding), two paths
    that differ by rounding cannot agree to TRAIN_GRAD_BAR in their gradients
    whatever their kernels do."""
    from neuralcodecs_tpu_torch.losses import mel_spectrogram_loss
    from neuralcodecs_tpu_torch.parallel.train import channels_first

    real = audio[..., 0]
    with torch.no_grad():
        fake = model._forward_fn(channels_first(audio), None)["audio"][:, 0]

    def grad(x):
        x = x.clone().requires_grad_()
        with torch.enable_grad():
            loss = mel_spectrogram_loss(x, real, model.config.sample_rate, n_mels=(80, 20),
                                        window_lengths=(512, 128))
            return torch.autograd.grad(loss, x)[0]

    g = grad(fake)
    g_ulp = grad(torch.nextafter(fake, torch.full_like(fake, math.inf)))
    return float((g_ulp - g).norm() / g.norm())


def _snapshot(module) -> dict:
    return {k: p.detach().clone() for k, p in module.state_dict().items()}


def _grads(*modules) -> dict:
    return {f"{i}.{k}": p.grad.detach().clone() for i, m in enumerate(modules)
            for k, p in m.named_parameters()}


def _gan_run(model, disc, start: tuple, audio: torch.Tensor, steps: int) -> tuple[list, dict]:
    """``steps`` GAN steps from the weights ``start``, SGD (TRAIN_SGD_LR) on
    both sides: (each step's metrics as floats, the first step's
    gradients)."""
    from neuralcodecs_tpu_torch.parallel import make_gan_train_step

    model.load_state_dict(start[0])
    disc.load_state_dict(start[1])
    sgd = functools.partial(torch.optim.SGD, lr=TRAIN_SGD_LR)
    init_fn, step_fn = make_gan_train_step(model, disc, None, sgd, sgd)
    states, metrics, first = init_fn(), [], None
    for i in range(steps):
        states, m = step_fn(states, audio)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = _grads(model, disc)
    return metrics, first


def _code_flips(model, audio: torch.Tensor) -> dict:
    """The codes of one forward with the kernels against the plain versions
    at the same weights; each differing code's top-2 score gap (plain)."""
    from neuralcodecs_tpu_torch.parallel.train import channels_first

    x = channels_first(audio)
    with torch.no_grad():
        out = model._forward_fn(x, None)
        with _plain_kernels():
            want = model._forward_fn(x, None)
    differ = torch.nonzero(out["codes"] != want["codes"]).tolist()
    gaps = _dac_top2_gaps(model, want["latents"].transpose(1, 2))
    flips = []
    for b, stage, f in differ:
        frame = b * out["codes"].shape[-1] + f
        flips.append({"row": b, "stage": stage, "frame": f,
                      "kernel": int(out["codes"][b, stage, f]),
                      "plain": int(want["codes"][b, stage, f]),
                      "gap": float(gaps[stage][frame])})
        print(f"    dac train codes: row {b} stage {stage} frame {f}: kernel "
              f"{flips[-1]['kernel']}, plain {flips[-1]['plain']}, top-2 gap "
              f"{flips[-1]['gap']:.3e}")
    return {"codes": int(out["codes"].numel()), "flips": flips}


def _stale_splits(model, audio: torch.Tensor) -> list:
    """After one more forward in grad mode, the dense units' weights whose
    kept TF32 split (resunit._packed) differs from a fresh split of the
    weight as it is now."""
    from neuralcodecs_tpu_torch.ops.kernels.resunit import (
        pack_conv_weights, pack_pointwise_weights)
    from neuralcodecs_tpu_torch.parallel.train import channels_first

    with torch.enable_grad():
        model._forward_fn(channels_first(audio), None)
    stale = []
    for i, unit in enumerate(_residual_units(model)):
        _, conv, _, pointwise = unit.block
        for w, pack in ((conv.weight, pack_conv_weights),
                        (pointwise.weight, pack_pointwise_weights)):
            kept = getattr(w, "_nc_packed", (None, (None, None)))[1]
            if not all(k is not None and torch.equal(k, f)
                       for k, f in zip(kept, pack(w.detach()))):
                stale.append((i, tuple(w.shape)))
    return stale


def _train_units(model, audio: torch.Tensor, gen: torch.Generator) -> dict:
    """Kernel 2b at the 24 unit shapes of the training batch: the inference
    form, the training form (out, h, z, y held to residual_unit_train_plain
    within rtol 1e-4 / atol 1e-5) and the Function's backward (held to
    autograd of the plain chain, ‖Δg‖ / ‖g‖ <= 1e-3 per input), each timed
    by CUDA events; the plain chain's forward + backward beside them."""
    from neuralcodecs_tpu_torch.ops.kernels.resunit import (
        DenseResidualUnitFn, _dense_train_forward, fused_residual_unit, residual_unit_plain,
        residual_unit_train_plain)

    units = _residual_units(model)
    with torch.no_grad():
        lengths = _unit_lengths(model, audio.shape[1])
    rows, bad = [], []
    for unit, t in zip(units, lengths):
        args = tuple(a.detach() for a in _unit_args(unit))
        c, d = args[0].shape[1], unit.dilation
        x = torch.randn(audio.shape[0], c, t, generator=gen, device=DEVICE)
        g = torch.randn(x.shape, generator=gen, device=DEVICE)
        with torch.no_grad():
            got = _dense_train_forward(x, args, d)
            want = residual_unit_train_plain(x, *args, dilation=d)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(got, want))
        inputs = [x.clone().requires_grad_(), *(a.clone().requires_grad_() for a in args)]
        with torch.enable_grad():
            out = DenseResidualUnitFn.apply(*inputs, d)
            dk = torch.autograd.grad(out, inputs, g)
            out_p = residual_unit_plain(*inputs, dilation=d)
            dp = torch.autograd.grad(out_p, inputs, g)
        grad_err = max(float((a - b).norm() / b.norm()) for a, b in zip(dk, dp))
        ok = ok and grad_err <= TRAIN_GRAD_BAR
        with torch.no_grad():
            infer_ms = time_ms(lambda: fused_residual_unit(x, *args, dilation=d), 10, 2)
            train_ms = time_ms(lambda: _dense_train_forward(x, args, d), 10, 2)
        with torch.enable_grad():
            out = DenseResidualUnitFn.apply(*inputs, d)
            bwd_ms = time_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True),
                             5, 1)
            plain_ms = time_ms(lambda: torch.autograd.grad(
                residual_unit_plain(*inputs, dilation=d), inputs, g), 5, 1)
        rows.append({"C": c, "dilation": d, "T": t, "B": x.shape[0], "inference_ms": infer_ms,
                     "train_ms": train_ms, "backward_ms": bwd_ms,
                     "plain_fwd_bwd_ms": plain_ms, "max_abs_err": max(errs),
                     "grad_rel_err": grad_err})
        if not ok:
            bad.append((c, d, t, errs, grad_err))
        print(f"    dac train unit C={c} d={d} T={t} B={x.shape[0]}: inference form "
              f"{infer_ms:.3f} ms, training form {train_ms:.3f} ms, backward {bwd_ms:.3f} ms; "
              f"plain forward + backward {plain_ms:.3f} ms; max|err| (out, h, z, y) "
              f"{max(errs):.2e}, backward rel. err {grad_err:.2e}"
              + ("" if ok else "  MISMATCH"))
    total = {k: sum(r[k] for r in rows) for k in ("inference_ms", "train_ms", "backward_ms",
                                                  "plain_fwd_bwd_ms")}
    return {"rows": rows, "mismatches": bad, **total}


def _no_backward_raises() -> dict:
    """Kernels 2a, 3, 4 and 5, called on the card in grad mode with an input
    that requires grad: each must raise, and launch nothing."""
    from neuralcodecs_tpu_torch.models.layers import ResidualUnit
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t
    from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow
    from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan
    from neuralcodecs_tpu_torch.ops.kernels.resunit import fused_residual_unit

    unit = ResidualUnit(64, dilation=3, groups=64).to(DEVICE)
    h = 512
    calls = {
        "fused_residual_unit": lambda: fused_residual_unit(
            torch.randn(1, 64, 1024, device=DEVICE, requires_grad=True), *_unit_args(unit),
            dilation=3),
        "lstm_scan": lambda: lstm_scan(
            torch.randn(4, 1, 4 * h, device=DEVICE, requires_grad=True),
            torch.randn(4 * h, h, device=DEVICE), torch.zeros(1, h, device=DEVICE),
            torch.zeros(1, h, device=DEVICE)),
        "envelope_follow": lambda: envelope_follow(
            torch.rand(2, 1000, device=DEVICE, requires_grad=True), 0.5, 0.99),
        "biquad_df2t": lambda: biquad_df2t(
            torch.randn(2, 1000, device=DEVICE, requires_grad=True),
            [((0.5, 0.2, 0.1), (1.0, -0.3, 0.1))]),
    }
    raised = {}
    kernels.reset_launch_counts()
    with torch.enable_grad():
        for name, call in calls.items():
            try:
                call()
                raised[name] = "returned"
            except RuntimeError as e:
                raised[name] = str(e) if "no backward" in str(e) else f"other error: {e}"
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ok = all("no backward" in v and not v.startswith("other") for v in raised.values())
    phase("kernels without a backward raise under grad", ok and counts == _NO_LAUNCHES,
          f"{ {k: ('raised' if 'no backward' in v else v) for k, v in raised.items()} }; "
          f"launches {counts}")
    return raised


def _gen_step(model, start, audio: torch.Tensor, remat: bool) -> dict:
    """make_train_step at ``remat``: the first step's gradients from the
    weights ``start``, then ms a step (CUDA events, 3 after 1 warm-up) and
    peak memory of a step."""
    from neuralcodecs_tpu_torch.parallel import make_train_step

    model.load_state_dict(start)
    init_fn, step_fn = make_train_step(model, remat=remat)
    state, loss = step_fn(init_fn(), audio)
    grads = _grads(model)
    state, _ = step_fn(state, audio)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(lambda: step_fn(state, audio), 3, 0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return {"loss": float(loss), "grads": grads, "ms": ms, "peak_gb": peak}


def _step_profile(step, wall_ms: float, reps: int = 2) -> dict:
    """torch.profiler over ``reps`` warm GAN steps: device ms a step, idle
    share against the unprofiled wall time, and the shares of the device
    time launched by the backward (autograd's evaluate_function ops) and
    by the optimizers."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
        for _ in range(1 + reps):
            step()
            torch.cuda.synchronize()
            prof.step()
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # device kernels only: the step's own ranges (ProfilerStep, user
    # annotations) also appear on the device timeline and span the kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("ProfilerStep")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    backward_ms = sum(e.device_time_total for e in events
                      if e.key.startswith("autograd::engine::evaluate_function")) / 1e3 / reps
    optim_ms = sum(e.device_time_total for e in events
                   if e.key.startswith("Optimizer.step")) / 1e3 / reps
    top = [(e.key, e.self_device_time_total / 1e3 / reps)
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]]
    return {"device_ms": device_ms, "idle": 1.0 - device_ms / wall_ms,
            "backward_ms": backward_ms, "backward_share": backward_ms / device_ms,
            "optimizer_ms": optim_ms, "optimizer_share": optim_ms / device_ms, "top": top}


def phase_dac_train(tmp: Path, card: str, gen: torch.Generator) -> dict:
    """DAC-44k GAN training at full width (DACConfig(), 76.6 M parameters,
    with DACDiscriminator() at its defaults) on a batch of 8 x 0.5 s from
    AudioCropDataset, through make_gan_train_step and make_train_step: the
    first step's losses and every gradient with the kernels against the
    plain versions from the same weights (codes that differ only at
    near-ties), 5-step loss trajectories under SGD, timing, launches,
    profile and peak memory under AdamW, the units' kept weight splits
    equal to fresh ones after the optimizer's in-place updates, the generator-only step with and without remat, kernel 2b's
    training form and backward at the batch's 24 unit shapes, and the
    kernels without a backward raising under grad."""
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
    from neuralcodecs_tpu_torch.models.dac.discriminator import DACDiscriminator
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.parallel import make_gan_train_step

    t_phase = time.time()
    cfg = DACConfig()
    audio, seconds = _train_batch(tmp, cfg.sample_rate, cfg.hop_length)
    tried = {}
    for seed in TRAIN_SEEDS:
        model = DAC(cfg, device=DEVICE, seed=seed)
        tried[seed] = _mel_sensitivity(model, audio)
        if tried[seed] < MEL_STABLE:
            break
    print(f"    dac train: mel-gradient sensitivity to one ulp of the output by seed "
          f"{tried} (stable below {MEL_STABLE})")
    if tried[seed] >= MEL_STABLE:
        raise PhaseError(f"no candidate seed with a stable mel gradient: {tried}")
    disc = DACDiscriminator(device=DEVICE, seed=SEED + 24)
    n_g = sum(p.numel() for p in model.parameters())
    n_d = sum(p.numel() for p in disc.parameters())
    start = (_snapshot(model), _snapshot(disc))
    res = {"seed": seed, "mel_sensitivity": tried, "params": n_g, "disc_params": n_d,
           "batch": list(audio.shape), "audio_s": seconds}
    with torch.enable_grad():
        res["codes"] = _code_flips(model, audio)
        # the main path: the kernel trajectory, counted
        kernels.reset_launch_counts()
        k_metrics, k_grads = _gan_run(model, disc, start, audio, TRAIN_STEPS)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        with _plain_kernels():
            p_metrics, p_grads = _gan_run(model, disc, start, audio, TRAIN_STEPS)
        loss_err = max(abs(k[key] - p[key]) / abs(p[key]) for k, p in zip(k_metrics, p_metrics)
                       for key in k)
        first_err = max(abs(k_metrics[0][key] - p_metrics[0][key]) / abs(p_metrics[0][key])
                        for key in k_metrics[0])
        grad_errs = {key: float((k_grads[key] - g).norm() / g.norm())
                     for key, g in p_grads.items()}
        worst = max(grad_errs, key=grad_errs.get)
        del k_grads, p_grads
        flips_ok = all(f["gap"] < 1e-5 for f in res["codes"]["flips"])
        want = {**_NO_LAUNCHES, "codebook_argmin": cfg.n_codebooks * TRAIN_STEPS,
                "fused_residual_unit_dense": len(_residual_units(model)) * TRAIN_STEPS}
        for i, (k, p) in enumerate(zip(k_metrics, p_metrics)):
            print(f"    dac train step {i + 1}: kernels {k}; plain {p}")
        res.update({"counts": counts, "kernel_metrics": k_metrics, "plain_metrics": p_metrics,
                    "first_step_rel_err": first_err, "trajectory_rel_err": loss_err,
                    "grad_rel_err_max": grad_errs[worst], "grad_rel_err_worst": worst,
                    "grad_tensors": len(grad_errs)})
        phase("dac train kernels vs plain",
              first_err <= 1e-4 and grad_errs[worst] <= TRAIN_GRAD_BAR and loss_err <= 1e-3
              and flips_ok and counts == want,
              f"seed {seed}; first GAN step's 6 losses within {first_err:.2e} (<= 1e-4), "
              f"{len(grad_errs)} gradient tensors (G {n_g / 1e6:.1f} M + D {n_d / 1e6:.1f} M "
              f"parameters) within {grad_errs[worst]:.2e} (<= {TRAIN_GRAD_BAR}; worst "
              f"{worst}); {TRAIN_STEPS}-step SGD (lr {TRAIN_SGD_LR}) trajectories within "
              f"{loss_err:.2e} (<= 1e-3); "
              f"codes differing {len(res['codes']['flips'])} of {res['codes']['codes']}, all "
              f"at top-2 gaps < 1e-5: {flips_ok}; launches {counts} == {want}")

        # timing: the kernel path from where its trajectory ended
        init_fn, step_fn = make_gan_train_step(model, disc)
        states = [init_fn()]

        def step():
            states[0], _ = step_fn(states[0], audio)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        step_ms = time_ms(step, TRAIN_TIMED, 0)
        per_step = {k: v // TRAIN_TIMED for k, v in kernels.launch_counts().items() if v}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = _step_profile(step, step_ms)
        stale = _stale_splits(model, audio)
        with _plain_kernels():
            plain_step_ms = time_ms(step, 3, 1)
        res.update({"step_ms": step_ms, "audio_s_per_s": seconds / (step_ms / 1e3),
                    "peak_gb": peak_gb, "launches_per_step": per_step, "profile": prof,
                    "plain_step_ms": plain_step_ms, "stale_splits": stale})
        print(f"    dac train profile: device {prof['device_ms']:.1f} ms a step, idle "
              f"{prof['idle']:.1%}; backward {prof['backward_ms']:.1f} ms "
              f"({prof['backward_share']:.1%}), optimizers {prof['optimizer_ms']:.1f} ms "
              f"({prof['optimizer_share']:.1%}); top: " + ", ".join(
                  f"{k[:40]} {ms:.1f}" for k, ms in prof["top"][:5]))
        phase("dac train step", not stale and per_step.get("codebook_argmin") ==
              cfg.n_codebooks and per_step.get("fused_residual_unit_dense") == 24,
              f"GAN step at 8 x 0.5 s (AdamW): {step_ms:.1f} ms (CUDA events, {TRAIN_TIMED} "
              f"steps), "
              f"{res['audio_s_per_s']:.1f} s of audio trained a s, peak {peak_gb:.2f} GB; "
              f"launches a step {per_step}; after {TRAIN_TIMED + 5} in-place AdamW updates "
              f"the kept weight splits of the 24 units equal fresh ones (stale: "
              f"{stale or 'none'}); plain versions {plain_step_ms:.1f} ms a step (for scale); "
              f"on {card}")

        # the generator-only step, without and with remat
        gen_steps = {remat: _gen_step(model, start[0], audio, remat) for remat in (False, True)}
        remat_err = max(float((gen_steps[True]["grads"][k] - g).norm() / g.norm())
                        for k, g in gen_steps[False]["grads"].items())
        res["gen_step"] = {("remat" if r else "no_remat"): {k: v for k, v in s.items()
                                                            if k != "grads"}
                           for r, s in gen_steps.items()}
        res["gen_step"]["remat_grad_rel_err"] = remat_err
        phase("dac train generator step, remat", remat_err <= 1e-5,
              f"make_train_step at 8 x 0.5 s: {gen_steps[False]['ms']:.1f} ms, peak "
              f"{gen_steps[False]['peak_gb']:.2f} GB; remat {gen_steps[True]['ms']:.1f} ms, "
              f"peak {gen_steps[True]['peak_gb']:.2f} GB; gradients equal within "
              f"{remat_err:.2e} (<= 1e-5)")
        del gen_steps

        units = _train_units(model, audio, gen)
        res["units"] = units
        phase("resunit dense training form and backward", not units["mismatches"],
              f"24 unit shapes of the batch: inference form {units['inference_ms']:.2f} ms, "
              f"training form {units['train_ms']:.2f} ms, backward {units['backward_ms']:.2f} "
              f"ms; plain forward + backward {units['plain_fwd_bwd_ms']:.2f} ms"
              + (f"; mismatches {units['mismatches']}" if units["mismatches"] else ""))
    res["no_backward"] = _no_backward_raises()
    res["seconds"] = time.time() - t_phase
    print(f"    dac train phase: {res['seconds']:.1f} s")
    return res


# ----------------------------------------------------------- Dia phases


# a greedy code may differ between the card and the CPU only where the two
# best logits of its step lie closer than this: at full width f32 sums in
# other orders move a logit by up to 4.6e-4 (measured on an H100), and
# CFG (cond + 3 (cond - uncond)) scales a difference by up to 7
DIA_NEAR_TIE = 1e-2
# the card's f32 error against the f64 port may be this many times the CPU
# f32 port's; the same model with TF32 products must exceed it
DIA_F64_FACTOR = 4.0
# tests/make_goldens.py's DIA_LADDER_TEXTS / DIA_LADDER_KW
DIA_LADDER_TEXTS = ["[S1]serving ladder golden", "[S2]second row"]
DIA_LADDER_KW = dict(max_tokens=64, seed=11)
# four two-speaker lines of 60-120 characters (the text bucket is 128 for
# each alone and for all four)
DIA_TEXTS = [
    "[S1] Did you hear the rain last night? [S2] I did, it kept me up until two.",
    "[S1] The train leaves at nine fifteen. [S2] Then we should pack the bags tonight, "
    "not tomorrow.",
    "[S1] Can you read the numbers back to me? [S2] Four, eight, fifteen, sixteen, "
    "twenty-three.",
    "[S1] Welcome back to the show. [S2] Thanks, it is good to be here again after a year.",
]
DIA_SERVE_KW = dict(max_tokens=512, pad_tokens_to=1024, seed=SEED)  # cli/serve.py's bucket


# Dia's decode-attention shapes: the CFG batch of 4 requests (8 rows), 16
# query and 4 K/V heads of 128 in self-attention over the served 1024-slot
# buffer, 16 heads over the 256-position text bucket in cross-attention
ATTN_SHAPE = dict(b=8, nq=16, nkv=4, dh=128, max_t=1024, s=256)
ATTN_STEPS = (0, 1, 255, 511, 512, 1023)
ATTN_KERNELS = ("decode_self_attn", "decode_cross_attn")
ATTN_RING = 8  # layers' caches a timed pass cycles through, past the 50 MB L2


def _with_attn(want: dict, counts: dict) -> dict:
    """``want`` of a Dia path with the decode-attention kernels' entries:
    their counts as run where those are whole layers' worth of Dia 1.6B
    and the cross kernel ran (each step launches it once a layer, and the
    self kernel too on a float cache); None, which fails the check, where
    not. _dia_steps holds them to the layers exactly, a step at a time."""
    from neuralcodecs_tpu_torch.models.dia import DiaConfig

    layers = DiaConfig().decoder.n_layer
    ok = (0 < counts["decode_cross_attn"] and counts["decode_self_attn"] <= counts[
        "decode_cross_attn"] and all(counts[k] % layers == 0 for k in ATTN_KERNELS))
    return {**want, **{k: counts[k] if ok else None for k in ATTN_KERNELS}}


def _attn_case(gen: torch.Generator, dtype, b, nq, nkv, dh, max_t, s):
    """Seeded inputs of one layer's decode step: q, k, v (the projections'
    outputs), a self cache whose every slot holds values (those past the
    step must not be read), the cross cache with the text padding of the
    CFG batch (rows 2i every key masked, rows 2i+1 130-143 keys live) and
    its keys zeroed there, the timescale."""
    from neuralcodecs_tpu_torch.models.dia.layers import rope_timescale

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale).to(dtype)
    lengths = torch.randint(130, 144, (b,), generator=gen, device=DEVICE)
    lengths[0::2] = 0
    mask = (torch.arange(s, device=DEVICE)[None, :] < lengths[:, None])[:, None, :]
    ts = torch.from_numpy(rope_timescale(dh)).to(DEVICE, torch.promote_types(dtype, torch.float32))
    return {"q": rand(b, 1, nq, dh, scale=dh ** -0.5), "k": rand(b, 1, nkv, dh),
            "v": rand(b, 1, nkv, dh), "k_cache": rand(b, max_t, nkv, dh),
            "v_cache": rand(b, max_t, nkv, dh),
            "ck": rand(b, s, nq, dh) * mask[:, 0, :, None, None], "cv": rand(b, s, nq, dh),
            "cq": rand(b, 1, nq, dh, scale=dh ** -0.5), "mask": mask, "ts": ts}


def _attn_close(got: torch.Tensor, want: torch.Tensor, ref: torch.Tensor) -> dict:
    """The kernel's output ``got`` and the plain version's ``want`` against
    ``ref``, the plain version in f64 on the same inputs: the kernel is
    close when its largest error is at most twice the plain version's plus
    1e-6 of the largest value (the two sum in other orders, and in bf16 a
    rounded weight or output can land one step apart)."""
    g, w, r = got.double(), want.double(), ref.double()
    err, err_plain = float((g - r).abs().max()), float((w - r).abs().max())
    top = float(r.abs().max())
    return {"close": err <= 2.0 * err_plain + 1e-6 * top, "err": err, "err_plain": err_plain,
            "vs_plain": float((g - w).abs().max())}


def _f64(case: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v for k, v in case.items()}


def _attn_self_pair(case: dict, step: int, block: int = 512) -> dict:
    """The self kernel and its plain version (the blocked read of ``block``)
    at ``step`` on copies of one cache, and the plain version in f64: the
    outputs, and the caches the kernel and the plain version left."""
    from neuralcodecs_tpu_torch.models.dia.layers import KVCacheSlot
    from neuralcodecs_tpu_torch.ops.kernels.decode_attn import (decode_self_attn,
                                                                decode_self_attn_plain)

    b, max_t = case["q"].shape[0], case["k_cache"].shape[1]
    step_t = torch.tensor([step], dtype=torch.int64, device=DEVICE)
    pos = step_t.expand(b, 1)

    def run(fn, c, **kw):
        cache = KVCacheSlot(c["k_cache"].clone(), c["v_cache"].clone())
        return fn(c["q"], c["k"], c["v"], cache, pos, step_t, c["ts"], **kw), cache
    got, kern = run(decode_self_attn, case)
    want, plain = run(decode_self_attn_plain, case, block=block if max_t % block == 0 else 0,
                      n_blocks=step // block + 1)
    ref, _ = run(decode_self_attn_plain, _f64(case))
    return {**_attn_close(got, want, ref),
            "slot_exact": torch.equal(kern.k, plain.k) and torch.equal(kern.v, plain.v)}


def _attn_cross_pair(case: dict, position: int) -> dict:
    from neuralcodecs_tpu_torch.models.dia.layers import KVCacheSlot
    from neuralcodecs_tpu_torch.ops.kernels.decode_attn import (decode_cross_attn,
                                                                decode_cross_attn_plain)

    b = case["cq"].shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int64, device=DEVICE)

    def run(fn, c):
        return fn(c["cq"], KVCacheSlot(c["ck"], c["cv"]), c["mask"], pos, c["ts"])
    got, want = run(decode_cross_attn, case), run(decode_cross_attn_plain, case)
    masked = ~case["mask"][:, 0].any(dim=-1)
    return {**_attn_close(got, want, run(decode_cross_attn_plain, _f64(case))),
            "masked_rows_zero": bool((got[masked] == 0).all() and (want[masked] == 0).all()),
            "masked_rows": int(masked.sum())}


def _attn_graphed(case: dict) -> dict:
    """Each kernel captured once (ops/graphs.StepGraph) and replayed at
    several steps / positions set on the device, against its plain version
    there; the launch counters before and after."""
    from neuralcodecs_tpu_torch.models.dia.layers import KVCacheSlot
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.ops.graphs import StepGraph
    from neuralcodecs_tpu_torch.ops.kernels.decode_attn import (decode_cross_attn,
                                                                decode_cross_attn_plain,
                                                                decode_self_attn,
                                                                decode_self_attn_plain)

    b = case["q"].shape[0]
    step_t = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    pos = step_t.expand(b, 1)
    cache = KVCacheSlot(case["k_cache"].clone(), case["v_cache"].clone())
    cross = KVCacheSlot(case["ck"], case["cv"])
    kernels.reset_launch_counts()
    graph = StepGraph(lambda: (
        decode_self_attn(case["q"], case["k"], case["v"], cache, pos, step_t, case["ts"]),
        decode_cross_attn(case["cq"], cross, case["mask"], pos, case["ts"])))
    steps, ok, errs = (3, 64, 700, 1023, 200), True, []
    c64 = _f64(case)
    for step in steps:
        cache.k.copy_(case["k_cache"])
        cache.v.copy_(case["v_cache"])
        step_t.fill_(step)
        got_self, got_cross = graph.replay()
        plain = KVCacheSlot(case["k_cache"].clone(), case["v_cache"].clone())
        want_self = decode_self_attn_plain(case["q"], case["k"], case["v"], plain, pos, step_t,
                                           case["ts"], block=512, n_blocks=step // 512 + 1)
        ref_self = decode_self_attn_plain(
            c64["q"], c64["k"], c64["v"], KVCacheSlot(c64["k_cache"].clone(),
                                                      c64["v_cache"].clone()),
            pos, step_t, c64["ts"])
        want_cross = decode_cross_attn_plain(case["cq"], cross, case["mask"], pos, case["ts"])
        ref_cross = decode_cross_attn_plain(c64["cq"], KVCacheSlot(c64["ck"], c64["cv"]),
                                            c64["mask"], pos, c64["ts"])
        for got, want, ref in ((got_self, want_self, ref_self),
                               (got_cross, want_cross, ref_cross)):
            r = _attn_close(got, want, ref)
            ok, errs = ok and r["close"], errs + [r["err"]]
        ok = ok and torch.equal(cache.k, plain.k) and torch.equal(cache.v, plain.v)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    # one eager warm-up call, then one launch of each a replay
    want = {name: 1 + len(steps) for name in ATTN_KERNELS}
    return {"ok": ok and counts == want, "max_err": max(errs), "launches": counts,
            "want": want, "steps": steps}


def _graph_ms(call, n: int) -> float:
    """Device ms a call of ``call(i)``, i = 0 .. n-1 captured into one CUDA
    graph and replayed, as the step graphs run them (no host launch cost)."""
    for i in range(n):
        call(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            call(i)
    return time_ms(graph.replay, 20, 2) / n


def _attn_times(gen: torch.Generator, steps=(511, 1023)) -> dict:
    """Per layer, by CUDA events over graph replays (_graph_ms) of a ring of
    ATTN_RING layers' caches (colder than L2, as in the step, which streams
    every layer's cache between two visits): the self kernel at ``steps``
    and the cross kernel at Dia's bf16 shapes, each beside its plain
    version and its bound (the live K/V bytes it must read at 3.35 TB/s)."""
    from neuralcodecs_tpu_torch.models.dia.layers import KVCacheSlot
    from neuralcodecs_tpu_torch.ops.kernels.decode_attn import (decode_cross_attn,
                                                                decode_cross_attn_plain,
                                                                decode_self_attn,
                                                                decode_self_attn_plain)

    sh = ATTN_SHAPE
    cases = [_attn_case(gen, BF16, **sh) for _ in range(ATTN_RING)]
    slots = [KVCacheSlot(c["k_cache"], c["v_cache"]) for c in cases]
    crosses = [KVCacheSlot(c["ck"], c["cv"]) for c in cases]
    b, elt, n = sh["b"], 2, 4 * ATTN_RING
    res = {}
    for step in steps:
        step_t = torch.tensor([step], dtype=torch.int64, device=DEVICE)
        pos = step_t.expand(b, 1)

        def self_call(i, fn=decode_self_attn, **kw):
            c = cases[i % ATTN_RING]
            return fn(c["q"], c["k"], c["v"], slots[i % ATTN_RING], pos, step_t, c["ts"], **kw)
        nbytes = 2 * b * (step + 1) * sh["nkv"] * sh["dh"] * elt \
            + 2 * b * sh["nq"] * sh["dh"] * elt + 4 * b * sh["nkv"] * sh["dh"] * elt
        res[f"self_{step}"] = {
            "ms": _graph_ms(self_call, n),
            "plain_ms": _graph_ms(lambda i: self_call(i, decode_self_attn_plain, block=512,
                                                      n_blocks=step // 512 + 1), ATTN_RING),
            **bound(0.0, nbytes)}
    pos = torch.full((b, 1), 300, dtype=torch.int64, device=DEVICE)

    def cross_call(i, fn=decode_cross_attn):
        c = cases[i % ATTN_RING]
        return fn(c["cq"], crosses[i % ATTN_RING], c["mask"], pos, c["ts"])
    live = sum(int(c["mask"].sum()) for c in cases) / ATTN_RING   # live keys a layer
    nbytes = 2 * live * sh["nq"] * sh["dh"] * elt + 2 * b * sh["nq"] * sh["dh"] * elt
    res["cross"] = {"ms": _graph_ms(cross_call, n),
                    "plain_ms": _graph_ms(lambda i: cross_call(i, decode_cross_attn_plain),
                                          ATTN_RING),
                    "live_keys": live, **bound(0.0, nbytes)}
    return res


def phase_decode_attn(gen: torch.Generator, card: str) -> dict:
    """The decode-attention kernels against their plain versions on the
    card: at Dia's bf16 shapes (ATTN_SHAPE) at steps ATTN_STEPS (the slot
    written bit for bit as the plain version writes it) and in
    cross-attention with the CFG batch's padding (rows with every key
    masked exactly zero); in f32 and f64 at the first three steps; at the
    tiny configs' widths (self 4 / 2 heads of 8, cross 2 / 2 of 16); both
    captured into one graph and replayed at steps set on the device, the
    launch counters following the replays; the refusals (an int8 cache,
    half precision); then the times per layer (_attn_times)."""
    from neuralcodecs_tpu_torch.models.dia.layers import KVCacheSlot
    from neuralcodecs_tpu_torch.ops.kernels.decode_attn import decode_self_attn

    t0 = time.perf_counter()
    res, failures = {"self": {}, "cross": {}}, []
    for dtype, steps in ((BF16, ATTN_STEPS), (torch.float32, ATTN_STEPS[:3]),
                         (torch.float64, ATTN_STEPS[:3])):
        case = _attn_case(gen, dtype, **ATTN_SHAPE)
        name = str(dtype).split(".")[-1]
        for step in steps:
            r = res["self"][f"{name}_{step}"] = _attn_self_pair(case, step)
            if not (r["close"] and r["slot_exact"]):
                failures.append(f"self {name} step {step}: {r}")
        for position in (0, 511):
            r = res["cross"][f"{name}_{position}"] = _attn_cross_pair(case, position)
            if not (r["close"] and r["masked_rows_zero"]):
                failures.append(f"cross {name} at {position}: {r}")
    tiny = _attn_case(gen, torch.float32, b=4, nq=4, nkv=2, dh=8, max_t=64, s=16)
    for step in (0, 17, 63):
        r = res["self"][f"tiny_{step}"] = _attn_self_pair(tiny, step, block=16)
        if not (r["close"] and r["slot_exact"]):
            failures.append(f"self tiny step {step}: {r}")
    tiny = _attn_case(gen, torch.float32, b=4, nq=2, nkv=2, dh=16, max_t=64, s=16)
    tiny["mask"][1::2, :, 5:] = False
    r = res["cross"]["tiny"] = _attn_cross_pair(tiny, 7)
    if not (r["close"] and r["masked_rows_zero"]):
        failures.append(f"cross tiny: {r}")
    res["graphed"] = _attn_graphed(_attn_case(gen, BF16, **ATTN_SHAPE))
    if not res["graphed"]["ok"]:
        failures.append(f"graphed: {res['graphed']}")
    case = _attn_case(gen, BF16, b=2, nq=4, nkv=2, dh=8, max_t=64, s=16)
    step_t = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    refusals = {}
    for label, cache, q in (
            ("int8 cache", KVCacheSlot.zeros(2, 64, 2, 8, quantized=True, device=DEVICE),
             case["q"]),
            ("float16", KVCacheSlot(case["k_cache"].half(), case["v_cache"].half()),
             case["q"].half())):
        try:
            decode_self_attn(q, case["k"].to(q.dtype), case["v"].to(q.dtype), cache,
                             step_t.expand(2, 1), step_t, case["ts"])
            refusals[label] = "ran"
        except (TypeError, ValueError) as exc:
            refusals[label] = type(exc).__name__
    res["refusals"] = refusals
    if "ran" in refusals.values():
        failures.append(f"refusals: {refusals}")
    res["times"] = _attn_times(gen)
    res["seconds"] = time.perf_counter() - t0
    for key, t in res["times"].items():
        print(f"    decode attention {key}, a layer: kernel {t['ms'] * 1e3:.1f} us (bound "
              f"{t['bound_ms'] * 1e3:.2f} us, {t['bound_by']}; "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it), plain chain "
              f"{t['plain_ms'] * 1e3:.1f} us on {card}")
    errs = {k: {e: max(v[e] for v in res[k].values()) for e in ("err", "err_plain")}
            for k in ("self", "cross")}
    phase("decode attention", not failures,
          f"self at steps {ATTN_STEPS} (bf16; f32 and f64 at {ATTN_STEPS[:3]}; tiny): error "
          f"against the f64 plain version at most 2 x the plain chain's (max {errs['self']}), "
          f"the slot written bit for bit; cross with the CFG padding (max {errs['cross']}), "
          f"masked rows exactly 0; graphed replays at steps {res['graphed']['steps']}: launches "
          f"{res['graphed']['launches']}; refusals {refusals}; {res['seconds']:.1f} s"
          + (f"; FAILED: {failures}" if failures else ""))
    return res


def _dia_tiny_config(audio_length: int = 32):
    """tests/test_dia.py's tiny_config, the goldens' model."""
    from neuralcodecs_tpu_torch.models.dia.config import (
        DiaConfig,
        DiaDataConfig,
        DiaDecoderConfig,
        DiaEncoderConfig,
    )

    return DiaConfig(
        vocab_size=256, tgt_vocab_size=36,
        data=DiaDataConfig(text_length=16, audio_length=audio_length, channels=3,
                           audio_eos_value=32, audio_pad_value=33, audio_bos_value=34,
                           delay_pattern=[0, 1, 2]),
        encoder=DiaEncoderConfig(n_layer=2, n_embd=32, n_hidden=64, n_head=2, head_dim=16),
        decoder=DiaDecoderConfig(n_layer=2, n_embd=32, n_hidden=64, gqa_query_heads=4,
                                 kv_heads=2, gqa_head_dim=8, cross_query_heads=2,
                                 cross_head_dim=16))


def _dia_golden(name: str, audio_length: int, device: str):
    from neuralcodecs_tpu_torch.models.dia import Dia

    g = np.load(ROOT / "tests" / "goldens" / name)
    model = Dia(_dia_tiny_config(audio_length), device=device)
    model.load_state_dict({k[3:]: g[k] for k in g.files if k.startswith("sd/")})
    return model, g


class _LogitWatch:
    """Wraps the sampler of Dia's decode loop: keeps each step's top-2 logit
    gap [B·C] and whether any logit was NaN, on the device (no sync)."""

    def __init__(self):
        from neuralcodecs_tpu_torch.models.dia import model as dia_model

        self.module, self.plain = dia_model, dia_model._sample_next_token
        self.gaps: list[torch.Tensor] = []
        self.nan = None

    def __enter__(self):
        def watched(logits, *args):
            top2 = torch.topk(logits, 2, dim=-1).values
            self.gaps.append(top2[:, 0] - top2[:, 1])
            nan = torch.isnan(logits).any()
            self.nan = nan if self.nan is None else self.nan | nan
            return self.plain(logits, *args)
        self.module._sample_next_token = watched
        return self

    def __exit__(self, *exc):
        self.module._sample_next_token = self.plain


def _dia_greedy_both(card, cpu, texts, **kw) -> dict:
    """Greedy generation on the card and on the CPU. Where the step-aligned
    code buffers differ, the first slot that does and the top-2 logit gaps
    (the larger of the card's and the CPU's) of the codes that differ there:
    a flip at a near-tie changes every later step, so only the first counts.
    The card's run is eager (its sampler's logits are watched); its graphed
    run's step-aligned buffer must equal it ("graphed_equal")."""
    from neuralcodecs_tpu_torch.ops.graphs import graphs_disabled

    runs = {}
    st_graph, _, _ = card._generate(texts, temperature=0.0, **kw)
    graphed = st_graph.generated.clone()
    card._release_state(st_graph)
    for name, model in (("card", card), ("cpu", cpu)):
        with _LogitWatch() as watch, graphs_disabled():
            st, prefill_steps, b = model._generate(texts, temperature=0.0, **kw)
        runs[name] = (st, watch)
    (st_card, w_card), (st_cpu, w_cpu) = runs["card"], runs["cpu"]
    differ = st_card.generated.cpu() != st_cpu.generated
    step0 = int(prefill_steps.min()) - 1
    out = {"equal": not bool(differ.any()), "steps": st_cpu.step - step0, "first_slot": None,
           "gaps": [], "near_tie": True,
           "graphed_equal": bool(torch.equal(graphed, st_card.generated))}
    if not out["equal"]:
        slot = int(torch.nonzero(differ.any(dim=2).any(dim=0))[0])
        rows, chans = torch.nonzero(differ[:, slot], as_tuple=True)
        n = slot - 1 - step0
        channels = differ.shape[2]
        gaps = torch.maximum(w_card.gaps[n].cpu(), w_cpu.gaps[n]).reshape(-1, channels)
        out.update(first_slot=slot, gaps=[float(gaps[r, c]) for r, c in zip(rows, chans)])
        out["near_tie"] = max(out["gaps"]) < DIA_NEAR_TIE
    codes = [m._codes(r[0], prefill_steps, b)[0] for m, r in ((card, runs["card"]),
                                                               (cpu, runs["cpu"]))]
    out["codes"] = codes
    return out


def _tie_detail(res: dict) -> str:
    if res["equal"]:
        return "equal"
    return (f"differ from slot {res['first_slot']}, top-2 logit gaps there {res['gaps']} "
            f"(near-tie < {DIA_NEAR_TIE}: {res['near_tie']})")


def phase_dia_golden() -> dict:
    """The tiny goldens' weights on the card: greedy dia_golden generation
    against the port on the CPU, and the serving ladder (int8 KV cache,
    blocked read of 16, int8 dots) against dia_ladder_golden's greedy
    ladder_codes."""
    card, _ = _dia_golden("dia_golden.npz", 32, DEVICE)
    cpu, _ = _dia_golden("dia_golden.npz", 32, "cpu")
    golden = _dia_greedy_both(card, cpu, ["[S1]golden fixture"], max_tokens=24, seed=7)
    card, g = _dia_golden("dia_ladder_golden.npz", 64, DEVICE)
    cpu, _ = _dia_golden("dia_ladder_golden.npz", 64, "cpu")
    for m in (card, cpu):
        m.enable_int8_kv_cache()
        m.kv_read_block, m.kv_dot_int8 = 16, True
    ladder = _dia_greedy_both(card, cpu, DIA_LADDER_TEXTS, **DIA_LADDER_KW)
    want = g["ladder_codes"].astype(np.int32)
    got = ladder["codes"][0]
    ladder_ok = got.shape == want.shape and bool((got == want).all())
    graphed = golden["graphed_equal"] and ladder["graphed_equal"]
    phase("dia golden", golden["near_tie"] and ladder["near_tie"] and (ladder_ok or not ladder[
        "equal"]) and graphed,
          f"tiny dia_golden weights, greedy, {golden['steps']} steps: card vs CPU "
          f"{_tie_detail(golden)}; serving ladder (int8 KV, block 16, int8 dots), greedy, "
          f"{ladder['steps']} steps: card == ladder_codes {tuple(want.shape)}: {ladder_ok}, "
          f"card vs CPU {_tie_detail(ladder)}; the card's graphed steps == its eager steps: "
          f"{graphed}")
    return {"golden": {k: v for k, v in golden.items() if k != "codes"},
            "ladder": {k: v for k, v in ladder.items() if k != "codes"},
            "ladder_codes_equal": ladder_ok}


def _dia_forced_logits(model, st, tokens: np.ndarray) -> list[torch.Tensor]:
    """Logits [2B, 1, C, V] of teacher-forced decode steps from ``st``:
    step n takes tokens[:, n] ([2B, C]) at position st.step + n."""
    out = []
    rows = tokens.shape[0]
    for n in range(tokens.shape[1]):
        step = st.step + n
        x = model._embed_tokens(torch.as_tensor(tokens[:, n:n + 1], device=model.device))
        pos = torch.full((rows, 1), step, dtype=torch.int64, device=model.device)
        for layer, sc, cc in zip(model.decoder.layers, st.self_caches, st.cross_caches):
            x = layer.step(x, pos, step, sc, cc, st.cross_mask)
        out.append(model._decoder_logits(x))
    return out


def _dia_small_config():
    """DiaConfig() widths with 2 encoder and 2 decoder layers."""
    from neuralcodecs_tpu_torch.models.dia import DiaConfig

    cfg = DiaConfig()
    cfg.encoder.n_layer = cfg.decoder.n_layer = 2
    return cfg


def _dia_forced_run(model) -> tuple:
    """The prefill of DIA_TEXTS[:2] (a 64-token buffer) and 16 teacher-forced
    decode steps of seeded tokens: (the loop state, the steps' logits
    stacked, f64 on the CPU)."""
    text = model._pad_text([model.encode_text(t) for t in DIA_TEXTS[:2]])
    tokens = np.random.default_rng(SEED).integers(0, 1024,
                                                  size=(4, 16, model.config.data.channels))
    delayed, steps = model._prefill([None, None], 2)
    st = model._start_state(text, delayed, steps, SEED, np.ones(2, bool), max_tokens=64)
    return st, torch.stack([x.cpu().double() for x in _dia_forced_logits(model, st, tokens)])


@contextlib.contextmanager
def _tf32_on():
    """TF32 products for matmuls and convolutions, as a precision control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def phase_dia_card_vs_cpu() -> dict:
    """DiaConfig() widths with 2 encoder and 2 decoder layers, seeded: the
    prefill and 16 teacher-forced decode steps on the card against the port
    on the CPU, both f32, and against the port on the CPU in f64. The card
    must be as close to f64 as the CPU port is, within DIA_F64_FACTOR x its
    error (both sum in f32 in other orders; TF32 off), and the same card
    model with TF32 products on, the control, must fall outside that limit.
    Then a greedy 32-step generation on the card and the CPU."""
    from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig

    cfg = _dia_small_config()
    card = Dia(cfg, device=DEVICE, seed=SEED)
    cpu = Dia(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    f64 = Dia(cfg, device="cpu", compute_dtype=torch.float64)
    f64.load_state_dict(card.state_dict())
    texts = DIA_TEXTS[:2]
    states, logits = {}, {}
    runs = (("card", card), ("cpu", cpu), ("f64", f64), ("tf32", card))
    for name, model in runs:
        with _tf32_on() if name == "tf32" else contextlib.nullcontext():
            states[name], logits[name] = _dia_forced_run(model)
    measured = ("card", "cpu", "tf32")
    cache_err = {name: max(float((getattr(a, key).cpu().double() - getattr(b, key)).abs().max())
                           for a, b in zip(states[name].self_caches + states[name].cross_caches,
                                           states["f64"].self_caches + states["f64"].cross_caches)
                           for key in ("k", "v"))
                 for name in measured}
    err = {name: float((logits[name] - logits["f64"]).abs().max()) for name in measured}
    limit = {"caches": DIA_F64_FACTOR * cache_err["cpu"], "logits": DIA_F64_FACTOR * err["cpu"]}
    close = err["card"] <= limit["logits"] and cache_err["card"] <= limit["caches"]
    caught = err["tf32"] > limit["logits"] and cache_err["tf32"] > limit["caches"]
    card_vs_cpu = float((logits["card"] - logits["cpu"]).abs().max())
    scale = float(logits["f64"].abs().max())
    finite = bool(torch.isfinite(logits["card"]).all())
    greedy = _dia_greedy_both(card, cpu, texts, max_tokens=32, pad_tokens_to=64, seed=SEED)
    phase("dia full-width card vs cpu", close and caught and finite and greedy["near_tie"],
          f"DiaConfig() widths, 2+2 layers, against the CPU port in f64: prefill caches "
          f"max|err| card {cache_err['card']:.2e}, CPU f32 {cache_err['cpu']:.2e}, TF32 control "
          f"{cache_err['tf32']:.2e}; 16 teacher-forced steps' logits (max |logit| {scale:.2f}) "
          f"max|err| card {err['card']:.2e}, CPU f32 {err['cpu']:.2e}, TF32 control "
          f"{err['tf32']:.2e}; card within {DIA_F64_FACTOR:g} x CPU: {close}, control outside "
          f"it in both: {caught}; card vs CPU f32 max|err| {card_vs_cpu:.2e}, finite {finite}; "
          f"greedy {greedy['steps']} steps: {_tie_detail(greedy)}")
    return {"cache_err_vs_f64": cache_err, "logits_err_vs_f64": err, "limits": limit,
            "logits_card_vs_cpu": card_vs_cpu, "logit_scale": scale,
            "greedy": {k: v for k, v in greedy.items() if k != "codes"}}


def _dia_step_bytes(dia, rows: int, text_len: int, live: float) -> tuple[float, float]:
    """(bytes, flops) of one decode step: the kernels a step reads (every
    decoder layer's self-attention, cross-attention q / o and MLP, and the
    logits head), the self-attention K/V of ``live`` positions and the cross
    K/V of ``text_len``, for ``rows`` CFG rows."""
    d = dia.config.decoder
    act = torch.empty((), dtype=dia.compute_dtype).element_size()
    mods = [dia.decoder.logits_dense]
    for layer in dia.decoder.layers:
        mods += [layer.self_attention, layer.cross_attention.q_proj,
                 layer.cross_attention.o_proj, layer.mlp]
    tensors = [(k, t) for m in mods for k, t in m.state_dict().items()]
    # a DenseGeneral's f32 kernel is read as its compute-dtype copy
    weight_bytes = sum(t.numel() * (act if k.endswith(".weight") and t.dim() >= 2
                                    else t.element_size()) for k, t in tensors)
    params = sum(t.numel() for _, t in tensors if t.dim() >= 2)
    kv_elem = 1 if dia.kv_cache_int8 else act
    kv = d.n_layer * 2 * rows * live * d.kv_heads * (d.gqa_head_dim * kv_elem
                                                      + (4 if dia.kv_cache_int8 else 0))
    cross = d.n_layer * 2 * rows * text_len * d.cross_query_heads * d.cross_head_dim * act
    flops = 2.0 * params * rows + d.n_layer * 4.0 * rows * d.gqa_query_heads * d.gqa_head_dim * (
        live + text_len)
    return weight_bytes + kv + cross, flops


# the host's launch calls among a trace's CUDA API events
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                 "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


def _steps_trace(step, n: int = 8) -> dict:
    """A Chrome trace (diagnostics.profiler.trace) of n calls of step():
    the device ms a call and the top ops from the trace summary
    (diagnostics.xplane.summarize_trace), and the host's launch calls a call
    (kernel launches, graph launches, async copies and fills) counted in the
    trace's runtime events."""
    from neuralcodecs_tpu_torch.diagnostics.profiler import trace
    from neuralcodecs_tpu_torch.diagnostics.xplane import summarize_trace

    step()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            for _ in range(n):
                step()
        summary = summarize_trace(log_dir)
        events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    launches = sum(1 for e in events if e.get("ph") == "X"
                   and str(e.get("cat", "")).lower() in ("cuda_runtime", "cuda_driver")
                   and e.get("name") in _LAUNCH_CALLS)
    return {"device_ms": sum(ms for _, ms in summary) / n, "host_launches": launches / n,
            "top": [(name, ms / n) for name, ms in summary[:8]]}


def _dia_steps(dia, texts, steps: int) -> dict:
    """Warm decode steps of a 4-request generation in the served bucket, as
    the loop takes them (``Dia._advance``: graph replays, or eager steps
    inside graphs_disabled()): ms a step by CUDA events, the host's time to
    issue a step, the decode-attention kernels' launches a step (each once a
    layer, the self kernel not on an int8 cache, or PhaseError), and from a
    traced pass over 8 more steps the device ms, the host's launches a step
    and the top ops."""
    from neuralcodecs_tpu_torch.ops import kernels

    text = dia._pad_text([dia.encode_text(t) for t in texts])
    delayed, prefill_steps = dia._prefill([None] * len(texts), len(texts))
    sampling = dia._sampling(DIA_SERVE_KW["pad_tokens_to"], None, None, None, None)
    st = dia._loop_state(text, delayed, prefill_steps, SEED, np.ones(len(texts), bool),
                         DIA_SERVE_KW["pad_tokens_to"], DIA_SERVE_KW["max_tokens"], sampling)
    try:
        for _ in range(4):
            dia._advance(st, sampling)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            dia._advance(st, sampling)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
        attn = {k: (kernels.launch_counts()[k] - before[k]) / steps for k in ATTN_KERNELS}
        layers = dia.config.decoder.n_layer
        if attn != {"decode_self_attn": 0 if dia.kv_cache_int8 else layers,
                    "decode_cross_attn": layers}:
            raise PhaseError(f"decode-attention launches a step {attn}, want each once a "
                             f"layer ({layers}; the self kernel not on an int8 cache)")
        traced = _steps_trace(lambda: dia._advance(st, sampling))
        position = st.step
    finally:
        dia._release_state(st)
    return {"ms": ms, "host_enqueue_ms": host_ms, **traced,
            "idle": 1.0 - traced["device_ms"] / ms, "position": position,
            "attn_launches_a_step": attn}


def _graph_pool_gb() -> float:
    """GB reserved in CUDA-graph memory pools (every pool but the default)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def _dia_step_time(dia, texts, steps: int = 32) -> dict:
    """The decode step graphed (the path) and eager (graphs off) on the same
    weights (_dia_steps), with the model's capture seconds, its state pool's
    GB and the GB reserved in graph pools."""
    from neuralcodecs_tpu_torch.ops.graphs import graphs_disabled

    out = _dia_steps(dia, texts, steps)
    with graphs_disabled():
        out["eager"] = _dia_steps(dia, texts, 16)
    out["pool"] = {**dia.graph_stats(), "graph_pool_gb": _graph_pool_gb()}
    out["pool"]["peak_gb"] = out["pool"]["state_gb"] + out["pool"]["graph_pool_gb"]
    out["launches"] = out["host_launches"]
    return out


def _dia_graphed_vs_eager(dia, kw: dict) -> dict:
    """Codes of DIA_TEXTS at ``kw`` graphed (the path) and eager (graphs
    off, the sampler's logits watched for NaN) on the same weights."""
    from neuralcodecs_tpu_torch.ops.graphs import graphs_disabled

    graphed = dia.generate_codes(DIA_TEXTS, **kw)
    with graphs_disabled(), _LogitWatch() as watch:
        eager = dia.generate_codes(DIA_TEXTS, **kw)
    return {"equal": all(np.array_equal(g, e) for g, e in zip(graphed, eager)),
            "lengths": graphed[1].tolist(), "nan_logits": bool(watch.nan)}


def _dia_served(dia, texts, **kw) -> dict:
    """One generate() call, as the server makes it: its audio and codes,
    wall time, peak memory, the decode steps run (``Dia._advance`` calls:
    a replay runs no Python sampler) and the device->host syncs
    (torch.cuda.set_sync_debug_mode)."""
    import warnings

    codes = []
    generate_codes = dia.generate_codes

    def recorded(*args, **kwargs):  # the codes under generate
        codes.append(generate_codes(*args, **kwargs))
        return codes[-1]
    dia.generate_codes = recorded
    advance, steps = dia._advance, [0]

    def counted(*args):  # the loop's steps
        steps[0] += 1
        return advance(*args)
    dia._advance = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            audios = dia.generate(texts, **kw)
            wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del dia.generate_codes, dia._advance
    steps = steps[0]
    return {"audios": audios, "codes": codes[0], "steps": steps, "wall_s": wall_s,
            "syncs": sum("synchroniz" in str(w.message) for w in caught),
            "tokens_per_s": steps * len(texts) / wall_s, "realtime": steps / 86.0 / wall_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _print_dia_step(label: str, run: dict, step: dict, bnd: dict, card: str) -> None:
    """A served run and its decode step, graphed and eager."""
    e, pool = step["eager"], step["pool"]
    print(f"    dia {label}: {run['steps']} steps of 4 requests in {run['wall_s']:.2f} s = "
          f"{run['tokens_per_s']:.1f} tokens/s ({run['realtime']:.2f}x realtime a request); "
          f"decode step graphed {step['ms']:.2f} ms (CUDA events; host "
          f"{step['host_enqueue_ms']:.3f} ms, {step['host_launches']:.1f} host launches; "
          f"device {step['device_ms']:.2f} ms from the trace summary, idle {step['idle']:.1%}), "
          f"eager {e['ms']:.2f} ms (host {e['host_enqueue_ms']:.2f} ms, "
          f"{e['host_launches']:.0f} host launches, device {e['device_ms']:.2f} ms) at position "
          f"{step['position']}, bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}); graphs "
          f"{pool['graphs']} captured in {pool['capture_s']:.2f} s, state pool "
          f"{pool['slots']} slots {pool['state_gb']:.3f} GB + graph pools "
          f"{pool['graph_pool_gb']:.3f} GB; {run['syncs']} syncs; peak {run['peak_gb']:.2f} GB "
          f"on {card}")
    print("    top (graphed): " + ", ".join(f"{k[:40]} {ms:.3f} ms" for k, ms in step["top"]))


def _check_audio(audios, label: str) -> None:
    for a in audios:
        if a.ndim != 1 or not np.isfinite(a).all():
            raise PhaseError(f"{label}: audio of shape {a.shape}, finite {np.isfinite(a).all()}")


def _write_prompt_wav(path: Path, seconds: float, sr: int) -> None:
    import wave

    rng = np.random.default_rng(SEED + 10)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 180.0 * t) + 0.05 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


class _CallCount:
    """Counts calls of a model's methods (the DAC's from_codes / encode) by
    shadowing them on the instance, and keeps each call's arguments and
    result."""

    def __init__(self, model, names):
        self.model, self.names = model, names
        self.records = {name: [] for name in names}

    @property
    def calls(self) -> dict:
        return {name: len(recs) for name, recs in self.records.items()}

    def __enter__(self):
        for name in self.names:
            method = getattr(self.model, name)

            def counted(*args, _name=name, _method=method, **kw):
                out = _method(*args, **kw)
                self.records[_name].append((args, kw, out))
                return out
            self.model.__dict__[name] = counted
        return self

    def __exit__(self, *exc):
        for name in self.names:
            del self.model.__dict__[name]


def _dia_from_export(tmp: Path, card: str):
    """The full 1.61 B Dia, seeded on the card, exported with save_pretrained
    in 2 GiB shards into tmp / "dia" and loaded back through load_dia; state
    dicts equal. The export stays for phase_dia_bf16, which deletes it."""
    from neuralcodecs_tpu_torch import load_dia
    from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig

    dia, res = _export_and_load("dia-1.6b", Dia(DiaConfig(), device=DEVICE, seed=SEED),
                                tmp / "dia", lambda d: load_dia(d, device=DEVICE), card,
                                max_shard_bytes=2 ** 31)
    torch.cuda.empty_cache()   # the seeded copy
    return dia, res


def phase_dia_serve(dac_dir: Path, card: str, tmp: Path) -> dict:
    """The full 1.61 B Dia, seeded on the card, f32, exported and loaded back
    through load_dia, vocoded by the DAC-44k export that Dia.load_dac_model
    loads: four requests in one generate call (cli/serve.py's /tts group,
    max_tokens 512 in the 1024 bucket: the blocked KV read is on), one
    request with a 3 s voice-clone prompt, generate_stream of one request in
    segments of 64 against its one-shot codes (max_tokens 128), then the
    serving ladder (int8 weights, int8 KV cache, int8 dots) on the four
    requests at max_tokens 128; the clone runs to max_tokens 384 (the Dia
    phases' time budget). Kernels 1
    and 2b run in the DAC calls. Every code is checked
    in [0, 1023] with lengths at most max_tokens. Every decode step replays a
    CUDA graph; on the same weights at max_tokens 128 the graphed codes must
    equal the eager ones (graphs off; no NaN logit there) greedy, at the
    serving temperature and on the int8 ladder, and the step is timed both
    ways (_dia_step_time)."""
    from neuralcodecs_tpu_torch.models.dac import DAC
    from neuralcodecs_tpu_torch.models.dia import model as dia_model
    from neuralcodecs_tpu_torch.ops import kernels

    dia, loaded = _dia_from_export(tmp, card)
    dia.load_dac_model(str(dac_dir))
    dac = dia.dac
    if not (isinstance(dac, DAC) and dac.device == dia.device):
        raise PhaseError(f"load_dac_model gave {type(dac).__name__} on {dac.device}")
    http = phase_dia_http(dia, card)   # the f32 model behind the HTTP server, counted apart
    n_params = sum(p.numel() for p in dia.parameters())
    wav = tmp / "prompt.wav"
    _write_prompt_wav(wav, 3.0, dac.config.sample_rate)
    max_tokens, hop = DIA_SERVE_KW["max_tokens"], dac.config.hop_length
    short_kw = dict(DIA_SERVE_KW, max_tokens=32)
    stream_kw = dict(DIA_SERVE_KW, max_tokens=128)
    ladder_kw = dict(DIA_SERVE_KW, max_tokens=128)
    clone_kw = dict(DIA_SERVE_KW, max_tokens=384)   # 259 prompt frames, then ≈ 125 steps

    def check(audios, label, limit):
        _check_audio(audios, label)
        frames = [a.shape[0] // hop for a in audios]
        if max(frames) > limit:
            raise PhaseError(f"{label}: {frames} frames, more than max_tokens {limit}")

    kernels.reset_launch_counts()
    with _CallCount(dac, ("from_codes", "encode")) as dac_calls:
        # warm-up: the graphs of the 4-request and the 1-request shapes
        dia.generate_codes(DIA_TEXTS, **short_kw)
        dia.generate_codes(DIA_TEXTS[:1], **short_kw)
        served = _dia_served(dia, DIA_TEXTS, **DIA_SERVE_KW)
        check(served["audios"], "serve f32", max_tokens)
        prompt = dia.load_audio_prompt(wav)
        clone = _dia_served(dia, DIA_TEXTS[:1], audio_prompts=[prompt], **clone_kw)
        check(clone["audios"], "voice clone", clone_kw["max_tokens"])
        one_codes, one_len = dia.generate_codes(DIA_TEXTS[:1], **stream_kw)
        blocks, first_codes = [], []
        codes_stream = dia.generate_codes_stream

        def recorded(*args, **kw):  # the code blocks under generate_stream
            for block, done in codes_stream(*args, **kw):
                if not first_codes and len(block):
                    first_codes.append(time.perf_counter() - t0)
                blocks.append(block)
                yield block, done
        dia.generate_codes_stream = recorded
        t0 = time.perf_counter()
        chunks, first_audio_s = [], None
        for _, chunk in dia.generate_stream(DIA_TEXTS[0], segment_tokens=64, **stream_kw):
            if first_audio_s is None and chunk.size:
                first_audio_s = time.perf_counter() - t0
            chunks.append(chunk)
        stream_s = time.perf_counter() - t0
        del dia.generate_codes_stream
        streamed, first_codes_s = np.concatenate(blocks), first_codes[0]
        _check_audio([np.concatenate(chunks)], "generate_stream")
        f32_step = _dia_step_time(dia, DIA_TEXTS)
        compare_kw = dict(DIA_SERVE_KW, max_tokens=128)
        versus = {"f32 greedy": _dia_graphed_vs_eager(dia, dict(compare_kw, temperature=0.0)),
                  "f32 sampled": _dia_graphed_vs_eager(dia, compare_kw)}
        short = lambda: dia.generate_codes(DIA_TEXTS, **short_kw)  # noqa: E731
        f32_prof_wall = _timed_s(short)[1] * 1e3
        f32_prof = _device_profile(short, f32_prof_wall, None, reps=1)
        f32_bytes, f32_flops = _dia_step_bytes(dia, 8, 128, f32_step["position"])
        # the serving ladder, in place
        dia.quantize_int8().enable_int8_kv_cache()
        dia.kv_dot_int8 = True
        dia.generate_codes(DIA_TEXTS, **short_kw)     # warm-up: the ladder's graphs
        ladder = _dia_served(dia, DIA_TEXTS, **ladder_kw)
        check(ladder["audios"], "serve int8 ladder", ladder_kw["max_tokens"])
        ladder_step = _dia_step_time(dia, DIA_TEXTS)
        versus["int8 ladder"] = _dia_graphed_vs_eager(dia, compare_kw)
        ladder_bytes, ladder_flops = _dia_step_bytes(dia, 8, 128, ladder_step["position"])
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n_dec, n_enc = len(_residual_units(dac.decoder)), len(_residual_units(dac.encoder))
    want = _with_attn({**_NO_LAUNCHES,
                       "codebook_argmin": dac.config.n_codebooks * dac_calls.calls["encode"],
                       "fused_residual_unit_dense": n_dec * dac_calls.calls["from_codes"]
                       + n_enc * dac_calls.calls["encode"]}, counts)
    for (codes, lengths), limit in ((served["codes"], max_tokens),
                                    (clone["codes"], clone_kw["max_tokens"]),
                                    (ladder["codes"], ladder_kw["max_tokens"]),
                                    ((one_codes, one_len), stream_kw["max_tokens"])):
        if codes.min() < 0 or codes.max() > 1023 or lengths.max() > limit:
            raise PhaseError(f"codes in [{codes.min()}, {codes.max()}], lengths {lengths}")
    one = one_codes[0, :int(one_len[0])]
    stream_equal = streamed.shape == one.shape and bool((streamed == one).all())
    runs = (served, clone, ladder)
    sync_ok = all(r["syncs"] <= r["steps"] // dia_model._SYNC_EVERY + 16 for r in runs)

    # after the counted path: every DAC call the path made again with the
    # plain versions of kernels 1 and 2b, on the same inputs, against what
    # the kernels gave there; then the vocode time of 4 x 10 s of codes
    records = dac_calls.records
    with _plain_kernels():
        plain = {name: [getattr(dac, name)(*args, **kw) for args, kw, _ in recs]
                 for name, recs in records.items()}
    path_vocodes = [{"codes": list(np.shape(args[0])),
                     "snr_db": _snr_db(ref.cpu().numpy().ravel(), out.cpu().numpy().ravel()),
                     "max_abs_err": float((ref - out).abs().max())}
                    for ref, (args, _, out) in zip(plain["from_codes"], records["from_codes"])]
    prompt_equal = all(torch.equal(ref[1], out[1])
                       for ref, (_, _, out) in zip(plain["encode"], records["encode"]))
    path_snr = min(v["snr_db"] for v in path_vocodes)
    batch = np.random.default_rng(SEED).integers(0, 1024, size=(4, 9, 861)).astype(np.int32)
    vocode_ms = time_ms(lambda: dac.from_codes(batch), 3, 1)
    got = dac.from_codes(batch)
    with _plain_kernels():
        ref = dac.from_codes(batch)
        vocode_plain_ms = time_ms(lambda: dac.from_codes(batch), 3, 1)
    vocode_snr = _snr_db(ref.cpu().numpy().ravel(), got.cpu().numpy().ravel())
    res = {"params": n_params, "loaded": loaded, "counts": counts, "http": http,
           "dac_calls": dict(dac_calls.calls),
           "stream": {"first_codes_s": first_codes_s, "first_audio_s": first_audio_s,
                      "total_s": stream_s, "frames": int(streamed.shape[0]),
                      "equal": stream_equal},
           "step_f32": f32_step, "step_int8": ladder_step, "profile_f32_32_tokens": f32_prof,
           "bound_f32": bound(f32_flops, f32_bytes), "bound_int8": bound(ladder_flops,
                                                                         ladder_bytes),
           "bytes_f32": f32_bytes, "bytes_int8": ladder_bytes, "vocode_ms_4x10s": vocode_ms,
           "vocode_plain_ms_4x10s": vocode_plain_ms,
           "vocode_snr_db_4x10s": vocode_snr, "path_vocodes": path_vocodes,
           "prompt_codes_equal": prompt_equal,
           "prompt_frames": int(prompt.shape[0]), "graphed_vs_eager": versus}
    for key, run in (("serve", served), ("clone", clone), ("ladder", ladder)):
        res[key] = {k: v for k, v in run.items() if k not in ("audios", "codes")}
    for label, run, step, bnd in (("f32", served, f32_step, res["bound_f32"]),
                                  ("int8 ladder", ladder, ladder_step, res["bound_int8"])):
        _print_dia_step(label, run, step, bnd, card)
    for label, v in versus.items():
        print(f"    dia graphed vs eager, {label}, 4 requests to 128 tokens: codes equal "
              f"{v['equal']} (lengths {v['lengths']}), NaN logits in the eager run "
              f"{v['nan_logits']}")
    _print_profile("dia f32 32-token generation", f32_prof, f32_prof_wall)
    versus_ok = all(v["equal"] and not v["nan_logits"] for v in versus.values())
    ok = (counts == want and stream_equal and prompt_equal and path_snr > 55.0
          and vocode_snr > 55.0 and n_params > 1.6e9 and sync_ok and versus_ok)
    phase("dia serve", ok,
          f"{n_params} parameters loaded from {loaded['bytes'] / 1e9:.2f} GB; launches {counts} == {want} ({dac_calls.calls}); 4 requests "
          f"f32: {served['wall_s']:.2f} s, {served['tokens_per_s']:.1f} tokens/s, syncs "
          f"{served['syncs']} (at most steps / {dia_model._SYNC_EVERY} + 16: {sync_ok}); "
          f"voice clone ({prompt.shape[0]} prompt frames) "
          f"{clone['wall_s']:.1f} s, syncs {clone['syncs']}; stream == one-shot "
          f"({streamed.shape[0]} frames): {stream_equal}, first codes {first_codes_s:.2f} s, "
          f"first audio {first_audio_s:.2f} s; int8 ladder {ladder['tokens_per_s']:.1f} "
          f"tokens/s, syncs {ladder['syncs']}; the path's {len(path_vocodes)} vocodes (codes "
          f"{[v['codes'] for v in path_vocodes]}) again with plain kernel 2b: least SNR "
          f"{path_snr:.1f} dB (> 55), max|err| {max(v['max_abs_err'] for v in path_vocodes):.2e}; "
          f"the prompt's encode again with plain kernels 1 and 2b: codes equal {prompt_equal}; "
          f"vocode of 4 x 861 frames {vocode_ms:.1f} ms (plain {vocode_plain_ms:.1f} ms, SNR "
          f"{vocode_snr:.1f} dB > 55); graphed codes == eager codes at 128 tokens (f32 greedy, "
          f"f32 sampled, int8 ladder): {[v['equal'] for v in versus.values()]}, no NaN logit "
          f"in the eager runs")
    return res


# ------------------------------------------------------ precision modes

BF16 = torch.bfloat16
# bf16 dense peak of the tensor cores (NVIDIA data sheet, SXM, at 700 W)
BF16_FLOPS = 989e12
# the bf16 phase's traffic: DIA_SERVE_KW's requests and bucket, max_tokens
# cut from 512 to 128 for the phases' time budget; the ladders to 64
DIA_BF16_KW = dict(DIA_SERVE_KW, max_tokens=128)
DIA_BF16_LADDER_KW = dict(DIA_SERVE_KW, max_tokens=64)


def _fp8_rounded(w: torch.Tensor) -> torch.Tensor:
    """w rounded to fp8 (e4m3: 3 mantissa bits, bf16 has 7), through a
    power-of-two scale that puts its largest entry in e4m3's range."""
    scale = 2.0 ** torch.floor(torch.log2(240.0 / w.abs().amax()))
    return (w * scale).to(torch.float8_e4m3fn).to(w.dtype) / scale


def _dia_cache_err(st, ref) -> float:
    """max |err| of the prefill's self and cross caches against ref's."""
    return max(float((getattr(a, key).cpu().double() - getattr(b, key)).abs().max())
               for a, b in zip(st.self_caches + st.cross_caches,
                               ref.self_caches + ref.cross_caches)
               for key in ("k", "v"))


def _dia_bf16_card_vs_cpu() -> dict:
    """DiaConfig() widths at 2 + 2 layers, seeded, each q projection scaled
    by 1/sqrt(head_dim) as a trained Dia folds it: unit-scale q and k give
    scores of spread sqrt(128) ~ 11, near one-hot, and bf16's error then
    saturates at the logits' own scale. The prefill caches (the encoder's
    through the cross caches, each decoder layer's through the self caches)
    and 16 teacher-forced steps' logits in bf16 on the card and on the CPU,
    against the port's f64 mode on the CPU: the card must be within
    DIA_F64_FACTOR x the CPU bf16 port's error in both, and the control, the
    card model with its weights rounded to fp8, must fall outside it in
    both. A reading, not gated: the card with cuBLAS's bf16 reduced-precision
    reduction on (off by the port's policy), which adds one rounding a
    product, as bf16 attention scores would: too little for a 4 x limit."""
    from neuralcodecs_tpu_torch.models.dia import Dia
    from neuralcodecs_tpu_torch.models.dia.layers import DenseGeneral

    cfg = _dia_small_config()
    weights = Dia(cfg, device=DEVICE, seed=SEED).state_dict()
    for key, w in weights.items():
        if key.endswith("q_proj.weight"):   # every DiaConfig() attention has 128-wide heads
            w.mul_(cfg.decoder.gqa_head_dim ** -0.5)
    t0 = time.perf_counter()
    models = {"f64": Dia(cfg, device="cpu", compute_dtype=torch.float64),
              "cpu": Dia(cfg, device="cpu", compute_dtype=BF16),
              "card": Dia(cfg, device=DEVICE, compute_dtype=BF16),
              "fp8": Dia(cfg, device=DEVICE, compute_dtype=BF16)}
    for model in models.values():
        model.load_state_dict(weights)
    del weights
    for m in models["fp8"].modules():
        if isinstance(m, DenseGeneral):
            m.weight.copy_(_fp8_rounded(m.weight))
    states, logits = {}, {}
    for name, model in models.items():
        states[name], logits[name] = _dia_forced_run(model)
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        states["reduced"], logits["reduced"] = _dia_forced_run(models["card"])
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
    del models
    measured = ("card", "cpu", "fp8", "reduced")
    err = {"caches": {n: _dia_cache_err(states[n], states["f64"]) for n in measured},
           "logits": {n: float((logits[n] - logits["f64"]).abs().max()) for n in measured}}
    limit = {k: DIA_F64_FACTOR * e["cpu"] for k, e in err.items()}
    res = {"err_vs_f64": err, "limits": limit,
           "logit_scale": float(logits["f64"].abs().max()),
           "card_vs_cpu": float((logits["card"] - logits["cpu"]).abs().max()),
           "finite": bool(torch.isfinite(logits["card"]).all()),
           "within": all(0 < err[k]["card"] <= limit[k] for k in limit),
           "control_caught": all(err[k]["fp8"] > limit[k] for k in limit),
           "seconds": time.perf_counter() - t0}
    res["ok"] = res["finite"] and res["within"] and res["control_caught"]
    return res


def _dia_step_series(dia, rounds: int = 4, steps: int = 16) -> dict:
    """One model's decode step in bf16 and in f32, in alternating order
    (bf16, f32, f32, bf16, ...), each mode carrying its own 4-request state
    in the served bucket (a pooled state with its graphs: the steps are
    replays): ms a step by CUDA events over ``steps`` steps, one sample a
    mode a round, sorted."""
    modes = {"bf16": BF16, "f32": torch.float32}
    text = dia._pad_text([dia.encode_text(t) for t in DIA_TEXTS])
    delayed, prefill_steps = dia._prefill([None] * len(DIA_TEXTS), len(DIA_TEXTS))
    sampling = dia._sampling(DIA_SERVE_KW["pad_tokens_to"], None, None, None, None)
    states = {}
    for name, dtype in modes.items():
        dia.compute_dtype = dtype
        states[name] = dia._loop_state(text, delayed, prefill_steps, SEED,
                                       np.ones(len(DIA_TEXTS), bool),
                                       DIA_SERVE_KW["pad_tokens_to"], DIA_SERVE_KW["max_tokens"],
                                       sampling)
        for _ in range(4):
            dia._advance(states[name], sampling)
    samples = {name: [] for name in modes}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(rounds):
        for name in list(modes)[::1 if r % 2 == 0 else -1]:
            dia.compute_dtype = modes[name]
            torch.cuda.synchronize()
            start.record()
            for _ in range(steps):
                dia._advance(states[name], sampling)
            end.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(end) / steps)
    for st in states.values():
        dia._release_state(st)
    dia.compute_dtype = BF16
    return {name: sorted(v) for name, v in samples.items()}


def _dia_run(dia, kw: dict, peak: float, versus: bool = False) -> dict:
    """A served generate of DIA_TEXTS, then the decode step's time graphed
    and eager and its bound (the step's bytes and operations at ``peak``);
    with ``versus``, graphed against eager codes at 128 tokens."""
    dia.generate_codes(DIA_TEXTS, **dict(DIA_SERVE_KW, max_tokens=32))  # warm-up: graphs
    run = _dia_served(dia, DIA_TEXTS, **kw)
    _check_audio(run["audios"], f"{dia.compute_dtype} generate")
    step = _dia_step_time(dia, DIA_TEXTS, steps=16)
    nbytes, flops = _dia_step_bytes(dia, 2 * len(DIA_TEXTS), 128, step["position"])
    out = {"run": run, "step": step, "bytes": nbytes, "bound": bound(flops, nbytes, peak)}
    if versus:
        out["graphed_vs_eager"] = _dia_graphed_vs_eager(dia, dict(DIA_SERVE_KW, max_tokens=128))
    return out


def phase_dia_bf16(tmp: Path, dac_dir: Path, card: str) -> dict:
    """Dia 1.6B in bf16, the JAX package's serving mode: loaded through
    load_dia(compute_dtype=torch.bfloat16) from the export _dia_from_export
    wrote, vocoded by the f32 DAC-44k export. Four requests
    in the 1024 bucket to 128 tokens and a voice-clone prompt of 1 s
    (kernels 1 and 2b run in the DAC's encode and from_codes), with the
    decode step's time by CUDA events and the host's enqueue, device time,
    idle share and launches by torch.profiler, tokens/s, realtime factor,
    peak memory and the step's bytes bound; the same four requests with the
    same parameters in f32 for scale, then the two modes' step in
    alternating order (_dia_step_series); the int8 and the int4 ladders at
    bf16 to 64 tokens; then the card's bf16 caches and logits at 2 + 2
    layers against the f64 port (_dia_bf16_card_vs_cpu)."""
    from neuralcodecs_tpu_torch import load_dia
    from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig
    from neuralcodecs_tpu_torch.models.dia import model as dia_model
    from neuralcodecs_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dia = load_dia(str(tmp / "dia"), device=DEVICE, compute_dtype=BF16).eval()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if dia.compute_dtype != BF16 or any(p.dtype != torch.float32 for p in dia.parameters()):
        raise PhaseError("load_dia(compute_dtype=bf16) did not give a bf16 Dia on f32 weights")
    dia.load_dac_model(str(dac_dir))
    dac = dia.dac
    wav = tmp / "prompt_1s.wav"
    _write_prompt_wav(wav, 1.0, dac.config.sample_rate)
    res = {"load_s": load_s}

    kernels.reset_launch_counts()
    with _CallCount(dac, ("from_codes", "encode")) as dac_calls:
        res["bf16"] = _dia_run(dia, DIA_BF16_KW, BF16_FLOPS, versus=True)
        prompt = dia.load_audio_prompt(wav)
        dia.generate_codes(DIA_TEXTS[:1], **dict(DIA_SERVE_KW, max_tokens=32))  # warm-up
        clone = _dia_served(dia, DIA_TEXTS[:1], audio_prompts=[prompt], **DIA_BF16_KW)
        _check_audio(clone["audios"], "voice clone bf16")
        dia.compute_dtype = torch.float32   # the same parameters, in the f32 mode
        res["f32"] = _dia_run(dia, DIA_BF16_KW, F32_FLOPS)
        res["series"] = _dia_step_series(dia)
        weights = {k: v.clone() for k, v in dia.state_dict().items()}
        dia.quantize_int8().enable_int8_kv_cache()
        dia.kv_dot_int8 = True
        res["int8"] = _dia_run(dia, DIA_BF16_LADDER_KW, BF16_FLOPS)
        del dia
        dia = Dia(DiaConfig(), device=DEVICE, compute_dtype=BF16)
        dia.load_state_dict(weights)
        del weights
        dia.set_dac_model(dac)
        dia.quantize_int4().enable_int8_kv_cache()
        dia.kv_dot_int8 = True
        res["int4"] = _dia_run(dia, DIA_BF16_LADDER_KW, BF16_FLOPS, versus=True)
        del dia
        torch.cuda.synchronize()
    served, f32 = res["bf16"]["run"], res["f32"]["run"]
    counts = kernels.launch_counts()
    torch.cuda.empty_cache()
    n_dec, n_enc = len(_residual_units(dac.decoder)), len(_residual_units(dac.encoder))
    want = _with_attn({**_NO_LAUNCHES,
                       "codebook_argmin": dac.config.n_codebooks * dac_calls.calls["encode"],
                       "fused_residual_unit_dense": n_dec * dac_calls.calls["from_codes"]
                       + n_enc * dac_calls.calls["encode"]}, counts)
    runs = {"bf16": served, "clone": clone, "f32": f32, "int8": res["int8"]["run"],
            "int4": res["int4"]["run"]}
    for label, run in runs.items():
        codes, lengths = run["codes"]
        if codes.min() < 0 or codes.max() > 1023 or lengths.max() > DIA_BF16_KW["max_tokens"]:
            raise PhaseError(f"{label}: codes in [{codes.min()}, {codes.max()}], "
                             f"lengths {lengths}")
    sync_ok = all(r["syncs"] <= r["steps"] // dia_model._SYNC_EVERY + 16 for r in runs.values())
    logits = _dia_bf16_card_vs_cpu()
    series = res["series"]
    median = {name: float(np.median(v)) for name, v in series.items()}
    print("    dia step in alternating order (ms, CUDA events, sorted): " + "; ".join(
        f"{name} {', '.join(f'{x:.2f}' for x in v)} (median {median[name]:.2f})"
        for name, v in series.items())
        + f"; bf16 / f32 medians {median['bf16'] / median['f32']:.3f} on {card}")
    for label in ("bf16", "f32", "int8", "int4"):
        _print_dia_step(label, res[label]["run"], res[label]["step"], res[label]["bound"], card)
        print(f"    dia {label}: {res[label]['bytes'] / 1e9:.2f} GB a step")
    versus = {k: res[k]["graphed_vs_eager"] for k in ("bf16", "int4")}
    for label, v in versus.items():
        print(f"    dia graphed vs eager, {label}, 4 requests to 128 tokens: codes equal "
              f"{v['equal']} (lengths {v['lengths']}), NaN logits in the eager run "
              f"{v['nan_logits']}")
    res["counts"], res["dac_calls"], res["card_vs_cpu"] = counts, dict(dac_calls.calls), logits
    for label in ("bf16", "f32", "int8", "int4"):
        res[label]["run"] = {k: v for k, v in res[label]["run"].items()
                             if k not in ("audios", "codes")}
    res["clone"] = {k: v for k, v in clone.items() if k not in ("audios", "codes")}
    res["seconds"] = time.perf_counter() - t_phase
    versus_ok = all(v["equal"] and not v["nan_logits"] for v in versus.values())
    ok = (counts == want and counts["codebook_argmin"] > 0 and logits["ok"] and sync_ok
          and versus_ok)
    phase("dia bf16", ok,
          f"load_dia(compute_dtype=bf16) in {load_s:.2f} s; launches {counts} == {want} "
          f"({dac_calls.calls}); 4 requests to {DIA_BF16_KW['max_tokens']} tokens: bf16 "
          f"{served['tokens_per_s']:.1f} tokens/s, step {res['bf16']['step']['ms']:.2f} ms, "
          f"peak {served['peak_gb']:.2f} GB; f32 {f32['tokens_per_s']:.1f} tokens/s, step "
          f"{res['f32']['step']['ms']:.2f} ms, peak {f32['peak_gb']:.2f} GB; voice clone "
          f"({prompt.shape[0]} prompt frames) {clone['wall_s']:.2f} s; ladders at bf16 to "
          f"{DIA_BF16_LADDER_KW['max_tokens']}: int8 step {res['int8']['step']['ms']:.2f} ms, "
          f"int4 {res['int4']['step']['ms']:.2f} ms; syncs within steps / "
          f"{dia_model._SYNC_EVERY} + 16: {sync_ok}; 2 + 2 layers in bf16 against f64, max "
          f"|err| (card / CPU bf16 / limit / fp8 control / reduced reduction): " + "; ".join(
              f"{k} {e['card']:.3e} / {e['cpu']:.3e} / {logits['limits'][k]:.3e} / "
              f"{e['fp8']:.3e} / {e['reduced']:.3e}" for k, e in logits["err_vs_f64"].items())
          + f" (max |logit| {logits['logit_scale']:.2f}); card within: {logits['within']}, "
          f"control outside: {logits['control_caught']}; card vs CPU logits "
          f"{logits['card_vs_cpu']:.3e}, finite {logits['finite']} ({logits['seconds']:.1f} s); "
          f"graphed codes == eager codes at 128 tokens (bf16, int4): "
          f"{[v['equal'] for v in versus.values()]}, no NaN logit in the eager runs; "
          f"{res['seconds']:.1f} s on {card}")
    return res


CODEC_MODES = {"mixed": "decoder_dtype", "bf16": "compute_dtype"}


def _codec_roundtrip(name: str, model, batch: np.ndarray) -> tuple[list, torch.Tensor]:
    """(codes, audio) of one round trip of a [B, T] batch as the servers
    run it."""
    if name == "snac":
        audio, codes = model.forward(batch)
        return codes, audio
    if name == "dac":
        out = model.forward(batch)
        return [out["codes"]], out["audio"]
    frames = model.encode(batch[:, None, :])
    return [f.codes for f in frames], model.decode(frames)[..., :batch.shape[-1]]


def phase_codec_precision(tmp: Path, card: str) -> dict:
    """SNAC-24k, DAC-44k and Encodec-24k loaded from phase_loader's exports
    through load_snac / load_dac / load_encodec in f32, in the mixed mode
    (decoder_dtype=bf16) and in the bf16 mode (compute_dtype=bf16): the
    served 4 x 10 s batch in each. The mixed mode's codes must be the f32
    mode's bit for bit; the bf16 mode's share of equal codes is printed (JAX
    promises equality only for the mixed mode). The decoded audio's SNR
    against the f32 mode's, the warm round trip's ms by CUDA events in each
    mode, and the kernels' launches a round trip, equal in every mode (the
    modes hand the kernels f32)."""
    from neuralcodecs_tpu_torch import load_dac, load_encodec, load_snac
    from neuralcodecs_tpu_torch.ops import kernels

    families = {"snac": (load_snac, "snac_24khz"), "dac": (load_dac, "dac_44khz"),
                "encodec": (load_encodec, "encodec_24khz")}
    t_phase = time.perf_counter()
    res, total, ok = {}, dict(_NO_LAUNCHES), True
    for name, (load, dirname) in families.items():
        models = {"f32": load(str(tmp / dirname), device=DEVICE).eval()}
        for mode, key in CODEC_MODES.items():
            models[mode] = load(str(tmp / dirname), device=DEVICE, **{key: BF16}).eval()
        sr = models["f32"].config.sample_rate
        batch = (0.3 * np.random.default_rng(SEED + 30).standard_normal(
            (4, 10 * sr))).astype(np.float32)
        out, per_call, ms = {}, {}, {}
        for mode, model in models.items():
            kernels.reset_launch_counts()
            out[mode] = _codec_roundtrip(name, model, batch)
            torch.cuda.synchronize()
            per_call[mode] = kernels.launch_counts()
            kernels.reset_launch_counts()
            ms[mode] = time_ms(lambda: _codec_roundtrip(name, model, batch), 3, 1)
            for k, n in kernels.launch_counts().items():
                total[k] += n + per_call[mode][k]
        codes32, audio32 = out["f32"]
        fam = {"ms": ms, "launches_a_call": per_call["f32"]}
        for mode in CODEC_MODES:
            codes, audio = out[mode]
            equal = sum(int((a == b).sum()) for a, b in zip(codes, codes32, strict=True))
            count = sum(c.numel() for c in codes32)
            fam[mode] = {"codes_equal": equal, "codes": count, "share_equal": equal / count,
                         "dtype": str(audio.dtype),
                         "snr_db": _snr_db(audio32.cpu().numpy().ravel(),
                                           audio.cpu().numpy().ravel())}
            print(f"    {name} {mode}: codes equal to f32's {equal}/{count} "
                  f"({equal / count:.4%}), audio {fam[mode]['snr_db']:.1f} dB from f32, "
                  f"round trip {ms[mode]:.2f} ms (f32 {ms['f32']:.2f} ms) on {card}")
        fam_ok = (fam["mixed"]["share_equal"] == 1.0
                  and all(per_call[m] == per_call["f32"] for m in models)
                  and sum(per_call["f32"].values()) > 0
                  and all(fam[m]["dtype"] == "torch.float32" for m in CODEC_MODES))
        ok = ok and fam_ok
        res[name] = fam
        del models
    torch.cuda.empty_cache()
    res["counts"], res["seconds"] = total, time.perf_counter() - t_phase
    phase("codec precision", ok,
          "4 x 10 s round trips, loaded through load_* in each mode: mixed codes == f32 "
          "codes: " + ", ".join(f"{n} {res[n]['mixed']['share_equal'] == 1.0}"
                                for n in families)
          + "; bf16 codes equal: " + ", ".join(f"{n} {res[n]['bf16']['share_equal']:.4%}"
                                               for n in families)
          + "; ms f32 / mixed / bf16: " + ", ".join(
              f"{n} {res[n]['ms']['f32']:.2f} / {res[n]['ms']['mixed']:.2f} / "
              f"{res[n]['ms']['bf16']:.2f}" for n in families)
          + f"; launches a round trip equal in every mode; {res['seconds']:.1f} s on {card}")
    return res


# --------------------------------------------------------- loader phases


def _dir_bytes(directory: Path) -> int:
    return sum(f.stat().st_size for f in directory.iterdir() if f.is_file())


def _states_equal(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _export_and_load(label: str, seeded, directory: Path, load, card: str,
                     max_shard_bytes: int | None = None):
    """save_pretrained ``seeded`` into ``directory``, load it back on the card
    with ``load(directory)``; the state dicts must be equal bit for bit.
    Seconds by the host's clock around each synchronised call."""
    from neuralcodecs_tpu_torch import save_pretrained

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_pretrained(seeded, directory, max_shard_bytes=max_shard_bytes)
    save_s = time.perf_counter() - t0
    nbytes = _dir_bytes(directory)
    t0 = time.perf_counter()
    loaded = load(str(directory))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal = _states_equal(seeded, loaded)
    files = sorted(f.name for f in directory.iterdir())
    res = {"bytes": nbytes, "files": files, "save_s": save_s, "load_s": load_s,
           "save_gb_per_s": nbytes / 1e9 / save_s, "load_gb_per_s": nbytes / 1e9 / load_s,
           "equal": equal}
    phase(f"load {label}", equal and loaded.device.type == torch.device(DEVICE).type,
          f"save_pretrained {nbytes / 1e9:.3f} GB ({len(files)} files) in {save_s:.2f} s "
          f"({res['save_gb_per_s']:.2f} GB/s), loaded on {loaded.device} in {load_s:.2f} s "
          f"({res['load_gb_per_s']:.2f} GB/s), state dicts equal: {equal}; on {card}")
    return loaded.eval(), res


def _folded_keyset(name: str) -> list[str]:
    """A tests/keysets fixture's key names with each weight-norm pair folded
    to its ``weight``, less the buffers the port does not keep."""
    fixture = json.loads((ROOT / "tests" / "keysets" / f"{name}.json").read_text())
    names = set()
    for key in fixture["keys"]:
        for g_suffix, v_suffix in ((".parametrizations.weight.original0",
                                    ".parametrizations.weight.original1"),
                                   (".weight_g", ".weight_v")):
            if key.endswith((g_suffix, v_suffix)):
                key = key[: -len(g_suffix if key.endswith(g_suffix) else v_suffix)] + ".weight"
                break
        names.add(key)
    return sorted(names)


def phase_loader(tmp: Path, card: str) -> tuple:
    """The served codecs come from files: SNAC-24k, Encodec-24k and DAC-44k
    are seeded, exported with save_pretrained and loaded back on the card
    through load_snac (with validate=True: validate_model's round trip runs
    on the card) / load_encodec / load_dac; every later phase runs on the
    loaded models. Then SNAC-24k from a torch.save file under upstream's
    folded key names in {"state_dict": ...} nesting, read by the restricted
    unpickler: its served 4 x 10 s batch must give the native load's codes
    bit for bit. Returns (snac, encodec, dac, the DAC export's directory,
    the results)."""
    from neuralcodecs_tpu_torch import load_dac, load_encodec, load_snac
    from neuralcodecs_tpu_torch.core import importer
    from neuralcodecs_tpu_torch.core.loader import LoadOptions
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
    from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
    from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

    res = {}
    validated = LoadOptions(validate=True)
    snac, res["snac_24khz"] = _export_and_load(
        "snac-24k", SNAC(SNACConfig.snac_24khz(), device=DEVICE, seed=SEED).eval(),
        tmp / "snac_24khz", lambda d: load_snac(d, options=validated, device=DEVICE), card)
    enc, res["encodec_24khz"] = _export_and_load(
        "encodec-24k", Encodec(EncodecConfig.encodec_24khz(), device=DEVICE, seed=SEED).eval(),
        tmp / "encodec_24khz", lambda d: load_encodec(d, device=DEVICE), card)
    dac_dir = tmp / "dac_44khz"
    dac, res["dac_44khz"] = _export_and_load(
        "dac-44k", DAC(DACConfig.dac_44khz(), device=DEVICE, seed=SEED).eval(), dac_dir,
        lambda d: load_dac(d, device=DEVICE), card)

    # upstream's names, a torch.save file, the restricted reader
    sd = {k: v.cpu() for k, v in snac.state_dict().items()}
    names_ok = sorted(sd) == _folded_keyset("snac_24khz")
    path = tmp / "snac_24khz.pth"
    torch.save({"state_dict": sd}, path)
    reads, reader = [], importer.load_torch_checkpoint
    importer.load_torch_checkpoint = lambda p: reads.append(Path(p).name) or reader(p)
    try:
        t0 = time.perf_counter()
        upstream = load_snac(str(path), config=SNACConfig.snac_24khz(), device=DEVICE).eval()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        importer.load_torch_checkpoint = reader
    rng = np.random.default_rng(SEED + 1)
    batch = (0.3 * rng.standard_normal((4, 10 * snac.config.sample_rate))).astype(np.float32)
    want, got = snac.encode(batch), upstream.encode(batch)
    codes_equal = all(torch.equal(a, b) for a, b in zip(want, got, strict=True))
    res["snac_24khz_pth"] = {"bytes": path.stat().st_size, "load_s": load_s,
                             "names_are_the_keysets": names_ok, "codes_equal": codes_equal,
                             "reads": reads}
    phase("load snac-24k upstream .pth", names_ok and codes_equal and reads == [path.name]
          and _states_equal(snac, upstream),
          f"{len(sd)} tensors under tests/keysets/snac_24khz.json's folded names: {names_ok}; "
          f"{path.stat().st_size / 1e6:.1f} MB read by the restricted unpickler {reads} and "
          f"loaded in {load_s:.2f} s; 4 x 10 s batch codes equal the native load's: "
          f"{codes_equal} ({[tuple(c.shape) for c in got]})")
    del upstream
    return snac, enc, dac, dac_dir, res


def phase_lm_cache(enc, tmp: Path, card: str) -> dict:
    """The Encodec-24k LM through the cache, with the network refused: the
    seeded 24 kHz LM is torch.saved under its checkpoint URL's cache entry
    (ModelCache.cache_model, NEURALCODECS_CACHE pointed at a temporary
    directory), then ``enc.get_language_model()`` resolves the URL, finds
    the entry and loads it; its pdfs, teacher-forced over a 10 s clip's
    codes, must equal the seeded LM's on the card. The LM-coded .ecdc phase
    then codes with this LM."""
    import os
    from urllib.parse import urlparse

    from neuralcodecs_tpu_torch.core import repos
    from neuralcodecs_tpu_torch.core.cache import ModelCache
    from neuralcodecs_tpu_torch.models.encodec import Encodec

    url = enc._LM_CHECKPOINTS[enc.config.sample_rate]
    seeded = Encodec(enc.config, device=DEVICE).get_language_model(download=False)
    th = tmp / "lm.th"
    torch.save({k: v.cpu() for k, v in seeded.state_dict().items()}, th)
    previous = os.environ.get("NEURALCODECS_CACHE")
    os.environ["NEURALCODECS_CACHE"] = str(tmp / "model_cache")
    fetched, saved = [], (repos._download_file, repos._http_get, repos._http_post_json)

    def refuse(*args, **kwargs):
        fetched.append(args[0] if args else "")
        raise OSError("the smoke has no network")

    repos._download_file = repos._http_get = repos._http_post_json = refuse
    try:
        entry = ModelCache().cache_model(url, "main", {Path(urlparse(url).path).name: th})
        t0 = time.perf_counter()
        lm = enc.get_language_model()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        repos._download_file, repos._http_get, repos._http_post_json = saved
        if previous is None:
            os.environ.pop("NEURALCODECS_CACHE", None)
        else:
            os.environ["NEURALCODECS_CACHE"] = previous
    rng = np.random.default_rng(SEED + 6)
    clip = (0.3 * rng.standard_normal(STREAM_SECONDS * enc.config.sample_rate)).astype(np.float32)
    codes = enc.encode(clip)[0].codes                                  # [1, K, T]
    inputs = torch.zeros_like(codes, dtype=torch.long)
    inputs[..., 1:] = codes[..., :-1].long() + 1
    got, want = lm.forward_full(inputs), seeded.forward_full(inputs)
    equal = torch.equal(got, want)
    same_lm = enc.get_language_model(download=False) is lm and lm.device == enc.device
    phase("lm from the cache", equal and same_lm and not fetched,
          f"{url} served from {entry.relative_to(tmp)} in {load_s:.2f} s with no fetch "
          f"({fetched}); pdfs over {tuple(codes.shape)} codes equal the seeded LM's on the "
          f"card: {equal}; on {card}")
    return {"load_s": load_s, "pdfs_equal": equal, "entry": str(entry.relative_to(tmp)),
            "codes": list(codes.shape)}


# ------------------------------------------------------- serving phases


HTTP_ROUNDS = 5          # rounds of four concurrent 10 s /roundtrip requests (SNAC-24k)
HTTP_WINDOW_MS = 50.0    # the micro-batcher's window in these phases
DIA_HTTP_TOKENS = 64     # max_tokens of the Dia server's requests (the phases' time budget)
DIA_HTTP_BUCKET = 1024   # --dia-token-bucket: the served bucket of the Dia phases


class _HttpClient:
    """One keep-alive HTTP/1.1 connection to a local server (stdlib
    http.client); each request's client-side latency goes to ``lat`` by
    route."""

    def __init__(self, port: int, lat: dict):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
        self.lat = lat

    def post(self, path: str, body: bytes, headers: dict | None = None,
             record: bool = True) -> tuple[int, bytes]:
        t0 = time.perf_counter()
        self.conn.request("POST", path, body=body, headers=headers or {})
        resp = self.conn.getresponse()
        data = resp.read()
        if record:
            self.lat.setdefault(path.split("?", 1)[0], []).append(time.perf_counter() - t0)
        if resp.getheader("Connection") == "close":
            self.conn.close()
        return resp.status, data

    def get_json(self, path: str) -> dict:
        self.conn.request("GET", path)
        return json.loads(self.conn.getresponse().read())

    def close(self) -> None:
        self.conn.close()


def _concurrently(*fns) -> list:
    """Run the callables in threads at once; their results in order (a
    failure in any is raised here)."""
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result(timeout=900) for f in futures]


def _record_batches(srv) -> tuple[list, object]:
    """Shadow a codec server's batched forward to keep a copy of each stacked
    batch it runs; returns (the batches, the forward itself)."""
    stacked, forward = [], srv._forward_batch

    def recorded(x):
        stacked.append(x.clone())
        return forward(x)
    srv._forward_batch = recorded
    return stacked, forward


def _batched_replies_equal(stacked, forward, bodies, replies, sr: int) -> tuple[int, int]:
    """(replies equal to _array_to_wav of their row of a direct forward of the
    batch the batcher stacked, batches): each request's row is found by its
    prepared audio."""
    from neuralcodecs_tpu_torch.cli.serve import _array_to_wav, _wav_to_array

    rows = {}
    for x in stacked:
        out = forward(x).cpu().numpy()
        for j in range(x.shape[0]):
            rows[x[j].cpu().numpy().tobytes()] = out[j]
    equal = 0
    for body, (status, wav) in zip(bodies, replies):
        key = _wav_to_array(body)[0].tobytes()  # [1, T]: a mono row's bytes either way
        equal += status == 200 and key in rows and wav == _array_to_wav(rows[key], sr)
    return equal, len(stacked)


def _latencies(lat: dict, metrics: dict) -> dict:
    """Per route: client-side p50 / p90 ms, and the server's /metrics count,
    p50 and p95 ms."""
    out = {}
    for route, secs in sorted(lat.items()):
        srv = metrics["routes"].get(route, {})
        out[route] = {"n": len(secs), "p50_ms": _pct(secs, 50) * 1e3,
                      "p90_ms": _pct(secs, 90) * 1e3, "server_count": srv.get("count"),
                      "server_errors": srv.get("errors"),
                      "server_p50_ms": srv.get("p50_ms"), "server_p95_ms": srv.get("p95_ms")}
    return out


def _print_serving(label: str, res: dict, card: str) -> None:
    print(f"    {label}: warm-up {res['warmup_s']:.2f} s on {card}")
    for route, r in res["latency"].items():
        print(f"    {label} {route}: {r['n']} requests, client p50 {r['p50_ms']:.1f} / p90 "
              f"{r['p90_ms']:.1f} ms; /metrics count {r['server_count']} (errors "
              f"{r['server_errors']}), p50 "
              f"{r['server_p50_ms']} / p95 {r['server_p95_ms']} ms on {card}")
    if res.get("batcher"):
        b = res["batcher"]
        print(f"    {label} micro-batcher: {b['batches']} batches, mean batch {b['mean_batch']}, "
              f"max {b['max_batch_seen']} on {card}")


def phase_snac_http(model, card: str) -> dict:
    """SNAC-24k behind the real HTTP server (cli/serve.py's CodecServer on
    127.0.0.1:0, micro-batching in a 50 ms window up to 4), clients on
    keep-alive connections in threads: rounds of four concurrent 10 s
    /roundtrip requests, each round one batch-4 forward whose replies equal,
    byte for byte, _array_to_wav of a direct model.forward of the batch the
    batcher stacked; /encode's codes equal model.encode's; /decode of them
    equals model.decode; a bad body gets 400 and an oversize Content-Length
    413. Kernels 1 and 2a launch from the server's threads."""
    from neuralcodecs_tpu_torch.cli.serve import (MAX_BODY_BYTES, CodecServer, _array_to_wav,
                                                  _wav_to_array)
    from neuralcodecs_tpu_torch.ops import kernels

    sr = model.config.sample_rate
    rng = np.random.default_rng(SEED + 11)
    bodies = [_array_to_wav((0.3 * rng.standard_normal(10 * sr)).astype(np.float32), sr)
              for _ in range(4 * HTTP_ROUNDS)]
    srv = CodecServer(model, "snac", port=0, batch_window_ms=HTTP_WINDOW_MS, max_batch=4)
    t0 = time.perf_counter()
    srv.warmup(lengths_s=(10.0,))
    warm_s = time.perf_counter() - t0
    stacked, forward = _record_batches(srv)
    srv.start_background()
    lat: dict = {}
    clients = [_HttpClient(srv.port, lat) for _ in range(4)]
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        replies, round_ms = [], []
        for r in range(HTTP_ROUNDS):
            t = time.perf_counter()
            replies += _concurrently(*[functools.partial(c.post, "/roundtrip", bodies[4 * r + i])
                                       for i, c in enumerate(clients)])
            round_ms.append((time.perf_counter() - t) * 1e3)
        enc_status, enc_body = clients[0].post("/encode", bodies[0])
        codes = json.loads(enc_body)["codes"]
        dec_status, dec_body = clients[0].post("/decode", json.dumps({"codes": codes}).encode())
        bad = clients[1].post("/roundtrip", b"not a wav file", record=False)
        oversize = clients[2].post("/roundtrip", b"x" * 16,
                                   {"Content-Length": str(MAX_BODY_BYTES + 1)}, record=False)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        metrics = clients[3].get_json("/metrics")
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
    n_stages = len(model.config.vq_strides)
    n_units = len(_residual_units(model.encoder)) + len(_residual_units(model.decoder))
    forwards = len(stacked)
    want = {**_NO_LAUNCHES, "codebook_argmin": n_stages * (forwards + 1),
            "fused_residual_unit": n_units * (forwards + 1)}
    equal, batches = _batched_replies_equal(stacked, forward, bodies, replies, sr)
    x0 = _wav_to_array(bodies[0])[0][0]
    codes_equal = enc_status == 200 and codes == [c.cpu().numpy().tolist()
                                                  for c in model.encode(x0)]
    decoded = model.decode([np.asarray(c, np.int32) for c in codes])[0].cpu().numpy()
    decode_equal = dec_status == 200 and dec_body == _array_to_wav(decoded, sr)
    sizes = list(srv.batcher.observed_batches)
    res = {"counts": counts, "warmup_s": warm_s, "latency": _latencies(lat, metrics),
           "batcher": metrics.get("batcher"), "batches": sizes, "round_ms": round_ms,
           "replies_equal": equal, "codes_equal": codes_equal, "decode_equal": decode_equal,
           "errors": [bad[0], oversize[0]]}
    _print_serving("snac-24k http", res, card)
    print(f"    snac-24k http: each round of 4 requests took {[round(t, 1) for t in round_ms]} "
          f"ms on {card}")
    phase("snac http", counts == want and equal == len(bodies) and sizes == [4] * HTTP_ROUNDS
          and metrics["batcher"]["max_batch_seen"] == 4 and codes_equal and decode_equal
          and bad[0] == 400 and oversize[0] == 413,
          f"{len(bodies)} concurrent 10 s /roundtrip requests in {batches} batches {sizes} "
          f"(/metrics max_batch_seen {metrics['batcher']['max_batch_seen']}); replies equal "
          f"to the direct forward of the stacked batch {equal}/{len(bodies)}; /encode codes "
          f"== model.encode: {codes_equal}; /decode == model.decode: {decode_equal}; bad body "
          f"{bad[0]}, oversize {oversize[0]}; launches {counts} == {want}; warm-up "
          f"{warm_s:.2f} s on {card}")
    return res


def _stream_local(model, audio: np.ndarray, chunk: int, blocks) -> np.ndarray:
    """A local roundtrip session pair with the server's block_hops: the PCM
    of ``audio`` pushed ``chunk`` samples at a time."""
    from neuralcodecs_tpu_torch.models.encodec import StreamingDecoder, StreamingEncoder

    enc = StreamingEncoder(model, block_hops=blocks)
    dec = StreamingDecoder(model, block_hops=blocks)
    return np.concatenate([dec.push(enc.push(audio[o: o + chunk]))[0, :, 0].cpu().numpy()
                           for o in range(0, audio.size, chunk)])


def phase_encodec_http(enc, card: str) -> dict:
    """Encodec-24k behind the HTTP server and, on the same device lock, the
    TCP streaming server (`serve --stream-port`), at the same time: four
    roundtrip sessions push 10 s each in 8-hop chunks from four threads
    while two 10 s /roundtrip requests run; each session's f32 PCM equals a
    local session pair's on the same pushes and block_hops, bit for bit
    (sessions in threads, interleaved on one lock and one stream, stay
    isolated, kernel 3's counter included), and each /roundtrip reply the
    direct forward of its stacked batch. Then an encode session piped into a
    decode session gives the same audio, and /compress?lm=1 (the LM from the
    model cache) gives model.compress(use_lm=True)'s bytes on the same card,
    /decompress its decode. Kernels 1 and 3 launch from the servers'
    threads."""
    from neuralcodecs_tpu_torch.cli.serve import CodecServer, _array_to_wav, _wav_to_array
    from neuralcodecs_tpu_torch.cli.stream_serve import StreamClient, StreamingCodecServer
    from neuralcodecs_tpu_torch.ops import kernels

    sr, hop, n_q = enc.config.sample_rate, enc.encoder.hop_length, enc._n_q()
    chunk, blocks = 8 * hop, (8, 1)
    rng = np.random.default_rng(SEED + 12)
    audios = [(0.3 * rng.standard_normal(10 * sr)).astype(np.float32) for _ in range(4)]
    bodies = [_array_to_wav((0.3 * rng.standard_normal(10 * sr)).astype(np.float32), sr)
              for _ in range(2)]
    srv = CodecServer(enc, "encodec", port=0, batch_window_ms=HTTP_WINDOW_MS, max_batch=2)
    tcp = StreamingCodecServer(enc, port=0, device_lock=srv._device_lock, block_hops=blocks)
    t0 = time.perf_counter()
    srv.warmup(lengths_s=(10.0,))
    tcp.warmup()
    warm_s = time.perf_counter() - t0
    stacked, forward = _record_batches(srv)
    srv.start_background()
    tcp.start_background()
    lat: dict = {}
    clients = [_HttpClient(srv.port, lat) for _ in range(2)]

    def session(audio):
        cli = StreamClient("127.0.0.1", tcp.port, "roundtrip", chunk)
        outs, walls = [], []
        for o in range(0, audio.size, chunk):
            t = time.perf_counter()
            outs.append(np.frombuffer(cli.push(audio[o: o + chunk]), "<f4"))
            walls.append(time.perf_counter() - t)
        if cli.close() != b"":
            raise PhaseError("stream session: no closing frame")
        return np.concatenate(outs), walls

    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = _concurrently(*[functools.partial(session, a) for a in audios],
                                *[functools.partial(c.post, "/roundtrip", b)
                                  for c, b in zip(clients, bodies)])
        sessions, replies = results[:4], results[4:]
        ce = StreamClient("127.0.0.1", tcp.port, "encode", chunk)
        cd = StreamClient("127.0.0.1", tcp.port, "decode", 0)
        piped = []
        for o in range(0, audios[0].size, chunk):
            raw = ce.push(audios[0][o: o + chunk])
            f = struct.unpack(">II", raw[:8])
            frame = np.frombuffer(raw[8:], ">i4").reshape(f).astype(np.int32)
            piped.append(np.frombuffer(cd.push_codes(frame), "<f4"))
        ce.close(), cd.close()
        piped = np.concatenate(piped)
        lm_status, blob = clients[0].post("/compress?lm=1", bodies[0])
        dec_status, dec_body = clients[1].post("/decompress", blob)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        metrics = clients[0].get_json("/metrics")
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
        tcp.shutdown()
    hops = audios[0].size // hop
    steps = len(_decompose_pushes([(o, min(o + 8, hops)) for o in range(0, hops, 8)], blocks))
    forwards = len(stacked)
    # a roundtrip sub-step: n_q codebook launches, 2 + 2 LSTM layers; an
    # encode step n_q + 2, a decode step 2; compress encodes, decompress decodes
    want = {**_NO_LAUNCHES,
            "codebook_argmin": n_q * (4 * steps + steps + forwards + 1),
            "lstm_scan": 4 * 4 * steps + 2 * steps + 2 * steps + 4 * forwards + 2 + 2}
    local = [_stream_local(enc, a, chunk, blocks) for a in audios]
    sessions_equal = sum(np.array_equal(pcm, ref) for (pcm, _), ref in zip(sessions, local))
    piped_equal = np.array_equal(piped, local[0])
    equal, batches = _batched_replies_equal(stacked, forward, bodies, replies, sr)
    x0 = torch.as_tensor(_wav_to_array(bodies[0])[0], device=DEVICE)
    lm = enc.get_language_model(download=False)
    direct = enc.compress(x0, use_lm=True, lm=lm)
    compress_equal = lm_status == 200 and blob == direct
    decompress_equal = dec_status == 200 and dec_body == _array_to_wav(
        enc.decompress(direct, lm=lm)[0].cpu().numpy(), sr)
    walls = [w * 1e3 for _, ws in sessions for w in ws]
    res = {"counts": counts, "warmup_s": warm_s, "latency": _latencies(lat, metrics),
           "batcher": metrics.get("batcher"), "stream_push_ms_p50": _pct(walls, 50),
           "stream_push_ms_p90": _pct(walls, 90), "pushes": len(walls),
           "sessions_equal": sessions_equal, "piped_equal": piped_equal,
           "replies_equal": equal, "compress_lm_equal": compress_equal,
           "decompress_equal": decompress_equal, "ecdc_lm_bytes": len(blob)}
    _print_serving("encodec-24k http", res, card)
    print(f"    encodec-24k tcp: 4 sessions x {len(walls) // 4} pushes of {chunk} samples "
          f"({chunk / sr * 1e3:.1f} ms) beside 2 /roundtrip requests: a push's client wall "
          f"p50 {res['stream_push_ms_p50']:.2f} / p90 {res['stream_push_ms_p90']:.2f} ms on "
          f"{card}")
    phase("encodec http + stream", counts == want and sessions_equal == 4 and piped_equal
          and equal == len(bodies) and compress_equal and decompress_equal,
          f"4 TCP sessions ({steps} sub-steps each) equal to local sessions bit for bit: "
          f"{sessions_equal}/4; encode -> decode piped == local: {piped_equal}; 2 concurrent "
          f"/roundtrip replies in {batches} batch(es) equal to the direct forward: "
          f"{equal}/2; /compress?lm=1 == model.compress(use_lm=True) ({len(blob)} B): "
          f"{compress_equal}; /decompress == decompress: {decompress_equal}; launches "
          f"{counts} == {want}; warm-up {warm_s:.2f} s on {card}")
    return res


def phase_dac_http(dac, card: str) -> dict:
    """DAC-44k behind the HTTP server (batching off): two 10 s /roundtrip
    requests equal the direct round trip, /compress gives dac_file_bytes of
    model.encode's codes, /decompress of those bytes equals from_codes.
    Kernels 1 and 2b launch from the server's threads."""
    from neuralcodecs_tpu_torch.cli.serve import CodecServer, _array_to_wav, _wav_to_array
    from neuralcodecs_tpu_torch.models.dac.dacfile import dac_file_bytes
    from neuralcodecs_tpu_torch.ops import kernels

    sr = dac.config.sample_rate
    rng = np.random.default_rng(SEED + 13)
    bodies = [_array_to_wav((0.3 * rng.standard_normal(10 * sr)).astype(np.float32), sr)
              for _ in range(2)]
    srv = CodecServer(dac, "dac", port=0, batch_window_ms=0)
    t0 = time.perf_counter()
    srv.warmup(lengths_s=(10.0,))
    warm_s = time.perf_counter() - t0
    srv.start_background()
    lat: dict = {}
    client = _HttpClient(srv.port, lat)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        replies = [client.post("/roundtrip", b) for b in bodies]
        c_status, blob = client.post("/compress", bodies[0])
        d_status, wav = client.post("/decompress", blob)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        metrics = client.get_json("/metrics")
    finally:
        client.close()
        srv.shutdown()
    n_enc, n_dec = len(_residual_units(dac.encoder)), len(_residual_units(dac.decoder))
    n_q = dac.config.n_codebooks
    want = {**_NO_LAUNCHES, "codebook_argmin": n_q * 3,
            "fused_residual_unit_dense": (n_enc + n_dec) * 2 + n_enc + n_dec}
    xs = [_wav_to_array(b)[0][0] for b in bodies]
    roundtrip_equal = sum(s == 200 and w == _array_to_wav(dac.process_audio(x, sr), sr)
                          for (s, w), x in zip(replies, xs))
    codes = dac.encode(xs[0])[1].cpu().numpy()
    compress_equal = c_status == 200 and blob == dac_file_bytes([codes], dac.config)
    decompress_equal = d_status == 200 and wav == _array_to_wav(
        dac.from_codes(codes)[0].cpu().numpy(), sr)
    res = {"counts": counts, "warmup_s": warm_s, "latency": _latencies(lat, metrics),
           "roundtrip_equal": roundtrip_equal, "compress_equal": compress_equal,
           "decompress_equal": decompress_equal, "dac_bytes": len(blob)}
    _print_serving("dac-44k http", res, card)
    phase("dac http", counts == want and roundtrip_equal == 2 and compress_equal
          and decompress_equal,
          f"2 x 10 s /roundtrip == the direct round trip: {roundtrip_equal}/2; /compress == "
          f"dac_file_bytes of model.encode ({len(blob)} B): {compress_equal}; /decompress == "
          f"from_codes: {decompress_equal}; launches {counts} == {want}; warm-up "
          f"{warm_s:.2f} s on {card}")
    return res


def phase_dia_http(dia, card: str) -> dict:
    """The full Dia 1.6B (f32, loaded from its export, vocoded by the DAC-44k
    export) behind the HTTP server with --dia-token-bucket 1024 and
    micro-batching up to 4: four concurrent single-text /tts requests of
    max_tokens 64 (cut from the served 512 for the time budget) coalesce
    into one generate, and each WAV equals a direct generate of the four
    texts in the order the batcher stacked them (a row's noise follows its
    slot); /tts/stream of one text (segments of 32) equals the direct
    generate_stream's PCM, and its time to the first audio is recorded.
    Then a /tts/stream (128 tokens in segments of 8) with a /tts sent once
    its first audio is in: the stream takes the device lock a segment at a
    time and each generation borrows its own pooled decode state, so each
    reply must equal its request's solo generation; whether the /tts reply
    came before the stream's end is recorded. Kernel 2b launches from the
    batcher's and the handler's threads."""
    from neuralcodecs_tpu_torch.cli.serve import CodecServer, _array_to_wav, _streaming_wav_header
    from neuralcodecs_tpu_torch.ops import kernels

    dac, sr = dia.dac, dia.config.sample_rate
    srv = CodecServer(dia, "dia", port=0, batch_window_ms=200.0, max_batch=4,
                      dia_token_bucket=DIA_HTTP_BUCKET)
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    srv.start_background()
    lat: dict = {}
    clients = [_HttpClient(srv.port, lat) for _ in range(4)]
    stream_kw = dict(max_tokens=DIA_HTTP_TOKENS, segment_tokens=32)
    inter_kw = dict(max_tokens=128, segment_tokens=8)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with _CallCount(dia, ("generate",)) as gen_calls, \
                _CallCount(dac, ("from_codes",)) as vocodes:
            replies = _concurrently(*[functools.partial(
                c.post, "/tts", json.dumps({"text": t, "max_tokens": DIA_HTTP_TOKENS}).encode())
                for c, t in zip(clients, DIA_TEXTS)])
            conn = clients[0].conn
            t_req = time.perf_counter()
            conn.request("POST", "/tts/stream", body=json.dumps(
                {"text": DIA_TEXTS[0], **stream_kw}).encode())
            resp = conn.getresponse()
            first = resp.read(44 + 2)
            first_audio_s = time.perf_counter() - t_req
            stream_blob = first + resp.read()
            stream_s = time.perf_counter() - t_req
            lat.setdefault("/tts/stream", []).append(stream_s)
            stream_status = resp.status
            # a /tts while a /tts/stream runs
            started = threading.Event()

            def read_stream():
                c = clients[2].conn
                c.request("POST", "/tts/stream", body=json.dumps(
                    {"text": DIA_TEXTS[2], **inter_kw}).encode())
                r = c.getresponse()
                head = r.read(44 + 2)
                started.set()
                return r.status, head + r.read(), time.perf_counter()

            def post_tts():
                started.wait(600)
                reply = clients[3].post("/tts", json.dumps(
                    {"text": DIA_TEXTS[3], "max_tokens": DIA_HTTP_TOKENS}).encode())
                return reply, time.perf_counter()
            inter_stream, (inter_tts, t_tts) = _concurrently(read_stream, post_tts)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        metrics = clients[1].get_json("/metrics")
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
    want = _with_attn({**_NO_LAUNCHES, "fused_residual_unit_dense":
                       len(_residual_units(dac.decoder)) * vocodes.calls["from_codes"]}, counts)
    (args, kw, _), (inter_args, inter_gen_kw, _) = gen_calls.records["generate"]
    stacked = list(args[0])
    direct = dict(zip(stacked, dia.generate(stacked, **kw)))
    equal = sum(s == 200 and wav == _array_to_wav(direct[t], sr)
                for t, (s, wav) in zip(DIA_TEXTS, replies))

    def solo_pcm(text, skw):
        chunks = [c for _, c in dia.generate_stream(text, seed=0, pad_tokens_to=DIA_HTTP_BUCKET,
                                                    **skw)]
        return b"".join((np.clip(c, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                        for c in chunks)

    def stream_ok(status, blob, pcm):
        return (status == 200 and blob[:44] == _streaming_wav_header(sr) and blob[44:] == pcm
                and len(pcm) > 0)
    stream_equal = stream_ok(stream_status, stream_blob, solo_pcm(DIA_TEXTS[0], stream_kw))
    inter_solo = dia.generate(list(inter_args[0]), **inter_gen_kw)[0]
    inter_equal = {
        "stream": stream_ok(inter_stream[0], inter_stream[1], solo_pcm(DIA_TEXTS[2], inter_kw)),
        "tts": list(inter_args[0]) == [DIA_TEXTS[3]] and inter_tts[0] == 200
        and inter_tts[1] == _array_to_wav(inter_solo, sr)}
    interleaved = t_tts < inter_stream[2]
    sizes = list(srv.batcher.observed_batches)
    res = {"counts": counts, "warmup_s": warm_s, "latency": _latencies(lat, metrics),
           "batcher": metrics.get("batcher"), "batches": sizes, "stacked": stacked,
           "generate_kwargs": kw, "replies_equal": equal, "stream_equal": stream_equal,
           "stream_first_audio_s": first_audio_s, "stream_s": stream_s,
           "vocodes": vocodes.calls["from_codes"], "interleaved_equal": inter_equal,
           "tts_before_stream_end": interleaved, "pool": dia.graph_stats()}
    _print_serving("dia-1.6b http", res, card)
    print(f"    dia-1.6b http /tts/stream: first audio after {first_audio_s:.2f} s, whole "
          f"stream {stream_s:.2f} s ({DIA_HTTP_TOKENS} tokens in segments of 32) on {card}")
    print(f"    dia-1.6b http /tts/stream with a /tts sent during it: stream == its solo "
          f"generate_stream {inter_equal['stream']}, /tts == its solo generate "
          f"{inter_equal['tts']}, the /tts reply before the stream's end {interleaved}; "
          f"state pool {res['pool']}")
    phase("dia http", counts == want and sizes == [4, 1] and equal == 4 and stream_equal
          and all(inter_equal.values()),
          f"4 concurrent /tts (max_tokens {DIA_HTTP_TOKENS}, bucket {DIA_HTTP_BUCKET}) in "
          f"batches {sizes}, WAVs equal to a direct generate of {stacked}: {equal}/4; "
          f"/tts/stream == generate_stream: {stream_equal}, first audio {first_audio_s:.2f} s; "
          f"a /tts/stream and a /tts at once each equal to its solo run: {inter_equal}; "
          f"launches {counts} == {want}; warm-up {warm_s:.2f} s on {card}")
    return res


# ------------------------------------------------------- parallel phases


PARALLEL_PHASES = ("parallel_nccl1", "parallel_train", "parallel_encode", "parallel_dia",
                   "parallel_codebook")
PAR_RANKS = 2            # ranks of the spawn, both on the one card, over gloo
PAR_TRAIN_STEPS = 5      # compared GAN steps (SGD, TRAIN_SGD_LR), as phase_dac_train's
PAR_TRAIN_TIMED = 10
# dp=2 against one process: each GAN metric a step within PAR_TRAJ_BAR
# (relative). phase_dac_train's kernels-vs-plain SGD trajectories agree within
# 2.6e-6 (on an H100);
# dp=2 changes only the order of f32 sums (two local means, then one
# all-reduce of the gradients), a rounding of the same kind and size, so
# 40 x that is room for it and far below what a dropped or doubled shard
# gives (a gradient off by a factor of 2). The parameters' change (an SGD
# step is lr · g) of G and of D, each as one vector, within TRAIN_GRAD_BAR
# of the one-process change after the first and the last step
# (phase_dac_train's bar on gradients); each tensor's within PAR_TENSOR_BAR
# after the first: a Snake alpha's gradient sums B x T terms of both signs,
# and halving the batch moved one by 5.0e-2 (on an H100), while a
# tensor whose dp average is dropped or doubled moves by 50-100%. The
# compared steps, here and in the reference, run deterministic algorithms:
# across processes cuDNN's default ones may differ (a discriminator
# tensor's first-step gradient 1.8e-3 apart with every metric equal, on an
# H100).
PAR_TRAJ_BAR = 1e-4
PAR_TENSOR_BAR = 0.1
PAR_ENCODE_SECONDS = 60  # one long clip: what sp is for
# Dia's traffic: the 4 requests of DIA_SERVE_KW, greedy, cut from 512 to 32
# tokens for the phases' time budget
PAR_DIA_KW = dict(DIA_SERVE_KW, max_tokens=32, temperature=0.0)
PAR_KMEANS = dict(num_clusters=1024, num_iters=10)
PAR_EMA_STEPS = 5
# the dp EMA step against one process on the same codes: the dp sum of
# embed_sum in another f32 order (1500 rows a rank, then one all-reduce)
PAR_EMA_TOL = dict(rtol=1e-5, atol=1e-6)


def _stable_dac(cfg, audio: torch.Tensor):
    """(model, seed, sensitivities): the DAC of the first TRAIN_SEEDS seed
    whose mel gradient is stable on ``audio`` (see _mel_sensitivity)."""
    from neuralcodecs_tpu_torch.models.dac import DAC

    tried = {}
    for seed in TRAIN_SEEDS:
        model = DAC(cfg, device=DEVICE, seed=seed)
        tried[seed] = _mel_sensitivity(model, audio)
        if tried[seed] < MEL_STABLE:
            return model, seed, tried
    raise PhaseError(f"no candidate seed with a stable mel gradient: {tried}")


@contextlib.contextmanager
def _timed_collectives():
    """Host time of every all-reduce of the parallel layer, synchronised on
    both sides (for the collectives' share; it slows what it measures, so
    the step time comes from an untimed run)."""
    from neuralcodecs_tpu_torch.parallel import collectives

    inner = collectives.all_reduce_sum
    spent = {"ms": 0.0, "calls": 0, "bytes": 0}

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(t, group)
        torch.cuda.synchronize()
        spent["ms"] += (time.perf_counter() - t0) * 1e3
        spent["calls"] += 1
        spent["bytes"] += t.numel() * t.element_size()
        return out

    collectives.all_reduce_sum = timed
    try:
        yield spent
    finally:
        collectives.all_reduce_sum = inner


@contextlib.contextmanager
def _deterministic():
    """Deterministic CUDA algorithms (index_put's accumulate, cuDNN's
    backward), so that two runs of one step can be compared bit for bit."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def phase_parallel_nccl1(tmp: Path, card: str) -> dict:
    """A world-1 NCCL group (make_mesh(dp=1) starts it), and 2 steps of the
    full-width DAC-44k generator step through the mesh path (placements,
    the dp mean as an NCCL all-reduce, the mesh's batch slice), against the
    mesh=None step twice: all three must give the same parameters bit for
    bit."""
    import torch.distributed as dist

    from neuralcodecs_tpu_torch.models.dac import DACConfig
    from neuralcodecs_tpu_torch.parallel import make_mesh, make_train_step

    t0 = time.time()
    cfg = DACConfig()
    audio, _ = _train_batch(tmp, cfg.sample_rate, cfg.hop_length)
    model, seed, _ = _stable_dac(cfg, audio)
    start = _snapshot(model)
    sgd = functools.partial(torch.optim.SGD, lr=TRAIN_SGD_LR)

    def run(mesh) -> tuple[dict, list]:
        model.load_state_dict(start)
        init_fn, step_fn = make_train_step(model, mesh, sgd)
        state, losses = init_fn(), []
        for _ in range(2):
            state, loss = step_fn(state, audio)
            losses.append(float(loss))
        return _snapshot(model), losses

    with _deterministic(), torch.enable_grad():
        one, one_losses = run(None)
        again, _ = run(None)
        mesh = make_mesh(dp=1)
        backend = dist.get_backend()
        try:
            on_mesh, mesh_losses = run(mesh)
        finally:
            dist.destroy_process_group()
    reproducible = all(torch.equal(one[k], again[k]) for k in one)
    equal = all(torch.equal(one[k], on_mesh[k]) for k in one)
    res = {"backend": backend, "seed": seed, "reproducible": reproducible, "equal": equal,
           "losses": one_losses, "mesh_losses": mesh_losses, "seconds": time.time() - t0}
    phase("parallel nccl world-1 train step", backend == "nccl" and reproducible and equal,
          f"make_mesh(dp=1) on a world-1 {backend} group; 2 SGD generator steps of full-width "
          f"DAC-44k at 8 x 0.5 s: the mesh path's {len(one)} tensors equal the mesh=None "
          f"step's bit for bit: {equal} (mesh=None against itself: {reproducible}); losses "
          f"{mesh_losses}; {res['seconds']:.1f} s on {card}")
    del model
    torch.cuda.empty_cache()
    return res


def _par_train_ref(tmp: Path, card: str) -> dict:
    """The one-process reference of phase_parallel_train: PAR_TRAIN_STEPS
    SGD GAN steps of full-width DAC-44k and DACDiscriminator() on the
    training batch; metrics of each step, parameters after steps 1, 2 and
    PAR_TRAIN_STEPS, saved for the ranks."""
    from neuralcodecs_tpu_torch.models.dac import DACConfig
    from neuralcodecs_tpu_torch.models.dac.discriminator import DACDiscriminator
    from neuralcodecs_tpu_torch.parallel import make_gan_train_step

    cfg = DACConfig()
    audio, seconds = _train_batch(tmp, cfg.sample_rate, cfg.hop_length)
    model, seed, _ = _stable_dac(cfg, audio)
    disc = DACDiscriminator(device=DEVICE, seed=SEED + 24)
    sgd = functools.partial(torch.optim.SGD, lr=TRAIN_SGD_LR)
    init_fn, step_fn = make_gan_train_step(model, disc, None, sgd, sgd)
    states, metrics, params = init_fn(), [], {}
    t0 = time.perf_counter()
    with torch.enable_grad(), _deterministic():
        for i in range(1, PAR_TRAIN_STEPS + 1):
            states, m = step_fn(states, audio)
            metrics.append({k: float(v) for k, v in m.items()})
            if i in (1, 2, PAR_TRAIN_STEPS):
                params[i] = {**{f"g.{k}": v.cpu() for k, v in _snapshot(model).items()},
                             **{f"d.{k}": v.cpu() for k, v in _snapshot(disc).items()}}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / PAR_TRAIN_STEPS
    path = tmp / "parallel_train_ref.pt"
    torch.save({"metrics": metrics, "params": params}, path)
    del model, disc, states
    torch.cuda.empty_cache()
    return {"seed": seed, "audio": audio.cpu().numpy(), "audio_s": seconds, "ref": str(path),
            "one_process_ms": ms}


def _par_dia_run(dia, kw: dict) -> dict:
    """Greedy codes of DIA_TEXTS with the sampler's logits of every step,
    from the eager steps."""
    from neuralcodecs_tpu_torch.models.dia import model as dia_model
    from neuralcodecs_tpu_torch.ops.graphs import graphs_disabled

    sampler, logits = dia_model._sample_next_token, []

    def recorded(lg, *args, **kwargs):
        logits.append(lg.detach().float().cpu())
        return sampler(lg, *args, **kwargs)

    dia_model._sample_next_token = recorded
    try:
        with graphs_disabled():   # a replay runs no Python sampler to record
            codes, lengths = dia.generate_codes(DIA_TEXTS, **kw)
    finally:
        dia_model._sample_next_token = sampler
    return {"codes": np.asarray(codes), "lengths": np.asarray(lengths), "logits": logits}


@torch.no_grad()
def _q_scaled(dia):
    """Each q projection scaled by 1/sqrt(head_dim), as a trained Dia folds
    it (every DiaConfig() attention has 128-wide heads): with unit-scale q
    and k the scores spread by sqrt(128) ~ 11, near one-hot, and at 12 + 18
    random-weight layers the f32 run lies 3.0 from the f64 one at logits of
    4.7 (on an H100): no gate could see a fault through that."""
    for name, p in dia.named_parameters():
        if name.endswith("q_proj.weight"):
            p.mul_(dia.config.decoder.gqa_head_dim ** -0.5)
    return dia


def _par_dia_ref(tmp: Path, card: str) -> dict:
    """The one-process references of phase_parallel_dia: Dia 1.6B from its
    export with its q projections scaled (_q_scaled), f32 then int4, each
    its greedy codes and sampler logits and the teacher-forced logits of
    _dia_forced_run; the same teacher-forced run of the model loaded in the
    f64 reference mode (int4: the same int4 weights, f64 arithmetic)."""
    from neuralcodecs_tpu_torch import load_dia

    dia = _q_scaled(load_dia(str(tmp / "dia"), device=DEVICE).eval())
    f64 = _q_scaled(load_dia(str(tmp / "dia"), device=DEVICE,
                             compute_dtype=torch.float64).eval())
    ref = {}
    for mode in ("f32", "int4"):
        if mode == "int4":
            dia.quantize_int4()
            f64.quantize_int4()
        ref[mode] = _par_dia_run(dia, PAR_DIA_KW)
        ref[mode]["forced"] = _dia_forced_run(dia)[1]
        ref[mode]["forced_f64"] = _dia_forced_run(f64)[1]
    del dia, f64
    torch.cuda.empty_cache()
    path = tmp / "parallel_dia_ref.pt"
    torch.save(ref, path)
    return {"dir": str(tmp / "dia"), "ref": str(path)}


def _dia_logits_agree(ref: dict, got: dict, tol: float, label: str) -> dict:
    """Greedy runs step by step: the sampler's logits within ``tol`` of the
    reference's, and the same token wherever the reference's two best
    logits lie more than 2 x ``tol`` apart (no move of ``tol`` per logit can
    flip those). At the first step with another token (a near-tie) the two
    runs' inputs part, so the comparison stops there; otherwise the codes
    must be equal."""
    worst, near, parted = 0.0, 0, None
    for i, (r, g) in enumerate(zip(ref["logits"], got["logits"])):
        finite = torch.isfinite(r)
        if not torch.equal(finite, torch.isfinite(g)):
            raise PhaseError(f"{label}: step {i}: the masks of the two runs differ")
        pr, pg = r.argmax(-1), g.argmax(-1)
        if not torch.equal(pr, pg):
            top2 = torch.topk(torch.where(finite, r, -math.inf), 2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1])[pr != pg]
            if bool((margin > 2 * tol).any()):
                raise PhaseError(f"{label}: step {i}: tokens differ at top-2 margins "
                                 f"{margin.tolist()} > 2 x {tol:.3e}")
            near, parted = int((pr != pg).sum()), i
            break
        worst = max(worst, float((r - g)[finite].abs().max()))
    if parted is None:
        if len(ref["logits"]) != len(got["logits"]):
            raise PhaseError(f"{label}: {len(got['logits'])} steps, the reference "
                             f"{len(ref['logits'])}")
        if not (np.array_equal(ref["codes"], got["codes"])
                and np.array_equal(ref["lengths"], got["lengths"])):
            raise PhaseError(f"{label}: codes differ with every step's tokens equal")
    if worst > tol:
        raise PhaseError(f"{label}: logits {worst:.3e} from the one-process run (> {tol:.3e})")
    return {"max_logit_diff": worst, "near_tie_tokens": near, "parted_at_step": parted,
            "steps": len(got["logits"])}


def _par_codebook_latents(enc_dir: str) -> torch.Tensor:
    """Encodec-24k's encoder latents of the served 4 x 10 s batch (the
    seeded requests of phase_encodec_serve): [3000, 128]."""
    from neuralcodecs_tpu_torch import load_encodec

    enc = load_encodec(enc_dir, device=DEVICE).eval()
    sr = enc.config.sample_rate
    rng = np.random.default_rng(SEED + 3)
    batch = np.stack([(0.3 * rng.standard_normal(10 * sr)).astype(np.float32)
                      for _ in range(4)])
    x = torch.from_numpy(batch)[:, None, :].to(DEVICE)
    latents = enc.encoder(x)                                        # [4, 128, 750]
    return latents.transpose(1, 2).reshape(-1, latents.shape[1]).contiguous()


# --------------------------------------------------- the ranks' side


def _rank_gloo_check(rank: int) -> dict:
    """all_reduce and broadcast of cuda:0 tensors under gloo."""
    import torch.distributed as dist

    t = torch.full((4,), float(rank + 1), device=DEVICE)
    dist.all_reduce(t)
    b = torch.full((3,), float(rank), device=DEVICE)
    dist.broadcast(b, src=1)
    ok = bool((t == 3.0).all()) and bool((b == 1.0).all())
    if not ok:
        raise PhaseError(f"gloo on {t.device}: all_reduce {t.tolist()}, broadcast {b.tolist()}")
    return {"backend": dist.get_backend(), "device": str(t.device), "torch": torch.__version__}


def _rank_train(rank: int, job: dict) -> dict:
    """dp=2 GAN steps of full-width DAC-44k against the one-process steps,
    their time; then dp=1 x tp=2 steps on storage-sharded weights, a save
    and restore of that state and one more step."""
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
    from neuralcodecs_tpu_torch.models.dac.discriminator import DACDiscriminator
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.parallel import (
        make_gan_train_step,
        make_mesh,
        restore_train_state,
        save_train_state,
    )
    from neuralcodecs_tpu_torch.parallel import collectives
    from neuralcodecs_tpu_torch.parallel.sharding import sharded_dim

    tr = job["train"]
    ref = torch.load(tr["ref"], weights_only=False) if rank == 0 else None
    audio = torch.from_numpy(tr["audio"]).to(DEVICE)
    model = DAC(DACConfig(), device=DEVICE, seed=tr["seed"])
    disc = DACDiscriminator(device=DEVICE, seed=SEED + 24)
    start = (_snapshot(model), _snapshot(disc))
    sgd = functools.partial(torch.optim.SGD, lr=TRAIN_SGD_LR)
    out = {}

    def whole(state, prefix: str) -> dict:
        group = state.mesh.get_group("tp")
        got = {}
        for k, p in state.params.items():
            dim = sharded_dim(state.placements[k])
            p = p.detach()
            got[f"{prefix}.{k}"] = (p.clone() if dim is None
                                    else collectives.gather_cat(p, dim, group))
        return got

    def param_err(got: dict, want: dict) -> tuple[float, str, float, int]:
        """(the worst tensor's ‖Δ_got − Δ_ref‖ / ‖Δ_ref‖, its name, the
        larger of G's and D's as one vector each, the tensors above
        TRAIN_GRAD_BAR)."""
        errs, diff2, ref2 = {}, {"g": 0.0, "d": 0.0}, {"g": 0.0, "d": 0.0}
        for k, w in want.items():
            if k not in got:   # a buffer
                continue
            w0 = start[0 if k[0] == "g" else 1][k[2:]]
            d_ref = w.to(DEVICE).double() - w0.double()
            d_got = got[k].double() - w0.double()
            norm, dist = float(d_ref.norm()), float((d_got - d_ref).norm())
            errs[k] = dist / norm if norm else float(d_got.abs().max())
            diff2[k[0]] += dist ** 2
            ref2[k[0]] += norm ** 2
        worst = max(errs, key=errs.get)
        whole_err = max(math.sqrt(diff2[m] / ref2[m]) for m in diff2)
        return (errs[worst], worst, whole_err,
                sum(e > TRAIN_GRAD_BAR for e in errs.values()))

    def traj_err(metrics: list, want: list) -> float:
        return max(abs(m[k] - w[k]) / abs(w[k]) for m, w in zip(metrics, want) for k in w)

    with torch.enable_grad():
        # dp = 2: 4 of the 8 crops a rank
        mesh = make_mesh(dp=2)
        init_fn, step_fn = make_gan_train_step(model, disc, mesh, sgd, sgd)
        states, metrics = init_fn(), []
        kernels.reset_launch_counts()
        with _deterministic():
            for i in range(1, PAR_TRAIN_STEPS + 1):
                states, m = step_fn(states, audio)
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 1:
                    first = {**whole(states[0], "g"), **whole(states[1], "d")}
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        got = {**whole(states[0], "g"), **whole(states[1], "d")}   # every rank gathers
        if rank == 0:
            t_err = traj_err(metrics, ref["metrics"])
            p1_err, p1_worst, p1_all, p1_above = param_err(first, ref["params"][1])
            p_err, p_worst, p_all, _ = param_err(got, ref["params"][PAR_TRAIN_STEPS])
            phase("parallel dp=2 GAN steps vs one process",
                  t_err <= PAR_TRAJ_BAR and p1_all <= TRAIN_GRAD_BAR and p_all <= TRAIN_GRAD_BAR
                  and p1_err <= PAR_TENSOR_BAR,
                  f"{PAR_TRAIN_STEPS} SGD steps of full-width DAC-44k + DACDiscriminator() at "
                  f"8 x 0.5 s, 4 crops a rank: metrics within {t_err:.2e} (<= {PAR_TRAJ_BAR}); "
                  f"G's and D's change within {p1_all:.2e} after step 1 and {p_all:.2e} after "
                  f"step {PAR_TRAIN_STEPS} (<= {TRAIN_GRAD_BAR}); step 1's worst tensor "
                  f"{p1_err:.2e} (<= {PAR_TENSOR_BAR}; {p1_worst}; {p1_above} of {len(first)} "
                  f"above {TRAIN_GRAD_BAR}); rank 0's launches {counts}")
            out.update({"dp_traj_rel_err": t_err, "dp_step1_rel_err": p1_all,
                        "dp_step1_worst_tensor": [p1_worst, p1_err],
                        "dp_step1_tensors_above_1e-3": p1_above, "dp_param_rel_err": p_all,
                        "dp_step5_worst_tensor": [p_worst, p_err]})
        del first, got
        out["dp_metrics"] = metrics
        out["dp_counts"] = counts

        def step():
            states_box[0], _ = step_fn(states_box[0], audio)

        states_box = [states]
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(PAR_TRAIN_TIMED):
            step()
        torch.cuda.synchronize()
        out["dp_step_ms"] = (time.perf_counter() - t0) * 1e3 / PAR_TRAIN_TIMED
        out["dp_launches_per_step"] = {k: v / PAR_TRAIN_TIMED
                                       for k, v in kernels.launch_counts().items() if v}
        out["dp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with _timed_collectives() as spent:
            t0 = time.perf_counter()
            for _ in range(2):
                step()
            torch.cuda.synchronize()
        out["dp_instrumented_step_ms"] = (time.perf_counter() - t0) * 1e3 / 2
        out["dp_collective_ms"] = spent["ms"] / 2
        out["dp_collective_mb"] = spent["bytes"] / 2 / 1e6
        del states_box, states, step_fn, init_fn
        torch.cuda.empty_cache()

        # dp = 1 x tp = 2: the weights of >= 256 output channels stored as
        # halves, gathered whole at each use
        model.load_state_dict(start[0])
        disc.load_state_dict(start[1])
        mesh = make_mesh(dp=1, tp=2)
        init_fn, step_fn = make_gan_train_step(model, disc, mesh, sgd, sgd)
        states, metrics = init_fn(), []
        sharded = sum(sharded_dim(p) is not None for p in states[0].placements.values())
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        step_ms = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _deterministic():
                states, m = step_fn(states, audio)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                kernels_first = kernels.launch_counts()
                first = {**whole(states[0], "g"), **whole(states[1], "d")}
        out["tp_step_ms"] = step_ms[1]
        out["tp_counts"] = kernels.launch_counts()
        out["tp_counts_step1"] = kernels_first
        out["tp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["tp_sharded_tensors"] = sharded
        saved = {**whole(states[0], "g"), **whole(states[1], "d")}
        if rank == 0:
            t_err = traj_err(metrics, ref["metrics"][:2])
            p1_err, p1_worst, p1_all, p1_above = param_err(first, ref["params"][1])
            _, _, p_all, _ = param_err(saved, ref["params"][2])
            phase("parallel tp=2 GAN steps vs one process",
                  t_err <= PAR_TRAJ_BAR and p1_all <= TRAIN_GRAD_BAR
                  and p_all <= TRAIN_GRAD_BAR and p1_err <= PAR_TENSOR_BAR and sharded > 0,
                  f"2 SGD steps, G's {sharded} tp-sharded tensors stored as halves and "
                  f"gathered at use (kernel 2b's training form on the whole weight): metrics "
                  f"within {t_err:.2e} (<= {PAR_TRAJ_BAR}); G's and D's change within "
                  f"{p1_all:.2e} / {p_all:.2e} after steps 1 / 2 (<= {TRAIN_GRAD_BAR}); step "
                  f"1's worst tensor {p1_err:.2e} ({p1_worst}; {p1_above} above "
                  f"{TRAIN_GRAD_BAR}); rank 0's launches {out['tp_counts']}")
            out.update({"tp_traj_rel_err": t_err, "tp_step1_rel_err": p1_all,
                        "tp_step1_worst_tensor": [p1_worst, p1_err],
                        "tp_param_rel_err": p_all})
        del first
        ckpt = Path(job["tmp"]) / "parallel_tp_ckpt"
        save_train_state(states[0], ckpt / "g")
        save_train_state(states[1], ckpt / "d")
        states = (restore_train_state(ckpt / "g", template=states[0]),
                  restore_train_state(ckpt / "d", template=states[1]))
        back = {**whole(states[0], "g"), **whole(states[1], "d")}
        bit_equal = all(torch.equal(back[k], v) for k, v in saved.items())
        with _deterministic():
            states, m = step_fn(states, audio)
        third = {k: float(v) for k, v in m.items()}
        if rank == 0:
            t_err = traj_err([third], ref["metrics"][2:3])
            phase("parallel tp=2 checkpoint", bit_equal and states[0].step == 3
                  and t_err <= PAR_TRAJ_BAR,
                  f"saved whole from the halves, restored onto the tp mesh: {len(saved)} "
                  f"tensors bit for bit: {bit_equal}; a 3rd step from it at step "
                  f"{states[0].step}, metrics within {t_err:.2e} of the one-process 3rd step")
        out["tp_restored_bit_equal"] = bit_equal
    del model, disc, states, ref
    torch.cuda.empty_cache()
    return out


def _rank_encode(rank: int, job: dict) -> dict:
    """SNAC-24k's encode of one PAR_ENCODE_SECONDS clip, time-sharded over
    sp=2, against the one-process encode (rank 0)."""
    from neuralcodecs_tpu_torch import load_snac
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.parallel import make_mesh, sharded_encode

    snac = load_snac(job["encode"]["dir"], device=DEVICE).eval()
    mesh = make_mesh(dp=1, tp=1, sp=2)
    rng = np.random.default_rng(SEED + 40)
    audio = (0.3 * rng.standard_normal((1, PAR_ENCODE_SECONDS * snac.config.sample_rate))
             ).astype(np.float32)
    kernels.reset_launch_counts()
    codes = sharded_encode(snac, mesh, audio)
    torch.cuda.synchronize()
    out = {"counts": kernels.launch_counts()}
    t0 = time.perf_counter()
    sharded_encode(snac, mesh, audio)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    with _timed_collectives() as spent:
        sharded_encode(snac, mesh, audio)
    out["collective_ms"] = spent["ms"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rank == 0:
        want = snac.encode(audio)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snac.encode(audio)
        torch.cuda.synchronize()
        out["one_process_ms"] = (time.perf_counter() - t0) * 1e3
        match = [float((a == b).float().mean()) for a, b in zip(codes, want)]
        shapes_ok = all(a.shape == b.shape for a, b in zip(codes, want))
        out["match"] = match
        phase("parallel sp=2 encode vs one process", shapes_ok and min(match) >= 0.99,
              f"full-width SNAC-24k, one {PAR_ENCODE_SECONDS} s clip over sp=2: codes "
              f"{[tuple(c.shape) for c in codes]} equal the one-process encode's at "
              f"{[f'{m:.4%}' for m in match]} (>= 99% a stage); rank 0: {out['ms']:.1f} ms "
              f"(one process {out['one_process_ms']:.1f} ms), launches {out['counts']}")
    del snac
    torch.cuda.empty_cache()
    return out


def _rank_dia(rank: int, job: dict) -> dict:
    """Dia 1.6B from its export, tp=2, f32 then int4. Gate: the teacher-
    forced logits within DIA_F64_FACTOR x the one-process run's error of
    the f64 mode's (row-parallel sums reorder f32 additions, as another
    card's kernels would; at 12 + 18 random-weight layers that error is
    measured, not assumed); the greedy runs' sampler logits within that
    limit plus the one-process error of each other, and their codes equal
    up to a near-tie under it."""
    from neuralcodecs_tpu_torch import load_dia
    from neuralcodecs_tpu_torch.parallel import collectives, make_mesh, shard_params

    mesh = make_mesh(dp=1, tp=2)
    ref = torch.load(job["dia"]["ref"], weights_only=False) if rank == 0 else None
    out = {}
    for mode in ("f32", "int4"):
        dia = _q_scaled(load_dia(job["dia"]["dir"], device=DEVICE).eval())
        if mode == "int4":
            dia.quantize_int4()
        shard_params(mesh, dia)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        forced = _dia_forced_run(dia)[1]
        # the control: each rank's row-parallel partial doubled in place of
        # the sum (a dropped shard at the right scale) must fail the gate
        inner, collectives.row_parallel_sum = collectives.row_parallel_sum, (
            lambda partial, group: 2.0 * partial)
        try:
            control = _dia_forced_run(dia)[1]
        finally:
            collectives.row_parallel_sum = inner
        got = _par_dia_run(dia, PAR_DIA_KW)
        steps = len(got["logits"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dia.generate_codes(DIA_TEXTS, **PAR_DIA_KW)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        with _timed_collectives() as spent:
            dia.generate_codes(DIA_TEXTS, **PAR_DIA_KW)
        res = {"step_ms": ms, "collective_ms_per_step": spent["ms"] / steps,
               "collectives_per_step": spent["calls"] / steps,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "kv_heads_per_rank": dia.decoder.layers[0].self_attention.n_kv}
        if rank == 0:
            r = ref[mode]
            err_one = float((r["forced"] - r["forced_f64"]).abs().max())
            err_tp = float((forced - r["forced_f64"]).abs().max())
            err_control = float((control - r["forced_f64"]).abs().max())
            tp_vs_one = float((forced - r["forced"]).abs().max())
            limit = DIA_F64_FACTOR * err_one
            res.update({"forced_err_vs_f64": {"one_process": err_one, "tp": err_tp,
                                              "control": err_control},
                        "forced_tp_vs_one": tp_vs_one, "limit": limit,
                        "logit_scale": float(r["forced_f64"].abs().max())})
            # two runs each within their error of f64 lie within the sum:
            # the greedy runs are held to the limit plus the one-process error
            tol = limit + err_one
            res.update(_dia_logits_agree(r, got, tol, f"dia tp=2 {mode}"))
            phase(f"parallel tp=2 dia {mode} vs one process",
                  err_tp <= limit < err_control,
                  f"Dia 1.6B from its export, q scaled, {res['kv_heads_per_rank']} K/V heads "
                  f"a rank: 16 teacher-forced steps' logits (max |logit| "
                  f"{res['logit_scale']:.2f}) {err_tp:.3e} from the f64 mode, the one-process "
                  f"run {err_one:.3e} (<= {DIA_F64_FACTOR:g} x: {limit:.3e}), the control "
                  f"(partials doubled, no sum) {err_control:.3e} (must exceed it), tp vs one "
                  f"process {tp_vs_one:.3e}; "
                  f"{len(DIA_TEXTS)} requests greedy to {PAR_DIA_KW['max_tokens']} tokens: "
                  f"sampler logits within {res['max_logit_diff']:.2e} until the runs part at "
                  f"step {res['parted_at_step']} on {res['near_tie_tokens']} near-tie tokens "
                  f"(top-2 margin <= 2 x {tol:.2e}) of {res['steps']} steps; "
                  f"{ms:.1f} ms a step, collectives {res['collective_ms_per_step']:.1f} ms a "
                  f"step ({res['collectives_per_step']:.0f} all-reduces), peak "
                  f"{res['peak_gb']:.2f} GB on rank 0")
        out[mode] = res
        del dia
        torch.cuda.empty_cache()
    return out


def _rank_codebook(rank: int, job: dict) -> dict:
    """kmeans to 1024 entries on Encodec-24k's latents (kernel 1), then
    PAR_EMA_STEPS EMA steps over dp=2 with expire_codes; rank 0 holds each
    search to the plain version on the same inputs and the dp state to the
    one-process update with the plain search."""
    from neuralcodecs_tpu_torch.models.encodec import quantize as q
    from neuralcodecs_tpu_torch.ops import kernels
    from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin_plain
    from neuralcodecs_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=2)
    kernels.reset_launch_counts()
    flat = _par_codebook_latents(job["codebook"]["dir"])
    searched = {"rows": 0, "flips": 0, "gap": 0.0}
    inner = q.l2_argmin_codes

    def checked(x, cb):
        got = inner(x, cb)
        n, gap = _compare_codes(x, cb, got, codebook_argmin_plain(x, cb))
        searched["rows"] += x.shape[0]
        searched["flips"] += n
        searched["gap"] = max(searched["gap"], gap)
        return got

    q.l2_argmin_codes = checked
    try:
        t0 = time.perf_counter()
        means, bins = q.kmeans(torch.Generator(device=DEVICE).manual_seed(SEED + 50), flat,
                               **PAR_KMEANS)
        torch.cuda.synchronize()
        kmeans_ms = (time.perf_counter() - t0) * 1e3
        cb = q.EuclideanCodebook(flat.shape[1], PAR_KMEANS["num_clusters"]).to(DEVICE)
        start = q.CodebookState(means, means.clone(), bins.clone(), torch.ones(1, device=DEVICE))
        n = flat.shape[0] // 2
        mine = flat[rank * n:(rank + 1) * n]
        state, states = start, []
        t0 = time.perf_counter()
        for step in range(PAR_EMA_STEPS):
            codes = q.l2_argmin_codes(mine, state.embed)
            state = cb.ema_update(state, mine, codes, dp_group=mesh.get_group("dp"))
            state = cb.expire_codes(torch.Generator(device=DEVICE).manual_seed(SEED + 60 + step),
                                    state, flat)
            states.append(state)
        torch.cuda.synchronize()
        ema_ms = (time.perf_counter() - t0) * 1e3 / PAR_EMA_STEPS
    finally:
        q.l2_argmin_codes = inner
    counts = kernels.launch_counts()
    out = {"counts": counts, "kmeans_ms": kmeans_ms, "ema_step_ms": ema_ms, **searched}
    if rank == 0:
        worst = dict.fromkeys(q.CodebookState._fields[:3], 0.0)
        flips, moved, prev = 0, 0.0, start
        for step, got in enumerate(states):
            k_codes, p_codes = inner(flat, prev.embed), codebook_argmin_plain(flat, prev.embed)
            n, _ = _compare_codes(flat, prev.embed, k_codes, p_codes)
            ref = cb.ema_update(prev, flat, p_codes)
            ref = cb.expire_codes(torch.Generator(device=DEVICE).manual_seed(SEED + 60 + step),
                                  ref, flat)
            # a near-tie flip moves its row between two codes: those codes'
            # statistics differ by the row; every other code must agree to
            # the f32 order of the dp sum
            flipped = k_codes != p_codes
            touched = torch.zeros(cb.codebook_size, dtype=torch.bool, device=DEVICE)
            touched[k_codes[flipped].long()] = True
            touched[p_codes[flipped].long()] = True
            for name in worst:
                a, b = getattr(got, name)[~touched], getattr(ref, name)[~touched]
                excess = ((a - b).abs() - PAR_EMA_TOL["atol"]).div(b.abs().clamp_min(1e-30))
                worst[name] = max(worst[name], float(excess.max()))
            if n:
                moved = max(moved, float((got.cluster_size - ref.cluster_size)[touched]
                                         .abs().max()))
            flips, prev = flips + n, got
        out.update({"state_rel_err": worst, "ref_flips": flips, "flip_cluster_moved": moved})
        flip_limit = (1 - cb.decay) * flips + PAR_EMA_TOL["atol"]
        phase("parallel dp=2 codebook vs one process",
              all(v <= PAR_EMA_TOL["rtol"] for v in worst.values()) and moved <= flip_limit
              and counts["codebook_argmin"] > 0 and counts["lstm_scan"] > 0,
              f"Encodec-24k latents {tuple(flat.shape)} (kernel 3), kmeans to "
              f"{PAR_KMEANS['num_clusters']} over {PAR_KMEANS['num_iters']} iterations in "
              f"{kmeans_ms:.1f} ms, then {PAR_EMA_STEPS} EMA steps over dp=2 with "
              f"expire_codes, {ema_ms:.2f} ms a step; kernel 1 against plain over "
              f"{searched['rows']} searched rows: {searched['flips']} near-tie flips (max gap "
              f"{searched['gap']:.2e}); each dp step against the one-process update of the "
              f"same state with the plain search: {flips} near-tie flips, the codes they "
              f"touch moved by {moved:.3e} in cluster_size (<= {flip_limit:.3e}), every other "
              f"code within rtol {PAR_EMA_TOL['rtol']} / atol {PAR_EMA_TOL['atol']} "
              f"(excess {worst}); launches {counts}")
    return out


_RANK_PARTS = {"parallel_train": _rank_train, "parallel_encode": _rank_encode,
               "parallel_dia": _rank_dia, "parallel_codebook": _rank_codebook}


def _parallel_rank(rank: int, job: dict) -> dict:
    """What each rank of the parallel phases' spawn runs: the gloo check,
    then each selected phase in order."""
    torch.set_grad_enabled(False)
    torch.set_num_threads(max(1, torch.get_num_threads() // PAR_RANKS))  # the host's cores
    out = {"gloo": _rank_gloo_check(rank)}
    for name in job["phases"]:
        t0 = time.time()
        out[name] = _RANK_PARTS[name](rank, job)
        out[name]["seconds"] = time.time() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _parallel_phases(tmp: Path, card: str, selected=PARALLEL_PHASES) -> dict:
    """The parallel phases of ``selected``: the world-1 NCCL step in this
    process, then one spawn of PAR_RANKS ranks sharing the card over gloo
    for the others, after their one-process references. Every rank's
    failure fails the run with its traceback."""
    from neuralcodecs_tpu_torch.parallel.launch import run_local

    t0 = time.time()
    res = {}
    if "parallel_nccl1" in selected:
        res["parallel_nccl1"] = phase_parallel_nccl1(tmp, card)
    job = {"tmp": str(tmp), "phases": [p for p in _RANK_PARTS if p in selected]}
    if "parallel_train" in selected:
        job["train"] = _par_train_ref(tmp, card)
    if "parallel_encode" in selected:
        job["encode"] = {"dir": str(tmp / "snac_24khz")}
    if "parallel_dia" in selected:
        job["dia"] = _par_dia_ref(tmp, card)
    if "parallel_codebook" in selected:
        job["codebook"] = {"dir": str(tmp / "encodec_24khz")}
    if job["phases"]:
        torch.cuda.empty_cache()
        t_spawn = time.time()
        ranks = run_local(_parallel_rank, PAR_RANKS, (job,), timeout=900)
        spawn_s = time.time() - t_spawn
        gloo = ranks[0]["gloo"]
        print(f"    parallel ranks: {PAR_RANKS} on one card over {gloo['backend']} "
              f"({gloo['device']}, torch {gloo['torch']}), {spawn_s:.1f} s for the spawn; "
              f"peak GB by rank {[round(r['peak_gb'], 2) for r in ranks]}; on {card}")
        for name in job["phases"]:
            res[name] = {"ranks": [r[name] for r in ranks]}
        res["spawn_s"] = spawn_s
        res["gloo"] = gloo
        if "parallel_train" in res:
            r0 = res["parallel_train"]["ranks"][0]
            res["parallel_train"]["one_process_ms"] = job["train"]["one_process_ms"]
            print(f"    parallel train: dp=2 GAN step {r0['dp_step_ms']:.1f} ms a rank "
                  f"(one process, 8 crops: {job['train']['one_process_ms']:.1f} ms under SGD), "
                  f"collectives {r0['dp_collective_ms']:.1f} ms a step "
                  f"({r0['dp_collective_ms'] / r0['dp_instrumented_step_ms']:.1%} of the "
                  f"synchronised step, {r0['dp_collective_mb']:.0f} MB), peak by rank "
                  f"{[round(r['dp_peak_gb'], 2) for r in res['parallel_train']['ranks']]} GB, "
                  f"launches a step a rank {r0['dp_launches_per_step']}; tp=2 step "
                  f"{r0['tp_step_ms']:.1f} ms, peak {r0['tp_peak_gb']:.2f} GB, kernel 2b "
                  f"{r0['tp_counts']['fused_residual_unit_dense'] / 2:.0f} launches a step a "
                  f"rank; on {card}")
        if "parallel_encode" in res:
            rs = res["parallel_encode"]["ranks"]
            print(f"    parallel encode: ms by rank {[round(r['ms'], 1) for r in rs]}, "
                  f"collectives {rs[0]['collective_ms']:.1f} ms, peak "
                  f"{[round(r['peak_gb'], 2) for r in rs]} GB, launches by rank "
                  f"{[r['counts'] for r in rs]}; on {card}")
        if "parallel_dia" in res:
            for mode in ("f32", "int4"):
                rs = [r[mode] for r in res["parallel_dia"]["ranks"]]
                print(f"    parallel dia {mode}: step ms by rank "
                      f"{[round(r['step_ms'], 1) for r in rs]}, collectives "
                      f"{[round(r['collective_ms_per_step'], 1) for r in rs]} ms a step, peak "
                      f"{[round(r['peak_gb'], 2) for r in rs]} GB; on {card}")
        if "parallel_codebook" in res:
            rs = res["parallel_codebook"]["ranks"]
            print(f"    parallel codebook: launches by rank {[r['counts'] for r in rs]}; "
                  f"on {card}")
    res["seconds"] = time.time() - t0
    print(f"    parallel phases: {res['seconds']:.1f} s")
    return res


def _parallel_counts(res: dict) -> dict:
    """Rank 0's launches on the parallel phases' main paths (each rank's
    counts were set to 0 just before each path and read just after)."""
    counts = dict(_NO_LAUNCHES)
    for name, key in (("parallel_train", "dp_counts"), ("parallel_train", "tp_counts"),
                      ("parallel_encode", "counts"), ("parallel_codebook", "counts")):
        if name in res:
            for k, v in res[name]["ranks"][0][key].items():
                counts[k] += v
    return counts


# ------------------------------------------------------------------- main


def _entry(name: str, source: str, replaces: str, launches: dict, res: dict) -> dict:
    """One kernel's record in the kernels line."""
    return {"name": name, "route": "cuda",
            "source": f"neuralcodecs_tpu_torch/csrc/{source}",
            "replaces": f"neuralcodecs_tpu/ops/pallas/{replaces}",
            "launches": launches[name], "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"], "shapes": res["rows"],
            **{k: res[k] for k in ("bound_f32_ms", "floor_ms") if k in res}}


PRECISION_PHASES = ("dia_bf16", "codec_precision")
PHASES = ("decode_attn", "snac_http", "encodec_http", "dac_http", "chunked", "dia_http",
          "dac_train") \
    + PRECISION_PHASES \
    + PARALLEL_PHASES


def _precision_phases(tmp: Path, dac_dir: Path, card: str, selected=PRECISION_PHASES) -> dict:
    """The precision phases of ``selected``, after the setup that writes
    their exports."""
    t0 = time.time()
    res = {}
    if "dia_bf16" in selected:
        res["dia_bf16"] = phase_dia_bf16(tmp, dac_dir, card)
    if "codec_precision" in selected:
        res["codec_precision"] = phase_codec_precision(tmp, card)
    res["seconds"] = time.time() - t0
    print(f"    precision phases: {res['seconds']:.1f} s")
    return res


def _selected_phases(tmp: Path, card: str, selected: list[str]) -> dict:
    """The phases of ``selected`` alone, after the setup each needs: the
    codec exports (phase_loader) for all, the LM cache for encodec_http,
    the Dia export for dia_http, dia_bf16 and parallel_dia (chunked needs
    only the codec exports); dac_train runs
    kernel 2b's inference-form check first, as in the whole run."""
    res = {}
    if "decode_attn" in selected:
        res["decode_attn"] = phase_decode_attn(torch.Generator(device=DEVICE).manual_seed(SEED),
                                               card)
        if set(selected) == {"decode_attn"}:
            return res
    model, enc, dac, dac_dir, _ = phase_loader(tmp, card)
    if "snac_http" in selected:
        res["snac_http"] = phase_snac_http(model, card)
    if "encodec_http" in selected:
        phase_lm_cache(enc, tmp, card)
        res["encodec_http"] = phase_encodec_http(enc, card)
    if "dac_http" in selected:
        res["dac_http"] = phase_dac_http(dac, card)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    if "chunked" in selected:
        res["chunked"] = phase_chunked(model, dac, gen, card)
    if "dac_train" in selected:
        res["resunit_dense"] = phase_resunit_dense(dac, gen)
    del model, enc, dac
    torch.cuda.empty_cache()
    if "dac_train" in selected:
        res["dac_train"] = phase_dac_train(tmp, card, gen)
    if {"dia_http", "dia_bf16", "parallel_dia"} & set(selected):
        dia, _ = _dia_from_export(tmp, card)
        if "dia_http" in selected:
            dia.load_dac_model(str(dac_dir))
            res["dia_http"] = phase_dia_http(dia, card)
        del dia
        torch.cuda.empty_cache()
    if set(PRECISION_PHASES) & set(selected):
        res["precision"] = _precision_phases(tmp, dac_dir, card, selected)
    if set(PARALLEL_PHASES) & set(selected):
        res["parallel"] = _parallel_phases(tmp, card, selected)
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the per-shape details here (JSON)")
    parser.add_argument("--phases", help="comma-separated, of " + ", ".join(PHASES)
                        + ": run only these, after the device, build and export phases "
                        "they need; prints no kernels line")
    args = parser.parse_args()
    selected = args.phases.split(",") if args.phases else None
    if selected and not set(selected) <= set(PHASES):
        parser.error(f"--phases: {args.phases} is not a list of {', '.join(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    t_start = time.time()
    try:
        with tempfile.TemporaryDirectory() as tmp_dir:
            tmp = Path(tmp_dir)
            info = phase_device()
            built = phase_build()
            if selected:
                res = _selected_phases(tmp, info["smi"], selected)
                if args.out:
                    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                    Path(args.out).write_text(json.dumps(
                        {"device": info, "build": built, **res,
                         "seconds": time.time() - t_start}, indent=1, default=str))
                print(f"chip_smoke: {args.phases} passed, {time.time() - t_start:.1f} s on "
                      f"{info['smi']}")
                return 0
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            cb = phase_codebook(gen)
            # the served SNAC-24k, Encodec-24k and DAC-44k, loaded from exports
            model, enc, dac, dac_dir, loader = phase_loader(tmp, info["smi"])
            ru = phase_resunit(model, gen, model._pad_length(10 * model.config.sample_rate))
            phase_golden()
            phase_card_vs_cpu(model)
            serve = phase_serve(model, info["smi"])
            snac_http = phase_snac_http(model, info["smi"])
            lstm = phase_lstm(enc, gen)
            phase_ecdc_golden()
            phase_encodec_card_vs_cpu(enc)
            enc_serve = phase_encodec_serve(enc, info["smi"])
            enc48, model48 = phase_encodec_48k(info["smi"])
            stream = phase_encodec_stream(enc, gen, info["smi"])
            loader["lm_cache"] = phase_lm_cache(enc, tmp, info["smi"])
            lm_coding = phase_ecdc_lm(enc, model48, info["smi"])
            enc_http = phase_encodec_http(enc, info["smi"])
            env = phase_envelope(gen)
            bq = phase_biquad(gen)
            dsp, resampled = phase_dsp_pipeline(info["smi"])
            loud = phase_loudness(resampled, info["smi"])
            ru_dense = phase_resunit_dense(dac, gen)
            golden_dac, golden = phase_dac_golden()
            dac_cmp = phase_dac_card_vs_cpu(dac)
            dac_serve = phase_dac_serve(dac, info["smi"])
            dac_http = phase_dac_http(dac, info["smi"])
            phase_dac_file(golden_dac, golden, tmp)
            chunked = phase_chunked(model, dac, gen, info["smi"])
            del dac
            dac_train = phase_dac_train(tmp, info["smi"], gen)
            t_dia = time.time()
            attn = phase_decode_attn(gen, info["smi"])
            dia_golden = phase_dia_golden()
            dia_cmp = phase_dia_card_vs_cpu()
            dia_serve = phase_dia_serve(dac_dir, info["smi"], tmp)
            dia_serve["dia_phases_s"] = time.time() - t_dia
            print(f"    dia phases: {dia_serve['dia_phases_s']:.1f} s")
            loader["dia_1.6b"] = dia_serve["loaded"]
            precision = _precision_phases(tmp, dac_dir, info["smi"])
            dia_bf16, codec_precision = precision["dia_bf16"], precision["codec_precision"]
            dia_bf16["precision_phases_s"] = precision["seconds"]
            # the parallel phases: the parent's models freed first, the
            # ranks load their own
            del model, enc, model48, golden_dac, resampled
            torch.cuda.empty_cache()
            parallel = _parallel_phases(tmp, info["smi"])
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    paths = (serve, snac_http, enc_serve, enc48, stream, lm_coding, enc_http, dsp, loud,
             dac_serve, dac_http, chunked, dac_train, dia_serve, dia_serve["http"], dia_bf16,
             codec_precision)
    par_counts = _parallel_counts(parallel)
    launches = {name: sum(p["counts"][name] for p in paths) + par_counts[name]
                for name in KERNELS}
    lstm["rows"] += stream["lstm_rows"]
    cb["rows"] += stream["codebook_rows"]
    for res, units in ((ru, chunked["snac_units"]), (ru_dense, chunked["dac_units"])):
        res["rows"] += units["rows"]  # the chunked windows' shapes
        res["max_abs_err"] = max(res["max_abs_err"], units["max_abs_err"])
    kernels_line = {"kernels": [
        _entry("codebook_argmin", "codebook.cu", "codebook.py:46", launches, cb),
        _entry("fused_residual_unit", "resunit.cu", "resunit.py:154", launches, ru),
        _entry("fused_residual_unit_dense", "resunit.cu",
               "resunit.py:154 (depthwise=False)", launches, ru_dense),
        _entry("lstm_scan", "lstm.cu", "lstm.py:103", launches, lstm),
        _entry("envelope_follow", "envelope.cu", "envelope.py:75", launches, env),
        _entry("biquad_df2t", "biquad.cu", "biquad.py:69", launches, bq),
        {"name": "decode_self_attn / decode_cross_attn", "route": "cuda",
         "source": "neuralcodecs_tpu_torch/csrc/decode_attn.cu", "replaces": None,
         "launches": {k: launches[k] for k in ATTN_KERNELS}, "a_layer": attn["times"]},
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": info, "seconds": time.time() - t_start, "build": built, "codebook": cb,
             "resunit": ru, "serve": serve, "snac_http": snac_http, "encodec_http": enc_http,
             "dac_http": dac_http, "lstm": lstm, "encodec_serve": enc_serve,
             "encodec_48k": enc48, "encodec_stream": stream, "ecdc_lm": lm_coding, "envelope": env,
             "biquad": bq, "dsp_pipeline": dsp, "loudness": loud, "resunit_dense": ru_dense,
             "dac_card_vs_cpu": dac_cmp, "dac_serve": dac_serve, "chunked": chunked,
             "dac_train": dac_train,
             "loader": loader,
             "dia_golden": dia_golden, "decode_attn": attn,
             "dia_card_vs_cpu": dia_cmp, "dia_serve": dia_serve, "dia_bf16": dia_bf16,
             "codec_precision": codec_precision, "parallel": parallel}, indent=1,
            default=str))
    print(info["smi"])
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
