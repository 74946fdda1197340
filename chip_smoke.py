"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out details.json]

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
versions. Dia: greedy generations from the tiny goldens' weights against the
port on the CPU and against dia_ladder_golden's codes (the int8 KV cache,
blocked read and integer dots); DiaConfig() widths at 2 + 2 layers against
the CPU in f32 and f64; then the full 1.61 B model (seeded, f32) serving 4
requests of 512 tokens through the DAC-44k above, a voice-clone prompt,
generate_stream against its one-shot codes and the int8 serving ladder,
with the decode step's time, launches, bound, syncs and idle share. Each
served path runs with the launch counters set to 0 just
before it and read just after, and fails unless every kernel of the path
launched as often as the path calls it; the kernels line reports the sum
over those paths, each kernel's time against its plain version at every
shape checked, its bound on the card and, where one PyTorch call computes
the same function, that call's time. torch.profiler passes over the
Encodec-24k and DAC-44k round trips, the DSP chain and the loudness give
device time by kernel and idle share. Exits non-zero at the first failed
phase, and at once when no CUDA device is available. The last line is a
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import queue
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20260816
DEVICE = "cuda"


KERNELS = ("codebook_argmin", "fused_residual_unit", "fused_residual_unit_dense", "lstm_scan",
           "envelope_follow", "biquad_df2t")
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
    """The card, and the port's TF32 policy as its import left it: nothing
    here sets a flag."""
    from neuralcodecs_tpu_torch.ops.precision import tf32_disabled

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    print(card, flush=True)
    info = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    phase("device", bool(card) and tf32_disabled(),
          f"{info['name']} x{info['count']}, nvidia-smi '{card}', torch {info['torch']} "
          f"cuda {info['cuda']}, tf32 off after import={tf32_disabled()}")
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
    than plain). A unit does 2 T C 7 C/g flops in its dilated conv and
    2 T C^2 in its C x C pointwise product, and reads x and its weights once
    and writes out once. The kernels run on the tensor cores as three TF32
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
            conv, pointwise = 2.0 * t * c * KERNEL_TAPS * w_dil.shape[1], 2.0 * t * c * c
            flops += conv + pointwise
            # in TF32-peak operations: three passes of each product on the
            # tensor cores, the depthwise taps at the f32 rate
            dense = w_dil.shape[1] != 1
            tc_flops += 3 * pointwise + (3 * conv if dense else conv * TF32_FLOPS / F32_FLOPS)
            nbytes += 4.0 * (2 * c * t + w_dil.numel() + c * c + 4 * c)
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
    phase("lstm kernel vs plain", not bad and chunked and ragged,
          f"{len(cases)} shapes (ys, h_f, c_f) within rtol 1e-5/atol 1e-6 "
          f"(max|err| {err:.2e}); a case with B > BS: {chunked}, with a ragged last "
          f"block: {ragged}; torch.nn.LSTM (cuDNN, with its input projection) at "
          f"T={t} B={b} H={h}: {library_ms:.3f} ms; the kernel there {rows[0]['ms']:.3f} ms, "
          f"{rows[0]['step_us']:.2f} us a step, handoff floor {rows[0]['floor_ms']:.3f} ms"
          + (f"; mismatches {bad}" if bad else ""))
    return {"rows": rows, "max_abs_err": err, "ms": rows[0]["ms"],
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
    round trip."""
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
    kernels' launches are counted per run."""
    from neuralcodecs_tpu_torch.ops import kernels

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
    for name, (a, pushes, blocks) in runs.items():  # warm: cuDNN picks its algorithms
        _session_run(model, a, pushes[:3], n_q, blocks)
    counts, want, summary, failures = dict(_NO_LAUNCHES), dict(_NO_LAUNCHES), {}, []
    for name, (a, pushes, blocks) in runs.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = _session_run(model, a, pushes, n_q, blocks)
        torch.cuda.synchronize()
        run_counts = kernels.launch_counts()
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
               "frames_differing": frames, "max_rel_gap": gap, "audio_max_abs_err": err}
        summary[name] = row
        if gap > 1e-5 or not close or res["codes"].shape != (b, n_q, hops):
            failures.append((name, frames, gap, err))
        print(f"    stream {name}: {b} session(s), {res['pushes']} pushes; a push (enc + dec, "
              f"CUDA events) p50 {row['enc_ms_p50']:.2f} + {row['dec_ms_p50']:.2f} ms, p90 "
              f"{row['enc_ms_p90']:.2f} + {row['dec_ms_p90']:.2f} ms; wall p50 "
              f"{row['wall_ms_p50']:.2f} / p90 {row['wall_ms_p90']:.2f} ms against a "
              f"{chunk_ms:.1f} ms chunk; {row['launches_a_push']:.1f} kernel launches a push "
              f"({run_counts['codebook_argmin']} codebook + {run_counts['lstm_scan']} LSTM in "
              f"all); "
              f"frames whose codes differ from the full encode "
              f"{frames} of {b * hops} (largest first-stage gap {gap:.1e} rel.); audio vs "
              f"full decode max|err| {err:.2e}")
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
          f"rtol 1e-4/atol 1e-5 of the full decode{failed}; "
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
    range coder. A seeded LM is random: it compresses nothing."""
    from neuralcodecs_tpu_torch.models.encodec import ecdc
    from neuralcodecs_tpu_torch.native import build as native_build
    from neuralcodecs_tpu_torch.ops import kernels

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
    res = {"counts": counts, "step_ms": step_ms, "encode_s": enc_s, "decode_s": dec_s,
           "encode_1_s": enc1_s, "decode_1_s": dec1_s,
           "encode_xrt": 4 * seconds / enc_s, "decode_xrt": 4 * seconds / dec_s,
           "encode_1_xrt": seconds / enc1_s, "decode_1_xrt": seconds / dec1_s,
           "lm_bytes": payload, "raw_bytes": raw, "blob48_bytes": len(blob48),
           "cdf_rows_differing_card_vs_cpu": cdf_diff, "cdf_rows": cdf_rows,
           "pdf_max_rel_card_vs_cpu": pdf_rel, "audio_max_abs_err": max(errs)}
    print(f"    lm step (CUDA events, mean of 100): {step_ms[1]:.3f} ms at B=1, {step_ms[4]:.3f} "
          f"ms at B=4 (k={k} codebooks)")
    print(f"    lm coding: compress_batch 4 x {seconds} s at lm_batch 4 {enc_s:.2f} s "
          f"({res['encode_xrt']:.1f} s of audio per s), decompress_batch {dec_s:.2f} s "
          f"({res['decode_xrt']:.1f}); one clip at lm_batch 1: {enc1_s:.2f} / {dec1_s:.2f} s "
          f"({res['encode_1_xrt']:.1f} / {res['decode_1_xrt']:.1f})")
    print(f"    lm bytes {payload} against raw {raw} (a seeded, untrained LM compresses "
          f"nothing); 48k stereo 2.5 s: {len(blob48)} B")
    print(f"    card vs CPU LM, one clip teacher-forced: {cdf_diff} of {cdf_rows} CDF rows differ "
          f"(pdfs max rel. {pdf_rel:.1e}); a stream decodes only where it was written "
          f"(informative, not held)")
    phase("ecdc lm", same_codes and close and framing and native and counts == want,
          f"decoded codes == encoded bit for bit (4 at lm_batch 4, 1 at lm_batch 1, 48k's "
          f"{len(codes48)} frames): {same_codes}; audio vs decode(encode(x)) within rtol "
          f"1e-5/atol 1e-6: {close} (max|err| {max(errs):.2e}); headers lmb/lp {framing}; "
          f"native coder {native_build.library_path().name}: {native}; launches {counts} == "
          f"{want}; on {card}")
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
    a flip at a near-tie changes every later step, so only the first counts."""
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        with _LogitWatch() as watch:
            st, prefill_steps, b = model._generate(texts, temperature=0.0, **kw)
        runs[name] = (st, watch)
    (st_card, w_card), (st_cpu, w_cpu) = runs["card"], runs["cpu"]
    differ = st_card.generated.cpu() != st_cpu.generated
    step0 = int(prefill_steps.min()) - 1
    out = {"equal": not bool(differ.any()), "steps": st_cpu.step - step0, "first_slot": None,
           "gaps": [], "near_tie": True}
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
    phase("dia golden", golden["near_tie"] and ladder["near_tie"] and (ladder_ok or not ladder[
        "equal"]),
          f"tiny dia_golden weights, greedy, {golden['steps']} steps: card vs CPU "
          f"{_tie_detail(golden)}; serving ladder (int8 KV, block 16, int8 dots), greedy, "
          f"{ladder['steps']} steps: card == ladder_codes {tuple(want.shape)}: {ladder_ok}, "
          f"card vs CPU {_tie_detail(ladder)}")
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

    cfg = DiaConfig()
    cfg.encoder.n_layer = cfg.decoder.n_layer = 2
    card = Dia(cfg, device=DEVICE, seed=SEED)
    cpu = Dia(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    f64 = Dia(cfg, device="cpu", compute_dtype=torch.float64)
    f64.load_state_dict(card.state_dict())
    texts = DIA_TEXTS[:2]
    text = card._pad_text([card.encode_text(t) for t in texts])
    tokens = np.random.default_rng(SEED).integers(0, 1024, size=(4, 16, cfg.data.channels))
    states, logits = {}, {}
    runs = (("card", card), ("cpu", cpu), ("f64", f64), ("tf32", card))
    for name, model in runs:
        with _tf32_on() if name == "tf32" else contextlib.nullcontext():
            delayed, steps = model._prefill([None, None], 2)
            states[name] = model._start_state(text, delayed, steps, SEED, np.ones(2, bool),
                                              max_tokens=64)
            logits[name] = torch.stack([x.cpu().double() for x in
                                        _dia_forced_logits(model, states[name], tokens)])
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
    mods = [dia.decoder.logits_dense]
    for layer in dia.decoder.layers:
        mods += [layer.self_attention, layer.cross_attention.q_proj,
                 layer.cross_attention.o_proj, layer.mlp]
    tensors = [t for m in mods for t in m.state_dict().values()]
    weight_bytes = sum(t.numel() * t.element_size() for t in tensors)
    params = sum(t.numel() for t in tensors if t.dim() >= 2)
    kv_elem = 1 if dia.kv_cache_int8 else 4
    kv = d.n_layer * 2 * rows * live * d.kv_heads * (d.gqa_head_dim * kv_elem
                                                      + (4 if dia.kv_cache_int8 else 0))
    cross = d.n_layer * 2 * rows * text_len * d.cross_query_heads * d.cross_head_dim * 4
    flops = 2.0 * params * rows + d.n_layer * 4.0 * rows * d.gqa_query_heads * d.gqa_head_dim * (
        live + text_len)
    return weight_bytes + kv + cross, flops


def _steps_profile(step, n: int = 8) -> tuple[float, float, list]:
    """torch.profiler (device activity) over n calls of step(): device ms
    and device launches (kernels, copies, fills) a call, and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in events) / 1e3 / n,
            sum(e.count for e in events) / n,
            [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
             for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]])


def _dia_step_time(dia, texts, steps: int = 32) -> dict:
    """Warm decode steps from a fresh 4-request state in the served bucket:
    ms a step by CUDA events, the host's enqueue time a step, and from a
    torch.profiler pass over 8 more steps the device time and the launches
    a step."""
    text = dia._pad_text([dia.encode_text(t) for t in texts])
    delayed, prefill_steps = dia._prefill([None] * len(texts), len(texts))
    st = dia._start_state(text, delayed, prefill_steps, SEED, np.ones(len(texts), bool),
                          max_tokens=DIA_SERVE_KW["pad_tokens_to"],
                          token_limit=DIA_SERVE_KW["max_tokens"], kv_int8=dia.kv_cache_int8)
    sampling = dia._sampling(DIA_SERVE_KW["pad_tokens_to"], None, None, None, None)
    for _ in range(4):
        dia._decode_step(st, sampling)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        dia._decode_step(st, sampling)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    device_ms, launches, top = _steps_profile(lambda: dia._decode_step(st, sampling))
    return {"ms": ms, "host_enqueue_ms": host_ms, "device_ms": device_ms,
            "idle": 1.0 - device_ms / ms, "launches": launches, "position": st.step, "top": top}


def _dia_served(dia, texts, **kw) -> dict:
    """One generate() call, as the server makes it: its audio and codes,
    wall time, peak memory, the decode steps run (sampler calls), the
    device->host syncs (torch.cuda.set_sync_debug_mode) and whether any
    logit was NaN."""
    import warnings

    codes = []
    generate_codes = dia.generate_codes

    def recorded(*args, **kwargs):  # the codes under generate
        codes.append(generate_codes(*args, **kwargs))
        return codes[-1]
    dia.generate_codes = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, _LogitWatch() as watch:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            audios = dia.generate(texts, **kw)
            wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del dia.generate_codes
    steps = len(watch.gaps)
    return {"audios": audios, "codes": codes[0], "steps": steps, "wall_s": wall_s,
            "syncs": sum("synchroniz" in str(w.message) for w in caught),
            "tokens_per_s": steps * len(texts) / wall_s, "realtime": steps / 86.0 / wall_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "nan_logits": bool(watch.nan)}


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
    in 2 GiB shards and loaded back through load_dia; state dicts equal. The
    export is deleted once loaded."""
    import shutil

    from neuralcodecs_tpu_torch import load_dia
    from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig

    directory = tmp / "dia"
    dia, res = _export_and_load("dia-1.6b", Dia(DiaConfig(), device=DEVICE, seed=SEED),
                                directory, lambda d: load_dia(d, device=DEVICE), card,
                                max_shard_bytes=2 ** 31)
    shutil.rmtree(directory)
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
    in [0, 1023] with lengths at most max_tokens."""
    from neuralcodecs_tpu_torch.models.dac import DAC
    from neuralcodecs_tpu_torch.models.dia import model as dia_model
    from neuralcodecs_tpu_torch.ops import kernels

    dia, loaded = _dia_from_export(tmp, card)
    dia.load_dac_model(str(dac_dir))
    dac = dia.dac
    if not (isinstance(dac, DAC) and dac.device == dia.device):
        raise PhaseError(f"load_dac_model gave {type(dac).__name__} on {dac.device}")
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
        dia.generate_codes(DIA_TEXTS, **short_kw)                       # warm-up
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
        short = lambda: dia.generate_codes(DIA_TEXTS, **short_kw)  # noqa: E731
        f32_prof_wall = _timed_s(short)[1] * 1e3
        f32_prof = _device_profile(short, f32_prof_wall, None, reps=1)
        f32_bytes, f32_flops = _dia_step_bytes(dia, 8, 128, f32_step["position"])
        # the serving ladder, in place
        dia.quantize_int8().enable_int8_kv_cache()
        dia.kv_dot_int8 = True
        ladder = _dia_served(dia, DIA_TEXTS, **ladder_kw)
        check(ladder["audios"], "serve int8 ladder", ladder_kw["max_tokens"])
        ladder_step = _dia_step_time(dia, DIA_TEXTS)
        ladder_bytes, ladder_flops = _dia_step_bytes(dia, 8, 128, ladder_step["position"])
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n_dec, n_enc = len(_residual_units(dac.decoder)), len(_residual_units(dac.encoder))
    want = {**_NO_LAUNCHES, "codebook_argmin": dac.config.n_codebooks * dac_calls.calls["encode"],
            "fused_residual_unit_dense": n_dec * dac_calls.calls["from_codes"]
            + n_enc * dac_calls.calls["encode"]}
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
    res = {"params": n_params, "loaded": loaded, "counts": counts,
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
           "prompt_frames": int(prompt.shape[0])}
    for key, run in (("serve", served), ("clone", clone), ("ladder", ladder)):
        res[key] = {k: v for k, v in run.items() if k not in ("audios", "codes")}
    for label, run, step, bnd in (("f32", served, f32_step, res["bound_f32"]),
                                  ("int8 ladder", ladder, ladder_step, res["bound_int8"])):
        print(f"    dia {label}: {run['steps']} steps of 4 requests in {run['wall_s']:.2f} s = "
              f"{run['tokens_per_s']:.1f} tokens/s ({run['realtime']:.2f}x realtime a request); "
              f"decode step {step['ms']:.2f} ms (CUDA events; host enqueue "
              f"{step['host_enqueue_ms']:.2f} ms, device {step['device_ms']:.2f} ms, idle "
              f"{step['idle']:.1%}, {step['launches']:.0f} launches) at position "
              f"{step['position']}, bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}); "
              f"{run['syncs']} syncs; peak {run['peak_gb']:.2f} GB on {card}")
        print("    top: " + ", ".join(f"{k[:40]} {ms:.3f} ms x{n:.0f}" for k, ms, n in step["top"]))
    _print_profile("dia f32 32-token generation", f32_prof, f32_prof_wall)
    ok = (counts == want and stream_equal and prompt_equal and path_snr > 55.0
          and vocode_snr > 55.0
          and n_params > 1.6e9 and not any(r["nan_logits"] for r in runs) and sync_ok)
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
          f"{vocode_snr:.1f} dB > 55); no NaN logits")
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the per-shape details here (JSON)")
    args = parser.parse_args()
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
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            cb = phase_codebook(gen)
            # the served SNAC-24k, Encodec-24k and DAC-44k, loaded from exports
            model, enc, dac, dac_dir, loader = phase_loader(tmp, info["smi"])
            ru = phase_resunit(model, gen, model._pad_length(10 * model.config.sample_rate))
            phase_golden()
            phase_card_vs_cpu(model)
            serve = phase_serve(model, info["smi"])
            lstm = phase_lstm(enc, gen)
            phase_ecdc_golden()
            phase_encodec_card_vs_cpu(enc)
            enc_serve = phase_encodec_serve(enc, info["smi"])
            enc48, model48 = phase_encodec_48k(info["smi"])
            stream = phase_encodec_stream(enc, gen, info["smi"])
            loader["lm_cache"] = phase_lm_cache(enc, tmp, info["smi"])
            lm_coding = phase_ecdc_lm(enc, model48, info["smi"])
            env = phase_envelope(gen)
            bq = phase_biquad(gen)
            dsp, resampled = phase_dsp_pipeline(info["smi"])
            loud = phase_loudness(resampled, info["smi"])
            ru_dense = phase_resunit_dense(dac, gen)
            golden_dac, golden = phase_dac_golden()
            dac_cmp = phase_dac_card_vs_cpu(dac)
            dac_serve = phase_dac_serve(dac, info["smi"])
            phase_dac_file(golden_dac, golden, tmp)
            del dac
            t_dia = time.time()
            dia_golden = phase_dia_golden()
            dia_cmp = phase_dia_card_vs_cpu()
            dia_serve = phase_dia_serve(dac_dir, info["smi"], tmp)
            dia_serve["dia_phases_s"] = time.time() - t_dia
            print(f"    dia phases: {dia_serve['dia_phases_s']:.1f} s")
            loader["dia_1.6b"] = dia_serve["loaded"]
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    paths = (serve, enc_serve, enc48, stream, lm_coding, dsp, loud, dac_serve, dia_serve)
    launches = {name: sum(p["counts"][name] for p in paths) for name in KERNELS}
    lstm["rows"] += stream["lstm_rows"]
    cb["rows"] += stream["codebook_rows"]
    kernels_line = {"kernels": [
        _entry("codebook_argmin", "codebook.cu", "codebook.py:46", launches, cb),
        _entry("fused_residual_unit", "resunit.cu", "resunit.py:154", launches, ru),
        _entry("fused_residual_unit_dense", "resunit.cu",
               "resunit.py:154 (depthwise=False)", launches, ru_dense),
        _entry("lstm_scan", "lstm.cu", "lstm.py:103", launches, lstm),
        _entry("envelope_follow", "envelope.cu", "envelope.py:75", launches, env),
        _entry("biquad_df2t", "biquad.cu", "biquad.py:69", launches, bq),
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": info, "seconds": time.time() - t_start, "build": built, "codebook": cb,
             "resunit": ru, "serve": serve, "lstm": lstm, "encodec_serve": enc_serve,
             "encodec_48k": enc48, "encodec_stream": stream, "ecdc_lm": lm_coding, "envelope": env,
             "biquad": bq, "dsp_pipeline": dsp, "loudness": loud, "resunit_dense": ru_dense,
             "dac_card_vs_cpu": dac_cmp, "dac_serve": dac_serve, "loader": loader,
             "dia_golden": dia_golden,
             "dia_card_vs_cpu": dia_cmp, "dia_serve": dia_serve}, indent=1, default=str))
    print(info["smi"])
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
