"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out details.json]

Builds the port's CUDA kernels from neuralcodecs_tpu_torch/csrc and holds
each against its plain PyTorch version at the shapes its round trips give
it. SNAC-24k: holds the depthwise residual-unit kernels (a depthwise launch
and a tensor-core launch a unit, 3xTF32) against the plain chain at every
unit shape of a 10 s stream, checks the port against the frozen SNAC golden
and against itself on the CPU, then serves a few requests through full-width SNAC-24k
(seeded random weights). Encodec: reproduces the frozen raw .ecdc stream,
holds the LSTM recurrence kernel against its plain loop beside the
floor of its per-step handoff, checks full-width Encodec-24k against
itself on the CPU, serves a few
requests through it and times its round trip with the kernels and with
the plain versions, then runs full-width stereo Encodec-48k through its
chunked forward. DSP (BASELINE.json config 4, 64 clips of 10 s): holds
the envelope and biquad kernels bit-exact against their plain loops, runs
the resample -> compressor -> mel chain at 44.1 -> 24 kHz against the CPU
and times it with the kernels and with the plain loops, then measures and
normalises the BS.1770 loudness of the resampled batch (also handed over as
a numpy array, which must run on the card). DAC-44k: holds the
dense residual-unit kernels (a snake launch and two tensor-core launches a
unit, 3xTF32) against the plain chain at every unit shape of a 10 s
stream, reproduces the frozen DAC golden and its .dac bytes, checks
full-width DAC-44k against itself on the CPU, then serves a few requests
through it and times its round trip with the kernels and with the plain
versions. Each served path runs with the launch counters set to 0 just
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
    wgmma warning) and, for the residual-unit GEMM kernels, the count of
    tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in their SASS.
    Fails unless every instantiation of the residual unit's GEMM (both
    forms' pointwise launch, the dense form's conv launch) has HGMMA
    instructions."""
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
    for name, counts in sass.items():
        print(f"    sass: {name}: {counts}")
    on_tensor_cores = bool(sass) and all(c["HGMMA"] > 0 for c in sass.values())
    phase("build", on_tensor_cores,
          f"{[s.name for s in build.sources()]} -> {build.library_path().name} in "
          f"{seconds:.1f} s; HGMMA in each of the {len(sass)} residual-unit GEMM kernels: "
          f"{on_tensor_cores}")
    return {"seconds": seconds, "ptxas": report, "sass": sass}


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


def phase_codebook(gen: torch.Generator) -> dict:
    from neuralcodecs_tpu_torch.ops.kernels.codebook import (
        codebook_argmin, codebook_argmin_plain)
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    dev = torch.device(DEVICE)
    # (N, D, T, normalized): SNAC 4096x8 at one 10 s stream's stage lengths
    # (118/236/472) and at batch 4 (1888), DAC 1024x8, and Encodec 1024x128
    # at the rows a stage gets on its paths: 24k 1 s (75), 48k 2.5 s tail
    # (78), one 48k chunk (150), the 48k two-chunk batch (300), 24k 3 s
    # padded to batch 4 (900) and 24k batch 4 x 10 s (3000)
    cases = [(4096, 8, t, True) for t in (118, 236, 472, 1501, 1888)]
    cases += [(1024, 8, 862, True)]
    cases += [(1024, 128, t, False) for t in (75, 78, 150, 300, 900, 3000)]
    rows, near, worst, err = [], 0, 0.0, 0.0
    stream_ms = stream_plain_ms = stream_flops = stream_bytes = 0.0
    for n, d, t, norm in cases:
        flat = torch.randn(t, d, generator=gen, device=dev)
        cb = torch.randn(n, d, generator=gen, device=dev)
        if norm:
            flat, cb = l2_normalize(flat).contiguous(), l2_normalize(cb).contiguous()
        got = codebook_argmin(flat, cb)
        want = codebook_argmin_plain(flat, cb)
        torch.cuda.synchronize()
        k, gap = _compare_codes(flat, cb, got, want)
        near, worst, err = near + k, max(worst, gap), max(err, gap)
        ms = time_ms(lambda: codebook_argmin(flat, cb))
        plain_ms = time_ms(lambda: codebook_argmin_plain(flat, cb))
        if n == 4096 and t in (118, 236, 472):
            stream_ms += ms
            stream_plain_ms += plain_ms
            stream_flops += 2.0 * t * n * d + 2.0 * n * d  # x·e and ‖e‖²
            stream_bytes += 4.0 * (t * d + n * d + t)
        rows.append({"N": n, "D": d, "T": t, "ms": ms, "plain_ms": plain_ms, "near_ties": k})
        print(f"    codebook N={n} D={d} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"near-tie rows {k}")

    # injected ties: 16 duplicated entries, latents equal to the first copies
    base = l2_normalize(torch.randn(4080, 8, generator=gen, device=dev))
    cb = torch.cat([base, base[:16]]).contiguous()
    flat = torch.cat([base[:16], l2_normalize(torch.randn(317, 8, generator=gen, device=dev))])
    flat = flat.contiguous()
    got = codebook_argmin(flat, cb)
    want = codebook_argmin_plain(flat, cb)
    torch.cuda.synchronize()
    lowest = bool((got[:16].long() == torch.arange(16, device=dev)).all())
    k, gap = _compare_codes(flat, cb, got, want)
    near, err = near + k, max(err, gap)
    phase("codebook kernel vs plain", lowest,
          f"{len(cases)} shapes + tie case equal (near-tie rows allowed: {near}, "
          f"max score gap {worst:.2e}); ties -> lowest index: {lowest}")
    return {"rows": rows, "near_tie_rows": near, "max_abs_err": err,
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
    import importlib.util

    from neuralcodecs_tpu_torch.ops.kernels.lstm import (
        lstm_scan, lstm_scan_plain, lstm_scan_plan)

    spec = importlib.util.spec_from_file_location("lstm_ablate", ROOT / "tools" / "lstm_ablate.py")
    ablate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablate)
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
    return {"counts": counts, "ms": ms}


# ----------------------------------------------------------- DSP phases


# BASELINE.json config 4 (bench.py, bench_dsp): 64 clips of 10 s at
# 44.1 kHz, resampled to 24 kHz, compressed, then an 80-band mel
DSP_BATCH, DSP_SECONDS, DSP_SRC, DSP_DST = 64, 10, 44100, 24000
# (N, T) at which kernels 4-5 are held against their plain loops: the
# config-4 batch, one clip, a single sample, rows past whole blocks of 4
# (130 = 32 blocks + 2 rows), a whole number of 256-sample tiles, and a T
# that is a multiple of neither the tile nor the 4-sample step group
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


def _recurrence_phase(name: str, kernel, plain, cases: list, ops_per_sample: int) -> dict:
    """Kernel against its plain loop, bit-exact (torch.equal), for each
    (label, x, args) case; the plain loop runs once a case (seconds at the
    config-4 T) and that run is its time. The bound is the first case's
    (the config-4 shape): ``ops_per_sample`` f32 operations a sample, one
    read and one write."""
    rows, bad, err = [], [], 0.0
    for label, x, args in cases:
        got = kernel(x, *args)
        want, plain_ms = _timed(lambda: plain(x, *args))
        exact = torch.equal(got, want)
        e = float((got - want).abs().max())
        err = max(err, e)
        if not exact:
            bad.append((label, tuple(x.shape), e))
        ms = time_ms(lambda: kernel(x, *args), 10)
        rows.append({"case": label, "N": x.shape[0], "T": x.shape[1], "ms": ms,
                     "plain_ms": plain_ms, "max_abs_err": e})
        print(f"    {name} {label} N={x.shape[0]} T={x.shape[1]}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, " + ("bit-exact" if exact else f"MISMATCH max|err| {e:.2e}"))
    phase(f"{name} kernel vs plain", not bad,
          f"{len(cases)} cases bit-exact (torch.equal)" + (f"; mismatches {bad}" if bad else ""))
    n = cases[0][1].numel()
    return {"rows": rows, "max_abs_err": err, "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "library_ms": None, **bound(float(ops_per_sample) * n, 8.0 * n)}


def _compressor_gains(sample_rate: int) -> tuple[float, float]:
    """The attack and release gains apply_compressor gives its follower."""
    return (1.0 - math.exp(-1.0 / int(0.005 * sample_rate)),
            1.0 - math.exp(-1.0 / int(0.050 * sample_rate)))


def phase_envelope(gen: torch.Generator) -> dict:
    from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow, envelope_follow_plain

    gains = _compressor_gains(DSP_DST)
    cases = [("compressor 24k", 0.25 * torch.randn(n, t, generator=gen, device=DEVICE), gains)
             for n, t in RECURRENCE_SHAPES]
    # a step: |x| compare-select, subtract, multiply, add
    return _recurrence_phase("envelope", envelope_follow, envelope_follow_plain, cases, 4)


def _biquads() -> list[tuple[str, tuple, tuple]]:
    """Both K-weighting stages and one random stable biquad (poles at
    radius 0.95)."""
    from neuralcodecs_tpu_torch.dsp import loudness

    rng = np.random.default_rng(SEED + 6)
    theta = rng.uniform(0.1, 3.0)
    rand = (tuple(0.5 * rng.standard_normal(3)), (1.0, -1.9 * math.cos(theta), 0.95 ** 2))
    return [("k-shelf", loudness._HIGH_SHELF_B, loudness._HIGH_SHELF_A),
            ("k-highpass", loudness._HIGH_PASS_B, loudness._HIGH_PASS_A),
            ("random", *rand)]


def phase_biquad(gen: torch.Generator) -> dict:
    from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t, biquad_df2t_plain

    cases = []
    for n, t in RECURRENCE_SHAPES:
        x = 0.25 * torch.randn(n, t, generator=gen, device=DEVICE)
        cases += [(label, x, (b, a)) for label, b, a in _biquads()]
    # a step: five multiplies, four adds
    return _recurrence_phase("biquad", biquad_df2t, biquad_df2t_plain, cases, 9)


@contextlib.contextmanager
def _plain_dsp_kernels():
    """Swap the plain versions in where the DSP filters call the envelope
    and biquad kernels, for a kernel-vs-plain timing of the same path."""
    from neuralcodecs_tpu_torch.dsp import filters
    from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t_plain
    from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow_plain

    saved = filters.envelope_follow, filters.biquad_df2t
    filters.envelope_follow, filters.biquad_df2t = envelope_follow_plain, biquad_df2t_plain
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
    [64, 1, 240 000] at 24 kHz."""
    from neuralcodecs_tpu_torch.dsp import AudioSignal
    from neuralcodecs_tpu_torch.ops import kernels

    from neuralcodecs_tpu_torch.dsp.loudness import integrated_loudness

    sig = AudioSignal(resampled[:, None, :], DSP_DST)
    sig.loudness()  # warm
    # a numpy batch goes to the card, as jnp.asarray puts it on the TPU
    kernels.reset_launch_counts()
    lufs_np = integrated_loudness(resampled[:, None, :].cpu().numpy(), DSP_DST)
    counts_np = kernels.launch_counts()
    np_on_card = lufs_np.device.type == "cuda" and counts_np["biquad_df2t"] == 2
    kernels.reset_launch_counts()
    lufs, ms = _timed(sig.loudness)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    relufs = sig.normalize(-24.0).loudness()
    counts_norm = kernels.launch_counts()
    want = {**_NO_LAUNCHES, "biquad_df2t": 2}
    want_norm = {**_NO_LAUNCHES, "biquad_df2t": 4}
    cpu = AudioSignal(resampled[:2, None, :].cpu(), DSP_DST).loudness()
    diff = float((lufs[:2].cpu() - cpu).abs().max())
    off = float((relufs + 24.0).abs().max())
    peak = _peak_gb(sig.loudness)
    with _plain_dsp_kernels():
        lufs_plain, plain_ms = _timed(sig.loudness)
    same = torch.equal(lufs, lufs_plain) and torch.equal(lufs_np, lufs)
    finite = bool(torch.isfinite(lufs).all())
    prof = _device_profile(sig.loudness, ms, "biquad_kernel", 2)
    _print_profile("loudness", prof, ms)
    phase("loudness", counts == want and counts_norm == want_norm and diff <= 1e-3
          and off <= 0.1 and same and finite and np_on_card,
          f"{tuple(sig.audio_data.shape)} at {DSP_DST} Hz: LUFS {float(lufs.min()):.3f} .. "
          f"{float(lufs.max()):.3f}; launches per loudness() {counts} == {want}, normalize + "
          f"loudness {counts_norm} == {want_norm}; first 2 clips card vs cpu |dLUFS| "
          f"{diff:.2e} (<= 1e-3); after normalize(-24) max |LUFS + 24| {off:.2e} (<= 0.1); "
          f"numpy input on the card, kernel launched: {np_on_card} ({counts_np['biquad_df2t']} "
          f"biquad launches); equal to the plain loops' and the numpy call's LUFS: {same}; "
          f"{ms:.2f} ms (CUDA events), plain versions "
          f"{plain_ms:.1f} ms; peak {peak:.3f} GB on {card}")
    return {"counts": counts, "counts_normalize": counts_norm, "counts_numpy": counts_np,
            "ms": ms, "plain_ms": plain_ms,
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
        from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
        from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
        from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

        info = phase_device()
        built = phase_build()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        cb = phase_codebook(gen)
        model = SNAC(SNACConfig.snac_24khz(), device=DEVICE, seed=SEED).eval()
        ru = phase_resunit(model, gen, model._pad_length(10 * model.config.sample_rate))
        phase_golden()
        phase_card_vs_cpu(model)
        serve = phase_serve(model, info["smi"])
        enc = Encodec(EncodecConfig.encodec_24khz(), device=DEVICE, seed=SEED).eval()
        lstm = phase_lstm(enc, gen)
        phase_ecdc_golden()
        phase_encodec_card_vs_cpu(enc)
        enc_serve = phase_encodec_serve(enc, info["smi"])
        enc48 = phase_encodec_48k(info["smi"])
        env = phase_envelope(gen)
        bq = phase_biquad(gen)
        dsp, resampled = phase_dsp_pipeline(info["smi"])
        loud = phase_loudness(resampled, info["smi"])
        dac = DAC(DACConfig.dac_44khz(), device=DEVICE, seed=SEED).eval()
        ru_dense = phase_resunit_dense(dac, gen)
        golden_dac, golden = phase_dac_golden()
        dac_cmp = phase_dac_card_vs_cpu(dac)
        dac_serve = phase_dac_serve(dac, info["smi"])
        with tempfile.TemporaryDirectory() as tmp:
            phase_dac_file(golden_dac, golden, Path(tmp))
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    paths = (serve, enc_serve, enc48, dsp, loud, dac_serve)
    launches = {name: sum(p["counts"][name] for p in paths) for name in KERNELS}
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
             "resunit": ru, "serve": serve, "lstm": lstm, "encodec_serve": enc_serve, "encodec_48k": enc48, "envelope": env,
             "biquad": bq, "dsp_pipeline": dsp, "loudness": loud, "resunit_dense": ru_dense,
             "dac_card_vs_cpu": dac_cmp, "dac_serve": dac_serve}, indent=1))
    print(info["smi"])
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
