"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out details.json]

Builds the port's CUDA kernels from neuralcodecs_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the SNAC-24k round trip
gives it, checks the port against the frozen SNAC golden and against itself
on the CPU, then serves a few requests through full-width SNAC-24k (seeded
random weights) and checks that the main path launched both kernels.
Exits non-zero at the first failed phase, and at once when no CUDA device
is available. The last line is a JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import queue
import subprocess
import sys
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


class PhaseError(RuntimeError):
    pass


def phase(name: str, ok: bool, detail: str) -> None:
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {detail}")


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
    from neuralcodecs_tpu_torch.ops.precision import disable_tf32, tf32_disabled

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    print(card, flush=True)
    disable_tf32()
    info = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    phase("device", bool(card) and tf32_disabled(),
          f"{info['name']} x{info['count']}, nvidia-smi '{card}', torch {info['torch']} "
          f"cuda {info['cuda']}, tf32 off={tf32_disabled()}")
    return info


# ---------------------------------------------------------------- phase 2


def phase_build() -> None:
    from neuralcodecs_tpu_torch.ops.kernels import build

    t0 = time.time()
    build.load_library()
    report = [ln.strip() for ln in build.build_log.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in report:
        print(f"    ptxas: {ln}")
    phase("build", True, f"{[s.name for s in build.sources()]} -> "
          f"{build.library_path().name} in {time.time() - t0:.1f} s")


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
    # (118/236/472) and at batch 4 (1888), DAC 1024x8, Encodec 1024x128
    cases = [(4096, 8, t, True) for t in (118, 236, 472, 1501, 1888)]
    cases += [(1024, 8, 862, True), (1024, 128, 150, False)]
    rows, near, worst, err = [], 0, 0.0, 0.0
    stream_ms = stream_plain_ms = 0.0
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
            "ms": stream_ms, "plain_ms": stream_plain_ms}


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


def phase_resunit(model, gen: torch.Generator, samples: int) -> dict:
    from neuralcodecs_tpu_torch.ops.kernels.resunit import (
        fused_residual_unit, residual_unit_plain)

    units = _residual_units(model)
    lengths = _unit_lengths(model, samples)
    rows, err, bad = [], 0.0, []
    total_ms = total_plain_ms = 0.0
    cases = [(u, t, 1) for u, t in zip(units, lengths)]
    cases.append((units[0], 1037, 2))  # ragged tail, two streams
    for unit, t, b in cases:
        c = unit.block[0].alpha.shape[1]
        x = torch.randn(b, c, t, generator=gen, device=model.device)
        args = _unit_args(unit)
        got = fused_residual_unit(x, *args, dilation=unit.dilation)
        want = residual_unit_plain(x, *args, dilation=unit.dilation)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        close = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
        err = max(err, e)
        if not close:
            bad.append((c, unit.dilation, t, e))
        iters = 3 if c * t > 10_000_000 else 10
        ms = time_ms(lambda: fused_residual_unit(x, *args, dilation=unit.dilation), iters)
        plain_ms = time_ms(lambda: residual_unit_plain(x, *args, dilation=unit.dilation), iters)
        if b == 1:
            total_ms += ms
            total_plain_ms += plain_ms
        rows.append({"C": c, "dilation": unit.dilation, "T": t, "B": b, "ms": ms,
                     "plain_ms": plain_ms, "max_abs_err": e})
        print(f"    resunit C={c} d={unit.dilation} T={t} B={b}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, max|err| {e:.2e}{'' if close else '  MISMATCH'}")
    phase("resunit kernel vs plain", not bad,
          f"{len(cases)} shapes within rtol 1e-4/atol 1e-5 (max|err| {err:.2e}); "
          f"one 10 s stream's 24 units: kernel {total_ms:.2f} ms, plain {total_plain_ms:.2f} ms"
          + (f"; mismatches {bad}" if bad else ""))
    return {"rows": rows, "max_abs_err": err, "ms": total_ms, "plain_ms": total_plain_ms}


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
    cpu = SNAC(model.config).eval()
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


def _serve(model, requests: list[np.ndarray], generator: torch.Generator
           ) -> tuple[list, int]:
    """Answer concurrent requests as the HTTP server does: equal-length
    requests are stacked into one forward, the batch padded to a power of
    two by repeating the last request. Returns (results, forward calls)."""
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
        stacked = np.stack(xs + [xs[-1]] * (target - len(xs)))
        out, codes = model.forward(stacked, generator)
        forwards += 1
        for i, (_, fut) in enumerate(group):
            fut.set_result((out[i], [c[i] for c in codes]))
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
    results, f = _serve(model, long_reqs, gen)  # cold: one batch-4 forward
    forwards += f
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results, f = _serve(model, long_reqs, gen)  # warm
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    forwards += f
    warm_ms = start.elapsed_time(end)
    for (out, codes), x in zip(results, long_reqs):
        _check_result(model, out, codes, x.shape[-1])
    short, f = _serve(model, short_reqs, gen)  # 3 requests padded to batch 4
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
    want = {"codebook_argmin": n_stages * forwards, "fused_residual_unit": n_units * forwards}
    xrt = 40.0 / (warm_ms / 1e3)
    phase("serve", counts == want,
          f"{forwards} forwards (2x 4x10 s batch, 3x3 s padded to 4, process_audio 44.1k); "
          f"launches {counts} == {want}; warm batch-4 10 s round trip {warm_ms:.1f} ms "
          f"(CUDA events; host {wall_s * 1e3:.1f} ms) = {xrt:.1f}x realtime on {card}")
    return {"counts": counts, "forwards": forwards, "warm_ms": warm_ms,
            "host_ms": wall_s * 1e3, "xrt": xrt}


# ------------------------------------------------------------------- main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the per-shape details here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    try:
        from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

        info = phase_device()
        phase_build()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        cb = phase_codebook(gen)
        model = SNAC(SNACConfig.snac_24khz(), device=DEVICE, seed=SEED).eval()
        ru = phase_resunit(model, gen, model._pad_length(10 * model.config.sample_rate))
        phase_golden()
        phase_card_vs_cpu(model)
        serve = phase_serve(model, info["smi"])
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels_line = {"kernels": [
        {"name": "codebook_argmin", "route": "cuda",
         "source": "neuralcodecs_tpu_torch/csrc/codebook.cu",
         "replaces": "neuralcodecs_tpu/ops/pallas/codebook.py:46",
         "launches": serve["counts"]["codebook_argmin"], "max_abs_err": cb["max_abs_err"],
         "ms": cb["ms"], "plain_ms": cb["plain_ms"]},
        {"name": "fused_residual_unit", "route": "cuda",
         "source": "neuralcodecs_tpu_torch/csrc/resunit.cu",
         "replaces": "neuralcodecs_tpu/ops/pallas/resunit.py:154",
         "launches": serve["counts"]["fused_residual_unit"], "max_abs_err": ru["max_abs_err"],
         "ms": ru["ms"], "plain_ms": ru["plain_ms"]},
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": info, "codebook": cb, "resunit": ru, "serve": serve}, indent=1))
    print(info["smi"])
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
