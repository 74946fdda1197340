"""Driver ``codec_roundtrip``: one closed-loop client sending DAC round trips.

Request i is ``DAC.forward`` on the pool entry i mod pool ([batch, T] in
host memory; the model copies it to the card), and ends when its codes and
audio are back in host memory. Its latency is host time over that span.

Set-up: the clips from the seed, the weights from the seed on the device
(``reference/dac.draw_weights``) loaded through ``load_state_dict`` over
the model's own initial weights, and one round trip at each length the
traffic sends.

Check (after the window, the program freed): a reservoir sample of the
requests drawn from the seed, with the longest clip in it where the
traffic is ragged. The plain reference (f32, TF32 off) encodes each
sample's input: ``codes_mismatch_pct`` is the share of the program's RVQ
codes over the whole sample that differ (encoder, codebook kernel, kernel
2b). It decodes the program's codes: ``audio_rel_err`` is the L2 distance
of the program's audio from it over its norm (decoder, kernel 2b,
transposed convs), the worst request's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmarks import harness, traffic
from benchmarks.arith import dac as arith
from benchmarks.arith.peaks import TF32_FLOPS
from benchmarks.reference import dac as ref

WEIGHTS, CLIPS = 1, 2   # sub-seed tags


def weight_seed(seed: int) -> int:
    return harness.sub_seed(seed, WEIGHTS)


def build(cfg: dict, seed: int, device):
    """The program's DAC with the seed's weights, eval mode."""
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig

    keys = ("sample_rate", "encoder_dim", "encoder_rates", "decoder_dim", "decoder_rates",
            "n_codebooks", "codebook_size", "codebook_dim", "latent_dim")
    model = DAC(DACConfig(**{k: cfg[k] for k in keys}), device=device)
    model.load_state_dict(ref.draw_weights(cfg, weight_seed(seed), device))
    return model.eval()


def compare(cfg: dict, seed: int, device, samples: list, inputs: list, limits: dict
            ) -> list[harness.Check]:
    """The cell's checks of ``samples`` [(request, codes, audio)] against
    the reference, which draws the weights again from the seed."""
    w = ref.draw_weights(cfg, weight_seed(seed), device)
    differ = total = 0
    worst_audio = 0.0
    with ref.precision(tf32=False):
        for i, codes, audio in samples:
            x = torch.as_tensor(inputs[i % len(inputs)], device=device)
            want = ref.encode(w, cfg, x).cpu()
            differ += int((want != codes.long()).sum())
            total += want.numel()
            want_audio = ref.decode(w, cfg, codes.to(device))[:, : x.shape[-1]].double().cpu()
            err = float(torch.linalg.vector_norm(audio.double() - want_audio)
                        / torch.linalg.vector_norm(want_audio))
            worst_audio = max(worst_audio, err)
    return [harness.Check("codes_mismatch_pct", 100.0 * differ / total,
                          limits["codes_mismatch_pct"]),
            harness.Check("audio_rel_err", worst_audio, limits["audio_rel_err"])]


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        self.cfg, self.traffic, self.limits = cell["config_data"], cell["traffic"], cell["limits"]
        self.seed, self.device = seed, device
        self.sr = self.cfg["sample_rate"]
        stamp = harness.Stamps()
        lengths = traffic.clip_lengths(self.traffic, self.sr)
        self.inputs = traffic.make_clips(lengths, self.traffic["batch"], self.sr,
                                         harness.sub_seed(seed, CLIPS), device)
        stamp("inputs")
        self.model = build(self.cfg, seed, device)
        stamp("weights")
        for n in sorted(set(lengths)):
            x = next(c for c in self.inputs if c.shape[-1] == n)
            out = self.model.forward(x)
            out["codes"].cpu(), out["audio"].cpu()
        stamp("warm-up")
        self.setup_phases = stamp.phases
        self.longest = max(lengths)
        self.kept = harness.Reservoir(int(self.traffic["check_requests"]), seed)
        self.kept_longest = None
        self.tracing = False
        self.traced = {"flops": 0.0, "peak_flops": TF32_FLOPS, "resunit_bound_s": 0.0}

    def call(self, i: int) -> dict:
        x = self.inputs[i % len(self.inputs)]
        t0 = time.perf_counter()
        with harness.span(self.tracing, "forward"):
            out = self.model.forward(x)
        with harness.span(self.tracing, "fetch"):
            codes, audio = out["codes"].cpu(), out["audio"].cpu()
        latency = time.perf_counter() - t0
        self.last = (i, codes, audio)
        self.kept.offer(self.last)
        if self.kept_longest is None and self.traffic.get("check_longest") \
                and x.shape[-1] == self.longest:
            self.kept_longest = (i, codes, audio)
        if self.tracing:
            b, n = x.shape
            self.traced["flops"] += arith.roundtrip_flops(self.cfg, n, b)
            self.traced["resunit_bound_s"] += arith.units_bound_s(
                arith.roundtrip_units(self.cfg, n), b)
        return {"requests": 1, "audio_s": x.size / self.sr, "latency_s": [latency]}

    def release(self) -> None:
        del self.model
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def samples(self) -> list:
        kept = list(self.kept.items)
        if self.kept_longest is not None and self.kept_longest[0] not in {k[0] for k in kept}:
            kept.append(self.kept_longest)
        return sorted(kept, key=lambda k: k[0])

    def check(self) -> list[harness.Check]:
        return compare(self.cfg, self.seed, self.device, self.samples(), self.inputs,
                       self.limits)


def readings(cell: dict, seed: int, device) -> dict:
    """The check's numbers for the program and for the control on the same
    requests (the first ``check_requests`` of the pool, and the longest
    clip): the program through its set-up and ``call``, untimed; the
    control the reference computed one step lower (TF32 products) in the
    program's place, its audio decoded from its own codes."""
    drv = Driver(cell, seed, device)
    n = int(cell["traffic"]["check_requests"])
    requests = list(range(n))
    if cell["traffic"].get("check_longest"):
        requests.append(int(np.argmax([c.shape[-1] for c in drv.inputs])))
    program = []
    for i in requests:
        drv.call(i)
        program.append(drv.last)
    drv.release()
    cfg, inputs = drv.cfg, drv.inputs
    w = ref.draw_weights(cfg, weight_seed(seed), device)
    control = []
    with ref.precision(tf32=True):
        for i in requests:
            x = torch.as_tensor(inputs[i % len(inputs)], device=device)
            codes = ref.encode(w, cfg, x)
            audio = ref.decode(w, cfg, codes)[:, : x.shape[-1]]
            control.append((i, codes.cpu(), audio.cpu()))
    del w
    limits = cell["limits"]
    return {"program": compare(cfg, seed, device, program, inputs, limits),
            "control": compare(cfg, seed, device, control, inputs, limits)}
