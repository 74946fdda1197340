"""Driver ``snac_roundtrip``: one closed-loop client sending SNAC round trips.

Request i is ``SNAC.forward`` on the pool entry i mod pool ([batch, T] in
host memory; the model copies it to the card), and ends when its codes (one
array a scale) and audio are back in host memory. Its latency is host time
over that span. On a card the pool and the answers sit in page-locked host
memory, as a batch pipeline's loader keeps them: both copies (31 MB each way
a request) are then the copy engine's, not the host's memcpy through a
staging buffer, so a run's rate does not follow the shared host's load.

Set-up: the clips from the seed, the weights from the seed on the device
(``reference/snac.draw_weights``) loaded through ``load_state_dict`` over
the model's own initial weights, and one round trip at each length the
traffic sends.

Check (after the window, the program freed): a reservoir sample of the
requests drawn from the seed. The plain reference (f32, TF32 off) encodes
each sample's input: ``codes_mismatch_pct`` is the share of the program's
codes, over every scale of the whole sample, that differ (encoder, codebook
kernel, kernel 2a). It decodes the program's codes with the noise the
program drew (a generator seeded 0 a request, on the same device):
``audio_rel_err`` is the L2 distance of the program's audio from it over its
norm, the worst request's (decoder, its noise, kernel 2a, transposed convs).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmarks import harness, traffic
from benchmarks.arith import snac as arith
from benchmarks.arith.peaks import TF32_FLOPS
from benchmarks.reference import snac as ref

WEIGHTS, CLIPS = 1, 2   # sub-seed tags
KEYS = ("sampling_rate", "encoder_dim", "encoder_rates", "latent_dim", "decoder_dim",
        "decoder_rates", "attn_window_size", "codebook_size", "codebook_dim", "vq_strides",
        "noise", "depthwise")


def weight_seed(seed: int) -> int:
    return harness.sub_seed(seed, WEIGHTS)


def build(cfg: dict, seed: int, device):
    """The program's SNAC with the seed's weights, eval mode."""
    from neuralcodecs_tpu_torch.models.snac import SNAC
    from neuralcodecs_tpu_torch.models.snac.config import SNACConfig

    model = SNAC(SNACConfig(**{k: cfg[k] for k in KEYS}), device=device)
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
            for want, got in zip(ref.encode(w, cfg, x), codes):
                differ += int((want.cpu() != got.long()).sum())
                total += want.numel()
            want_audio = ref.decode(w, cfg, [c.to(device) for c in codes],
                                    ref.noise_generator(device))
            want_audio = want_audio[:, : x.shape[-1]].double().cpu()
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
        self.sr = self.cfg["sampling_rate"]
        stamp = harness.Stamps()
        lengths = traffic.clip_lengths(self.traffic, self.sr)
        self.inputs = traffic.make_clips(lengths, self.traffic["batch"], self.sr,
                                         harness.sub_seed(seed, CLIPS), device)
        if device != "cpu":
            self.inputs = [torch.from_numpy(c).pin_memory() for c in self.inputs]
        stamp("inputs")
        self.model = build(self.cfg, seed, device)
        stamp("weights")
        for n in sorted(set(lengths)):
            self.fetch(*self.model.forward(next(c for c in self.inputs if c.shape[-1] == n)))
        stamp("warm-up")
        self.setup_phases = stamp.phases
        self.kept = harness.Reservoir(int(self.traffic["check_requests"]), seed)
        self.tracing = False
        self.traced = {"flops": 0.0, "peak_flops": TF32_FLOPS, "depthwise_bound_s": 0.0}

    def call(self, i: int) -> dict:
        x = self.inputs[i % len(self.inputs)]
        t0 = time.perf_counter()
        with harness.span(self.tracing, "forward"):
            audio, codes = self.model.forward(x)
        with harness.span(self.tracing, "fetch"):
            audio, codes = self.fetch(audio, codes)
        latency = time.perf_counter() - t0
        self.last = (i, codes, audio)
        self.kept.offer(self.last)
        b, n = x.shape
        if self.tracing:
            self.traced["flops"] += arith.roundtrip_flops(self.cfg, n, b)
            self.traced["depthwise_bound_s"] += arith.units_bound_s(
                arith.roundtrip_units(self.cfg, n), b)
        return {"requests": 1, "audio_s": b * n / self.sr, "latency_s": [latency]}

    def fetch(self, audio, codes):
        """The answers in host memory: on a card, copied into page-locked
        buffers (PyTorch's caching host allocator reuses freed ones) and
        waited for."""
        if self.device == "cpu":
            return audio, codes
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in [audio, *codes]]
        for h, t in zip(host, [audio, *codes]):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host[0], host[1:]

    def release(self) -> None:
        del self.model
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> list[harness.Check]:
        samples = sorted(self.kept.items, key=lambda k: k[0])
        return compare(self.cfg, self.seed, self.device, samples, self.inputs, self.limits)


def readings(cell: dict, seed: int, device) -> dict:
    """The check's numbers for the program and for the control on the same
    requests (the first ``check_requests`` of the pool): the program
    through its set-up and ``call``, untimed; the control the reference
    computed one step lower (TF32 products) in the program's place, its
    audio decoded from its own codes."""
    drv = Driver(cell, seed, device)
    requests = range(int(cell["traffic"]["check_requests"]))
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
            audio = ref.decode(w, cfg, codes, ref.noise_generator(device))[:, : x.shape[-1]]
            control.append((i, [c.cpu() for c in codes], audio.cpu()))
    del w
    limits = cell["limits"]
    return {"program": compare(cfg, seed, device, program, inputs, limits),
            "control": compare(cfg, seed, device, control, inputs, limits)}
