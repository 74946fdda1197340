"""Driver ``tts_generate``: one closed-loop client calling ``Dia.generate``.

Call i sends ``batch`` texts, the next ones of the workload's list in the
order the seed draws (``traffic.text_order``), with the call's own sampling
seed, ``max_tokens`` in the ``pad_tokens_to`` bucket and the model's default
sampling, except that every ``greedy_every``-th call (from
``greedy_offset``) decodes greedily, whose served tokens are judged one by
one. Its requests are its texts; its audio is the returned waveforms'
length.

Set-up: Dia's and the vocoder's weights from the seed on the device
(``reference/dia.draw_weights``, ``reference/dac.draw_weights``) loaded
through ``load_state_dict``; the program in the configuration's compute
dtype; ``generate_codes`` at a short length once sampled and once greedy
(the state slot and every step graph of the bucket captured), and the
vocoder once at the length every call returns.

The benchmark's spans: "generate_codes" around the program's codes (encoder,
prefill, decode loop, codes to the host), "vocode" around the vocoder's
``from_codes`` (a thin proxy set with ``set_dac_model``; it synchronises
while traced, so the span holds the vocoder's device time). A call's decode
steps are the traffic's, worked out from the returned lengths: the steps
that write every served token and each channel's EOS after it,
1 + the longest length + the largest delay (no audio prompt: the loop
starts after BOS).

Check (after the window, the program freed): one greedy and one sampled
call drawn from the seed, all their rows. The reference (f32, TF32 off)
runs the whole teacher-forced forward over each row's text and delayed
served tokens. Greedy rows: ``served_gap_max`` is the widest gap by which
a served token's guided score lies below the reference's best at its
position, ``served_flip_pct`` the share of served tokens that are not the
reference's argmax, ``served_gap_mean`` the mean gap (it grows as the
square of the program's error: the port's own int8 weight path, a step
below bf16, fails it). Sampled rows, against the distribution the reference's
sampler draws from at each position (``reference/dia.sampler_logprobs``:
temperature, top-k, top-p): ``sampled_out_pct``, the share of served
tokens outside its support (a filter left out or wrong);
``sampled_ll_z``, the z-score of the served tokens' log-probabilities
against their expectation (a wrong temperature); ``sampled_repeat_z``, the
z-score of how often a served token repeats an earlier one of its row and
channel against the expectation (noise that does not advance from step to
step). Then the reference vocoder decodes both calls' served codes:
``vocoder_rel_err`` is the L2 distance of the program's audio from it over
its norm (worst row).
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from benchmarks import harness, traffic
from benchmarks.arith import dac as dac_arith
from benchmarks.arith import dia as arith
from benchmarks.arith.peaks import PEAKS
from benchmarks.drivers import codec_roundtrip
from benchmarks.reference import dac as ref_dac
from benchmarks.reference import dia as ref

WEIGHTS, VOCODER, CALLS, SAMPLED, CONTROL = 1, 2, 3, 4, 5   # sub-seed tags
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _bucket(n: int, ceiling: int) -> int:
    """The text bucket the model pads to: a power of two from 64 up."""
    pad = 64
    while pad < min(n, ceiling):
        pad *= 2
    return min(pad, ceiling)


def _port_config(cfg: dict):
    from neuralcodecs_tpu_torch.models.dia.config import (DiaConfig, DiaDataConfig,
                                                          DiaDecoderConfig, DiaEncoderConfig)

    keys = ("vocab_size", "tgt_vocab_size", "normalization_layer_epsilon", "rope_min_timescale",
            "rope_max_timescale", "cfg_scale", "temperature", "top_p", "top_k", "sample_rate")
    return DiaConfig(**{k: cfg[k] for k in keys}, data=DiaDataConfig(**cfg["data"]),
                     encoder=DiaEncoderConfig(**cfg["encoder"]),
                     decoder=DiaDecoderConfig(**cfg["decoder"]))


class _Vocoder:
    """The vocoder with the benchmark's span around ``from_codes``."""

    def __init__(self, dac, driver: "Driver"):
        self._dac, self._driver = dac, driver

    def from_codes(self, codes):
        with harness.span(self._driver.tracing, "vocode"):
            out = self._dac.from_codes(codes)
            if self._driver.tracing and self._driver.device != "cpu":
                torch.cuda.synchronize()
        return out

    def __getattr__(self, name):
        return getattr(self._dac, name)


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from neuralcodecs_tpu_torch.models.dia import Dia

        self.cfg, self.traffic, self.limits = cell["config_data"], cell["traffic"], cell["limits"]
        self.voc_cfg = harness.load_config(self.cfg["vocoder"], cell["bench"])
        self.seed, self.device = seed, device
        stamp = harness.Stamps()
        self.texts = traffic.text_order(self.traffic, seed)
        self.dia = Dia(_port_config(self.cfg), device=device,
                       compute_dtype=DTYPES[self.cfg["compute_dtype"]]).eval()
        self.dia.load_state_dict(ref.draw_weights(self.cfg, harness.sub_seed(seed, WEIGHTS),
                                                  device))
        self.dac = codec_roundtrip.build(self.voc_cfg, harness.sub_seed(seed, VOCODER), device)
        self.dia.set_dac_model(_Vocoder(self.dac, self))
        stamp("weights")
        self.last_codes = None
        generate_codes = self.dia.generate_codes

        def spanned_generate_codes(*args, **kwargs):
            with harness.span(self.tracing, "generate_codes"):
                self.last_codes = generate_codes(*args, **kwargs)
            return self.last_codes

        self.dia.generate_codes = spanned_generate_codes
        self.tracing = False
        t = self.traffic
        batch = self.texts[: t["batch"]]
        for temperature in (None, 0.0):
            self.dia.generate_codes(batch, max_tokens=32, pad_tokens_to=t["pad_tokens_to"],
                                    temperature=temperature, seed=0)
        length = t["max_tokens"] - max(self.cfg["data"]["delay_pattern"]) - 1
        self.dac.from_codes(np.zeros((t["batch"], self.cfg["data"]["channels"], length),
                                     np.int32)).cpu()
        stamp("warm-up")
        self.setup_phases = stamp.phases
        # the check's calls: one greedy, one sampled
        self.kept = {True: harness.Reservoir(1, seed),
                     False: harness.Reservoir(1, harness.sub_seed(seed, SAMPLED))}
        self.traced = {"flops": 0.0, "peak_flops": PEAKS[self.cfg["compute_dtype"]],
                       "resunit_bound_s": 0.0, "steps": 0}

    def _texts(self, i: int) -> list[str]:
        b = self.traffic["batch"]
        return [self.texts[(b * i + j) % len(self.texts)] for j in range(b)]

    def greedy(self, i: int) -> bool:
        return i % self.traffic["greedy_every"] == self.traffic["greedy_offset"]

    def call(self, i: int) -> dict:
        t = self.traffic
        texts = self._texts(i)
        kwargs = dict(max_tokens=t["max_tokens"], pad_tokens_to=t["pad_tokens_to"],
                      seed=harness.sub_seed(self.seed, CALLS, i))
        if self.greedy(i):
            kwargs["temperature"] = 0.0
        audios = self.dia.generate(texts, **kwargs)
        codes, lengths = self.last_codes
        self.kept[self.greedy(i)].offer((texts, codes, lengths, audios))
        if self.tracing:
            rows = 2 * len(texts)
            text_len = _bucket(max(len(ref.text_tokens(self.cfg, x)) for x in texts),
                               self.cfg["data"]["text_length"])
            n = steps(self.cfg, lengths)
            self.traced["steps"] += n
            self.traced["flops"] += arith.generate_flops(
                self.cfg, rows, text_len, max(self.cfg["data"]["delay_pattern"]) + 1, n)
            for length in set(int(x) for x in lengths):
                group = int(np.sum(lengths == length))
                self.traced["flops"] += dac_arith.decode_flops(self.voc_cfg, length, group, True)
                self.traced["resunit_bound_s"] += dac_arith.units_bound_s(
                    dac_arith.decoder_units(self.voc_cfg, length), group)
        return {"requests": len(texts), "audio_s": sum(len(a) for a in audios)
                / self.cfg["sample_rate"]}

    def release(self) -> None:
        from neuralcodecs_tpu_torch.models.dia.model import release_generation_caches

        self.dia.set_dac_model(None)
        del self.dia, self.dac
        release_generation_caches()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> list[harness.Check]:
        greedy, sampled = self.kept[True].items, self.kept[False].items
        if not greedy or not sampled:
            return [harness.Check("greedy_and_sampled_calls", 0.0, -1.0)]
        return compare(self.cfg, self.voc_cfg, self.seed, self.device, greedy[0], sampled[0],
                       self.limits)[0]


def steps(cfg: dict, lengths: np.ndarray) -> int:
    """A call's decode steps: those that write every served token and each
    channel's EOS after it, from the first position after BOS."""
    return 1 + int(np.max(lengths)) + max(cfg["data"]["delay_pattern"])


def _served(cfg: dict, codes: np.ndarray, length: int) -> tuple[np.ndarray, np.ndarray]:
    """(position, channel) index arrays of a row's served tokens in the
    teacher-forced sequence, and their values, channel after channel:
    channel c's code t was sampled from the scores at position delay[c] + t."""
    pos, chan, val = [], [], []
    for c, dly in enumerate(cfg["data"]["delay_pattern"]):
        pos.append(np.arange(dly, dly + length))
        chan.append(np.full(length, c))
        val.append(codes[:length, c])
    return np.concatenate(pos), np.concatenate(chan), np.concatenate(val)


def _gaps(scores: torch.Tensor, pos, chan, tokens) -> torch.Tensor:
    """best score - the token's score, at each (position, channel)."""
    sc = scores[torch.as_tensor(pos), torch.as_tensor(chan)]
    tok = torch.as_tensor(tokens, device=sc.device).long()[:, None]
    return sc.max(dim=-1).values - sc.gather(-1, tok)[:, 0]


def _sample_sums(lp: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Sums over one row's sampled tokens, from the reference sampler's
    log-probabilities ``lp`` [C, L, V] at their positions and the tokens
    [C, L] (each channel's in order): [tokens outside the support, tokens
    inside; over those inside, log-probability less its expectation, and its
    variance; over all, the count of the channel's earlier tokens equal to
    the token less its expectation, and its variance]. Each term's
    expectation is taken given the tokens before it, so under sound sampling
    both sums are martingales of mean 0."""
    lp = lp.double()
    p = lp.exp()
    tok = tokens.to(lp.device).long()
    lt = lp.gather(-1, tok[..., None])[..., 0]
    inside = torch.isfinite(lt)
    plp = torch.where(p > 0, p * lp, 0.0)
    mean = plp.sum(-1)
    var = torch.where(p > 0, p * lp * lp, 0.0).sum(-1) - mean * mean
    onehot = torch.nn.functional.one_hot(tok, lp.shape[-1]).double()
    seen = onehot.cumsum(1) - onehot
    expect = (p * seen).sum(-1)
    return torch.stack([(~inside).sum().double(), inside.sum().double(),
                        (lt - mean)[inside].sum(), var[inside].sum(),
                        (seen.gather(-1, tok[..., None])[..., 0] - expect).sum(),
                        ((p * seen * seen).sum(-1) - expect * expect).sum()]).cpu()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||; inf where the lengths differ."""
    if got.shape != want.shape:
        return math.inf
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def fp8_rounded(w: torch.Tensor) -> torch.Tensor:
    """w rounded to fp8 e4m3 through a power-of-two scale that puts its
    largest entry in e4m3's range."""
    scale = 2.0 ** torch.floor(torch.log2(240.0 / w.abs().amax()))
    return (w * scale).to(torch.float8_e4m3fn).to(w.dtype) / scale


def _checks(limits: dict, gaps: list, sums: list, errs: list) -> list[harness.Check]:
    g, t = torch.cat(gaps), torch.stack(sums).sum(0)
    return [harness.Check("served_gap_max", float(g.max()), limits["served_gap_max"]),
            harness.Check("served_flip_pct", 100.0 * float((g > 0).double().mean()),
                          limits["served_flip_pct"]),
            harness.Check("served_gap_mean", float(g.double().mean()), limits["served_gap_mean"]),
            harness.Check("sampled_out_pct", 100.0 * float(t[0] / (t[0] + t[1])),
                          limits["sampled_out_pct"]),
            harness.Check("sampled_ll_z", abs(float(t[2] / t[3].sqrt())),
                          limits["sampled_ll_z"]),
            harness.Check("sampled_repeat_z", abs(float(t[4] / t[5].sqrt())),
                          limits["sampled_repeat_z"]),
            harness.Check("vocoder_rel_err", max(errs), limits["vocoder_rel_err"])]


def compare(cfg: dict, voc_cfg: dict, seed: int, device, greedy: tuple, sampled: tuple,
            limits: dict, control: bool = False):
    """The cell's checks of a greedy and a sampled call, each (texts, codes,
    lengths, audios); with ``control``, also the control's: the reference
    with every projection's weights rounded to fp8 (one step below bf16) in
    the program's place at each served position, teacher-forced on the same
    tokens: its argmax on the greedy rows, its own sampler with Gumbel noise
    drawn from the seed on the sampled rows; and the reference vocoder with
    TF32 products decoding the codes. Returns (program checks, control
    checks or None)."""
    w = ref.draw_weights(cfg, harness.sub_seed(seed, WEIGHTS), device)
    low = {k: fp8_rounded(v) if k.endswith("proj.weight") or ".mlp." in k
           or k.endswith("logits_dense.weight") else v for k, v in w.items()} if control else None
    noise = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, CONTROL))
    channels = cfg["data"]["channels"]
    gaps, low_gaps, sums, low_sums = [], [], [], []
    with ref.precision():
        for is_greedy, (texts, codes, lengths, _) in ((True, greedy), (False, sampled)):
            for r, text in enumerate(texts):
                length = int(lengths[r])
                tokens = ref.delayed_tokens(cfg, codes[r, :length])
                txt = ref.text_tokens(cfg, text)
                pos, chan, served = _served(cfg, codes[r], length)
                at = torch.as_tensor(pos), torch.as_tensor(chan)
                scores = ref.guided(cfg, ref.logits(w, cfg, txt, tokens))
                low_scores = (ref.guided(cfg, ref.logits(low, cfg, txt, tokens))[at]
                              if control else None)
                if is_greedy:
                    gaps.append(_gaps(scores, pos, chan, served).cpu())
                    if control:
                        picked = low_scores.argmax(-1).cpu().numpy()
                        low_gaps.append(_gaps(scores, pos, chan, picked).cpu())
                else:
                    lp = ref.sampler_logprobs(cfg, scores[at]).view(channels, length, -1)
                    sums.append(_sample_sums(lp, torch.as_tensor(served).view(channels, -1)))
                    if control:
                        low_lp = ref.sampler_logprobs(cfg, low_scores)
                        u = torch.rand(low_lp.shape, generator=noise, device=device)
                        gumbel = -torch.log(-torch.log(u.clamp(min=1e-30)))
                        picked = (low_lp + gumbel).argmax(-1).view(channels, length)
                        low_sums.append(_sample_sums(lp, picked))
                del scores, low_scores
    del w, low
    gc.collect()
    wd = ref_dac.draw_weights(voc_cfg, codec_roundtrip.weight_seed(
        harness.sub_seed(seed, VOCODER)), device)
    rows = [(torch.as_tensor(codes[r:r + 1, :max(int(lengths[r]), 1)].transpose(0, 2, 1),
                             device=device), audios[r])
            for _, codes, lengths, audios in (greedy, sampled) for r in range(len(lengths))]
    with ref_dac.precision(tf32=False):
        want = [ref_dac.decode(wd, voc_cfg, x)[0].double().cpu() for x, _ in rows]
    errs = [_rel(torch.as_tensor(np.asarray(a), dtype=torch.float64), y)
            for (_, a), y in zip(rows, want)]
    low_errs = []
    if control:
        with ref_dac.precision(tf32=True):
            low_errs = [_rel(ref_dac.decode(wd, voc_cfg, x)[0].double().cpu(), y)
                        for (x, _), y in zip(rows, want)]
    return (_checks(limits, gaps, sums, errs),
            _checks(limits, low_gaps, low_sums, low_errs) if control else None)


def readings(cell: dict, seed: int, device, int8: bool = False) -> dict:
    """The check's numbers for the program and for the control on a greedy
    and a sampled call's rows: the program through its set-up and ``call``
    (untimed; with ``int8``, its own int8 weight path), the control on the
    same texts and served tokens."""
    drv = Driver(cell, seed, device)
    if int8:
        drv.dia.quantize_int8()
    offset = int(cell["traffic"]["greedy_offset"])
    drv.call(offset)
    drv.call(offset + 1)
    greedy, sampled = drv.kept[True].items[0], drv.kept[False].items[0]
    drv.release()
    program, control = compare(drv.cfg, drv.voc_cfg, seed, device, greedy, sampled,
                               cell["limits"], control=True)
    return {"program": program, "control": control}
