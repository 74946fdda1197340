"""The port's span recorder (``diagnostics.profiler.span``) and its spans in
Dia's, DAC's and SNAC's paths, on the CPU with tiny configurations.

Off (no profiler recording, no ``recording()`` block), ``span`` returns one
shared object and records nothing. On, spans nest by parent id, share the
root's request id, lie inside their own ``nc.*`` profiler events (the
clock they share with the device trace), carry the counts the benchmark's
readers need, and change no output.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuralcodecs_tpu_torch.diagnostics import profiler
from neuralcodecs_tpu_torch.diagnostics.profiler import (
    annotate,
    clear_spans,
    recorded_spans,
    recording,
    span,
)
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dia import Dia
from neuralcodecs_tpu_torch.models.dia.config import (
    DiaConfig,
    DiaDataConfig,
    DiaDecoderConfig,
    DiaEncoderConfig,
)
from neuralcodecs_tpu_torch.models.layers import ResidualUnit
from neuralcodecs_tpu_torch.models.snac import SNAC
from neuralcodecs_tpu_torch.models.snac.config import SNACConfig

TEXTS = ["[S1] one two [S2] three", "[S1] four five six [S2] seven"]


@pytest.fixture(autouse=True)
def _empty_recorder():
    clear_spans()
    yield
    clear_spans()


def _tiny_dac() -> DAC:
    cfg = DACConfig(sample_rate=4410, encoder_dim=8, encoder_rates=[2, 4], decoder_dim=32,
                    decoder_rates=[4, 2], n_codebooks=3, codebook_size=1024, codebook_dim=4)
    return DAC(cfg, device="cpu", seed=1).eval()


def _tiny_snac() -> SNAC:
    cfg = SNACConfig(sampling_rate=2400, encoder_dim=8, encoder_rates=[2, 4], decoder_dim=32,
                     decoder_rates=[4, 2], attn_window_size=None, codebook_size=256,
                     codebook_dim=4, vq_strides=[4, 2, 1])
    return SNAC(cfg, device="cpu", seed=2).eval()


def _tiny_dia() -> Dia:
    cfg = DiaConfig(
        vocab_size=256, tgt_vocab_size=1028, sample_rate=4410,
        data=DiaDataConfig(text_length=64, audio_length=64, channels=3, audio_eos_value=1024,
                           audio_pad_value=1025, audio_bos_value=1026,
                           delay_pattern=[0, 1, 2]),
        encoder=DiaEncoderConfig(n_layer=2, n_embd=32, n_hidden=64, n_head=2, head_dim=16),
        decoder=DiaDecoderConfig(n_layer=2, n_embd=48, n_hidden=96, gqa_query_heads=4,
                                 kv_heads=2, gqa_head_dim=16, cross_query_heads=2,
                                 cross_head_dim=16))
    dia = Dia(cfg, device="cpu", seed=3).eval()
    dia.set_dac_model(_tiny_dac())
    return dia


def _children(spans, parent) -> list[str]:
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_span_off_is_one_shared_object_and_records_nothing():
    assert not torch._C._autograd._profiler_enabled()
    first = span("dia.loop", device=torch.device("cuda"))
    assert first is span("dac.encoder")
    with first as s:
        s.set(replays=3)
    assert s is first
    assert list(recorded_spans()) == [] and recorded_spans().dropped == 0


def test_spans_nest_and_share_a_request_under_the_profiler():
    def call():
        with span("outer") as outer:
            with span("middle", device="cpu"):
                with span("inner") as inner:
                    inner.set(tests=1)
            outer.set(rows=2)
        return outer

    with profile(activities=[ProfilerActivity.CPU]):
        first, second = call(), call()
    spans = recorded_spans()
    assert [s.name for s in spans] == ["inner", "middle", "outer"] * 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert (s.parent is None) == (s.name == "outer")
        if s.parent is not None:
            assert by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns
    assert {s.request for s in spans[:3]} == {first.id}
    assert {s.request for s in spans[3:]} == {second.id} != {first.id}
    assert spans[0].attrs == {"tests": 1} and spans[2].attrs == {"rows": 2}
    assert spans[1].attrs == {}
    assert all(s.device_ms is None for s in spans)   # no card: no events


def test_threads_get_requests_of_their_own():
    barrier = threading.Barrier(2)

    def work():
        with span("root"):
            barrier.wait()
            with span("leaf"):
                barrier.wait()

    with recording():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = recorded_spans()
    roots = {s.id for s in spans if s.name == "root"}
    assert len(roots) == 2
    assert {s.request for s in spans if s.name == "leaf"} == roots
    assert all(s.parent == s.request for s in spans if s.name == "leaf")


def test_records_lie_inside_their_profiler_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with span("outer"):
                with span("inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("nc.")]
    spans = recorded_spans()
    assert len(events) == len(spans) == 6
    for name in ("outer", "inner"):
        evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.name() == "nc." + name)
        recs = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        for (lo, hi), (start, end) in zip(evs, recs):
            assert lo <= start <= end <= hi


def test_the_cap_counts_what_it_turns_away(monkeypatch):
    monkeypatch.setattr(profiler, "SPAN_CAP", 3)
    with recording():
        for i in range(5):
            with span("s") as s:
                s.set(i=i)
    spans = recorded_spans()
    assert [s.attrs["i"] for s in spans] == [0, 1, 2] and spans.dropped == 2
    clear_spans()
    assert recorded_spans().dropped == 0


@pytest.mark.parametrize("temperature", [0.0, None], ids=["greedy", "sampled"])
def test_dia_generate_records_its_layers(monkeypatch, temperature):
    dia = _tiny_dia()
    steps = []
    advance = Dia._advance

    def counted(self, st, s):
        steps.append(st.step)
        return advance(self, st, s)

    monkeypatch.setattr(Dia, "_advance", counted)
    with recording():
        audios = dia.generate(TEXTS, max_tokens=40, seed=11, temperature=temperature)
    assert len(audios) == 2
    spans = recorded_spans()
    root = _one(spans, "dia.generate")
    assert root.parent is None and root.attrs == {}
    assert _children(spans, root) == ["dia.encode", "dia.prefill", "dia.loop"]
    assert {s.request for s in spans if s.name.startswith("dia.")} == {root.id}
    loop = _one(spans, "dia.loop")
    # on the CPU no step runs the decode-attention kernel
    assert len(steps) > 0 and loop.attrs == {"replays": 0, "eager_steps": len(steps),
                                             "attn_kernel_steps": 0}
    # the vocoder runs after the codes, its decoder outside the root
    assert all(s.parent is None and s.start_ns >= root.end_ns
               for s in spans if s.name == "dac.decoder")
    assert {s.name for s in spans} == {"dia.generate", "dia.encode", "dia.prefill",
                                       "dia.loop", "dac.decoder"}


def test_dac_forward_records_its_stages():
    model = _tiny_dac()
    audio = (0.3 * np.random.default_rng(0).standard_normal((2, 1000))).astype(np.float32)
    with recording():
        model.forward(audio)
    spans = recorded_spans()
    root = _one(spans, "dac.forward")
    assert root.parent is None and root.attrs == {}
    assert _children(spans, root) == ["dac.prepare", "dac.encoder", "dac.quantizer",
                                      "dac.decoder"]
    stages = sorted((s for s in spans if s is not root), key=lambda s: s.start_ns)
    # siblings one after another inside the root, as the readers assume
    assert root.start_ns <= stages[0].start_ns and stages[-1].end_ns <= root.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))


def test_outputs_are_the_same_recorded_or_not():
    dia = _tiny_dia()
    for temperature in (0.0, None):
        kw = dict(max_tokens=40, seed=5, temperature=temperature)
        codes, lengths = dia.generate_codes(TEXTS, **kw)
        with recording():
            again, again_lengths = dia.generate_codes(TEXTS, **kw)
        np.testing.assert_array_equal(codes, again)
        np.testing.assert_array_equal(lengths, again_lengths)
    model = dia.dac
    audio = (0.3 * np.random.default_rng(1).standard_normal((1, 900))).astype(np.float32)
    plain = model.forward(audio)
    with recording():
        recorded = model.forward(audio)
        decoded = model.from_codes(plain["codes"])
    assert set(plain) == set(recorded)
    for key in plain:
        assert torch.equal(plain[key], recorded[key]), key
    assert torch.equal(decoded, model.from_codes(plain["codes"]))
    assert recorded_spans()


def _snac_audio() -> np.ndarray:
    return (0.3 * np.random.default_rng(2).standard_normal((2, 900))).astype(np.float32)


@pytest.mark.parametrize("call,stages,units", [
    ("forward", ["snac.prepare", "snac.encoder", "snac.quantizer", "snac.decoder"], 12),
    ("encode", ["snac.prepare", "snac.encoder", "snac.quantizer"], 6),
    ("decode", ["snac.prepare", "snac.quantizer", "snac.decoder"], 6)])
def test_snac_calls_record_their_stages_and_units(call, stages, units):
    model = _tiny_snac()
    assert sum(isinstance(m, ResidualUnit) for m in model.modules()) == 12
    arg = model.encode(_snac_audio()) if call == "decode" else _snac_audio()
    with recording():
        getattr(model, call)(arg)
    spans = recorded_spans()
    root = _one(spans, f"snac.{call}")
    # the CPU takes the plain units: none launched kernel 2a
    assert root.parent is None and root.attrs == {"units": units, "unit_kernel_units": 0}
    assert _children(spans, root) == stages
    inner = sorted((s for s in spans if s is not root), key=lambda s: s.start_ns)
    assert root.start_ns <= inner[0].start_ns and inner[-1].end_ns <= root.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))
    assert {s.request for s in spans} == {root.id}


def test_snac_records_nothing_unrecorded_and_the_same_audio_recorded():
    model = _tiny_snac()
    plain = model.forward(_snac_audio())
    assert list(recorded_spans()) == []
    with recording():
        recorded = model.forward(_snac_audio())
    assert torch.equal(plain[0], recorded[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[1], recorded[1]))


def test_annotate_is_a_named_profiler_region():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("nc_test.region"):
            torch.ones(8) + 1
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() == "nc_test.region"] == ["nc_test.region"]
    assert list(recorded_spans()) == []
