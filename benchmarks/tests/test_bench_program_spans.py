"""The readers of the program's spans on synthetic traces: the device's
intervals and the benchmark's window as ``harness.TraceSummary`` holds them,
the program's spans as ``recorded_spans()`` gives them."""

from types import SimpleNamespace

import pytest

from benchmarks import harness
from neuralcodecs_tpu_torch.diagnostics import profiler

MS = 1_000_000
T0 = 1_760_000_000_000_000_000   # epoch ns, as the profiler's clock reads
STAGES = ("prepare", "encoder", "quantizer", "decoder")


def _span(name, start_ms, end_ms, *, id, parent=None, request=None, device_ms=None,
          **attrs):
    return SimpleNamespace(name=name, id=id, parent=parent, request=request or id,
                           start_ns=T0 + start_ms * MS, end_ns=T0 + end_ms * MS, attrs=attrs,
                           device_ms=device_ms)


def _summary(busy_ms):
    device = [(str(i), T0 + lo * MS, T0 + hi * MS) for i, (lo, hi) in enumerate(busy_ms)]
    return harness.TraceSummary(device, [("bench.call", T0, T0 + 100 * MS)], launches=0)


def _dia():
    """One 100 ms call: encode 0-10, prefill 10-20, a loop 20-80 of three
    steps; then a second root outside the window. The card is busy 2-18,
    30-40 and 50-75."""
    spans = [_span("dia.encode", 0, 10, id=2, parent=1, request=1, device_ms=8.0),
             _span("dia.prefill", 10, 20, id=3, parent=1, request=1, device_ms=8.5),
             _span("dia.loop", 20, 80, id=4, parent=1, request=1, device_ms=60.0,
                   replays=3, eager_steps=0),
             _span("dia.generate", 0, 90, id=1),
             _span("dia.encode", 150, 152, id=6, parent=5, request=5, device_ms=1.0),
             _span("dia.prefill", 152, 154, id=7, parent=5, request=5, device_ms=1.0),
             _span("dia.generate", 150, 160, id=5)]
    return _summary([(2, 18), (30, 40), (50, 75)]), spans


def _dac():
    """One round trip 0-90: prepare 0-10, encoder 10-30, quantizer 30-70,
    decoder 70-85. The card is busy 5-8, 12-28, 40-50, 72-84 and 95-98."""
    spans = [_span("dac.prepare", 0, 10, id=2, parent=1, request=1),
             _span("dac.encoder", 10, 30, id=3, parent=1, request=1),
             _span("dac.quantizer", 30, 70, id=4, parent=1, request=1),
             _span("dac.decoder", 70, 85, id=5, parent=1, request=1),
             _span("dac.forward", 0, 90, id=1)]
    return _summary([(5, 8), (12, 28), (40, 50), (72, 84), (95, 98)]), spans


def _recorded(monkeypatch, made):
    summary, spans = made
    monkeypatch.setattr(profiler, "recorded_spans", lambda: profiler.SpanList(spans))
    return summary


def read(name, trace):
    return harness.load_module("metrics", name).read(trace, {"calls": 1})


def test_dia_prefill_ms_sums_the_encoders_and_the_prefills_device_time(monkeypatch):
    # the second call lies outside the window
    assert read("dia_prefill_ms", _recorded(monkeypatch, _dia())) == pytest.approx(16.5)


def test_dia_replay_ms_divides_the_loops_device_time_by_its_steps(monkeypatch):
    assert read("dia_replay_ms", _recorded(monkeypatch, _dia())) == pytest.approx(60.0 / 3)


def test_dia_loop_idle_share_is_the_loops_idle_wall(monkeypatch):
    # busy 30-40 and 50-75 of the loop's 20-80; the harness sums epoch ns in
    # f64, whose step there is 256 ns
    trace = _recorded(monkeypatch, _dia())
    assert read("dia_loop_idle_share", trace) == pytest.approx(100 * (1 - 35 / 60), abs=1e-3)


def test_idle_launching_share_counts_idle_inside_the_programs_roots(monkeypatch):
    # idle 0-5, 8-12, 28-40, 50-72 and 84-90 in the round trip; not 90-95
    # and 98-100 outside it
    trace = _recorded(monkeypatch, _dac())
    want = 5 + 4 + 12 + 22 + 6
    assert read("idle_launching_share", trace) == pytest.approx(want, abs=1e-3)
    assert read("idle_launching_share.upload", trace) == pytest.approx(want, abs=1e-3)
    assert read("idle_launching_share", trace) <= read("idle_share", trace)


@pytest.mark.parametrize("stage,want", zip(STAGES, (7, 4, 30, 3)))
def test_dac_stage_idle_shares_split_the_launch_paths_idle(monkeypatch, stage, want):
    trace = _recorded(monkeypatch, _dac())
    assert read(f"dac_{stage}_idle_share", trace) == pytest.approx(want, abs=1e-3)
    # the stages and the root's 85-90 outside them make up the whole
    parts = sum(read(f"dac_{s}_idle_share", trace) for s in STAGES) + 5
    assert parts == pytest.approx(read("idle_launching_share", trace), abs=1e-3)


READERS = ("dia_prefill_ms", "dia_replay_ms", "dia_loop_idle_share", "idle_launching_share",
           *(f"dac_{s}_idle_share" for s in STAGES))


def test_the_readers_find_nothing_without_the_programs_spans(monkeypatch):
    summary, _ = _dac()
    monkeypatch.setattr(profiler, "recorded_spans", lambda: profiler.SpanList())
    for name in READERS:
        assert read(name, summary) is None
    # a program without the recorder (the import fails): nothing to read
    monkeypatch.delattr(profiler, "recorded_spans")
    for name in READERS:
        assert read(name, summary) is None
