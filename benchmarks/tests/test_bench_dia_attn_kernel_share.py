"""The reader of dia_attn_kernel_share on synthetic traces, built as
``test_bench_program_spans`` builds them."""

import pytest

from benchmarks.tests.test_bench_program_spans import _dac, _dia, _recorded, read
from neuralcodecs_tpu_torch.diagnostics import profiler


@pytest.mark.parametrize("kernel_steps,want", [(3, 100.0), (1, 100.0 / 3), (None, None)],
                         ids=["all", "one", "uncounted"])
def test_dia_attn_kernel_share_is_the_loops_kernel_steps_over_its_steps(monkeypatch,
                                                                       kernel_steps, want):
    # a program that does not count the kernel's steps (the parent of the
    # count) gives nothing to read
    summary, spans = _dia()
    if kernel_steps is not None:
        next(s for s in spans if s.name == "dia.loop").attrs["attn_kernel_steps"] = kernel_steps
    got = read("dia_attn_kernel_share", _recorded(monkeypatch, (summary, spans)))
    assert got == (None if want is None else pytest.approx(want))


def test_dia_attn_kernel_share_finds_nothing_without_the_programs_spans(monkeypatch):
    summary, _ = _dac()
    monkeypatch.setattr(profiler, "recorded_spans", lambda: profiler.SpanList())
    assert read("dia_attn_kernel_share", summary) is None
    # a program without the recorder (the import fails): nothing to read
    monkeypatch.delattr(profiler, "recorded_spans")
    assert read("dia_attn_kernel_share", summary) is None
