"""The SNAC cell's benchmark files on the CPU: ``arith/snac`` against a hand
count at a tiny size, the two SNAC readers on synthetic traces (built as
``test_bench_program_spans`` builds them), and whole runs of a tiny SNAC
cell, sound and with each fault of ``snac_faults.py`` planted. The tiny cell
takes its limits from the real cell's workload file, so these are the
limits the card's runs are held to."""

import json
import time

import pytest

from benchmarks import harness, snac_faults
from benchmarks.arith import snac as arith
from benchmarks.arith.peaks import HBM_BYTES_PER_S, TF32_FLOPS
from benchmarks.tests.test_bench_program_spans import T0, MS, _recorded, _span, _summary, read
from benchmarks.tests.tiny import tiny_bench
from neuralcodecs_tpu_torch.diagnostics import profiler

REAL = "snac24k-roundtrip-32x10s"
SNAC = {"source": "tiny", "architecture": "snac", "sampling_rate": 2400, "encoder_dim": 8,
        "encoder_rates": [2, 4], "latent_dim": None, "decoder_dim": 32, "decoder_rates": [4, 2],
        "attn_window_size": None, "codebook_size": 256, "codebook_dim": 4,
        "vq_strides": [4, 2, 1], "noise": True, "depthwise": True, "dtype": "float32",
        "reduced": [], "assumed": []}
CELL = {"config": "snac-tiny", "driver": "snac_roundtrip", "chips": 1, "why": "tiny",
        "traffic": {"batch": 2, "clip_seconds": 0.2, "pool": 2, "check_requests": 2},
        "traced_calls": 2}


# ------------------------------------------------------------------ arith


def test_roundtrip_flops_are_the_hand_count():
    # B = 1, 480 samples (a multiple of hop 8 x stride 4), 60 frames
    unit8, unit16 = 2 * 480 * 8 * 7 + 2 * 480 * 64, 2 * 240 * 16 * 7 + 2 * 240 * 256
    encoder = (2 * 480 * 8 * 7 + 3 * unit8 + 2 * 240 * 8 * 16 * 4 + 3 * unit16
               + 2 * 60 * 16 * 32 * 8 + 2 * 60 * 32 * 7
               + 2 * (15 + 30 + 60) * (32 * 4 + 256 * 4 + 4 * 32))
    decoder = (2 * 60 * 32 * 7 + 2 * 60 * 32 * 32
               + 2 * 60 * 32 * 16 * 8 + 2 * 240 * 16 * 16 + 3 * unit16
               + 2 * 240 * 16 * 8 * 4 + 2 * 480 * 8 * 8 + 3 * unit8
               + 2 * 480 * 8 * 7)
    assert arith.padded(SNAC, 470) == 480
    assert arith.encode_flops(SNAC, 480, 1) == encoder == 1_962_240
    assert arith.decode_flops(SNAC, 60, 1) == decoder == 2_000_640
    assert arith.roundtrip_flops(SNAC, 470, 3) == 3 * (encoder + decoder)


def test_units_and_their_bound_are_the_hand_count():
    assert arith.roundtrip_units(SNAC, 480) == [(8, 480, 1), (8, 480, 3), (8, 480, 9),
                                                (16, 240, 1), (16, 240, 3), (16, 240, 9),
                                                (16, 240, 1), (16, 240, 3), (16, 240, 9),
                                                (8, 480, 1), (8, 480, 3), (8, 480, 9)]
    # x read and out written, W1, Wd and four vectors, in f32
    assert arith.unit_bytes(8, 480, 2) == 4 * (2 * 2 * 8 * 480 + 64 + 56 + 32)
    small = max(3 * 2 * 2 * 480 * 64 / TF32_FLOPS, arith.unit_bytes(8, 480, 2) / HBM_BYTES_PER_S)
    assert arith.units_bound_s([(8, 480, 1)], 2) == pytest.approx(small)
    # at C = 512 the pointwise product bounds it, below it the bytes
    big = arith.units_bound_s([(512, 3776, 1)], 32)
    assert big == pytest.approx(3 * 2 * 32 * 3776 * 512 ** 2 / TF32_FLOPS)


# ---------------------------------------------------------------- readers


def _snac(kernel_units=(3, 3)):
    """Two round trips, 0-40 and 50-90, each a root with 3 units; the card
    busy 5-35 and 55-85."""
    spans = []
    for k, (lo, done) in enumerate(zip((0, 50), kernel_units)):
        attrs = {} if done is None else {"units": 3, "unit_kernel_units": done}
        spans += [_span("snac.encoder", lo + 2, lo + 20, id=10 * k + 2, parent=10 * k + 1,
                        request=10 * k + 1),
                  _span("snac.forward", lo, lo + 40, id=10 * k + 1, **attrs)]
    return _summary([(5, 35), (55, 85)]), spans


@pytest.mark.parametrize("kernel_units,want", [((3, 3), 100.0), ((3, 0), 50.0),
                                               ((None, None), None)],
                         ids=["all", "half", "uncounted"])
def test_snac_unit_kernel_share_is_the_roots_kernel_units_over_their_units(
        monkeypatch, kernel_units, want):
    got = read("snac_unit_kernel_share", _recorded(monkeypatch, _snac(kernel_units)))
    assert got == (None if want is None else pytest.approx(want))


def test_idle_launching_share_reads_snacs_roots(monkeypatch):
    # idle 0-5, 35-40 in the first root, 50-55, 85-90 in the second
    trace = _recorded(monkeypatch, _snac())
    assert read("idle_launching_share.snac", trace) == pytest.approx(20.0, abs=1e-3)


def test_snac_readers_find_nothing_without_the_programs_spans(monkeypatch):
    summary, _ = _snac()
    monkeypatch.setattr(profiler, "recorded_spans", lambda: profiler.SpanList())
    assert read("snac_unit_kernel_share", summary) is None
    monkeypatch.delattr(profiler, "recorded_spans")
    assert read("snac_unit_kernel_share", summary) is None


def _kernels():
    device = [("_anonymous_namespace_::depthwise_rows_float_const", T0 + 10 * MS, T0 + 20 * MS),
              ("void__anonymous_namespace_::resunit_gemm_128__false__CUtensorMap",
               T0 + 30 * MS, T0 + 40 * MS),
              ("void_cudnn::detail::dgrad_engine_float", T0 + 50 * MS, T0 + 90 * MS)]
    return harness.TraceSummary(device, [("bench.call", T0, T0 + 100 * MS)], launches=0)


@pytest.mark.parametrize("bound_s,want", [(0.005, 25.0), (0.0, None)])
def test_resunit_depthwise_roofline_is_the_bound_over_kernel_2as_time(bound_s, want):
    got = harness.load_module("metrics", "resunit_depthwise_roofline").read(
        _kernels(), {"depthwise_bound_s": bound_s})
    assert got == (None if want is None else pytest.approx(want))


def test_resunit_depthwise_roofline_finds_nothing_without_kernel_2a():
    trace = harness.TraceSummary([("void_cudnn::detail::dgrad_engine_float", T0, T0 + MS)],
                                 [("bench.call", T0, T0 + 100 * MS)], launches=0)
    got = harness.load_module("metrics", "resunit_depthwise_roofline").read(
        trace, {"depthwise_bound_s": 0.005})
    assert got is None


# ------------------------------------------------------------- whole runs


def _run(tmp_path, trace: bool = False) -> dict:
    bench = tiny_bench(tmp_path)
    (bench / "configs" / "snac-tiny.json").write_text(json.dumps(SNAC))
    real = json.loads((harness.BENCH / "workloads" / f"{REAL}.json").read_text())
    (bench / "workloads" / "tiny-snac.json").write_text(json.dumps({**CELL,
                                                                    "limits": real["limits"]}))
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    for entry in spec["end_to_end"] + spec["per_layer"]:
        if REAL in entry.get("workloads", ()):
            entry["workloads"].append("tiny-snac")
    spec_path.write_text(json.dumps(spec))
    return harness.run_cell(harness.load_cell("tiny-snac", bench), 2**31 + 5, 0.3, trace,
                            "cpu", time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    result = _run(tmp_path)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"audio_s_per_s", "peak_gb", "setup_s"}


def test_traced_run_reads_the_programs_counts(tmp_path):
    # the CPU takes the plain units: none launched kernel 2a
    result = _run(tmp_path, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["snac_unit_kernel_share"]["value"] == 0.0
    assert metrics["mfu.snac"]["value"] > 0
    assert "resunit_depthwise_roofline" not in metrics   # no device trace


@pytest.mark.parametrize("fault", snac_faults.FAULTS)
def test_snac_faults_are_caught(tmp_path, fault):
    with snac_faults.planted(fault):
        result = _run(tmp_path)
    assert not result["correct"], result["checks"]
