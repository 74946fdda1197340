"""The operations and bytes arithmetic against the figures PERF.md records.

- Kernel 2b on one 10 s stream's 24 units: 1.69 TFLOP, a 10.25 ms bound
  (3xTF32 at 495 TFLOP/s; 25.25 ms of f32 FMAs at 67).
- A DAC-44k round trip of 4 x 10 s: 8.0 TFLOP.
- Dia bf16's step at position 29, text bucket 128, 8 rows: chip_smoke.py's
  ``_dia_step_bytes`` recorded 3 028 746 240 bytes. Its rule reads a
  DenseGeneral's kernel at the compute dtype's width only where the
  state-dict key ends in ".weight", which misses the logits head and the
  cross-attention q / o projections (their modules' keys are bare
  "weight"), so it counts those 169 943 040 parameters at f32: 339 886 080
  bytes more than the step reads. This arithmetic gives 2 688 860 160.
"""

import json
import math
from pathlib import Path

import pytest

from benchmarks.arith import dac, dia
from benchmarks.arith.peaks import F32_FLOPS, TF32_FLOPS, bound

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
DAC = json.loads((CONFIGS / "dac-44k.json").read_text())
DIA = json.loads((CONFIGS / "dia-1.6b-bf16.json").read_text())
TEN_S = 441_000


def test_dense_units_of_one_ten_second_stream():
    units = dac.roundtrip_units(DAC, TEN_S)
    assert len(units) == 24
    assert dac.padded(DAC, TEN_S) == 862 * 512
    flops = sum(dac.unit_flops(c, t, 1) for c, t, _ in units)
    assert flops == pytest.approx(1.69e12, rel=3e-3)
    assert dac.units_bound_s(units, 1) * 1e3 == pytest.approx(10.25, abs=0.005)
    assert bound(flops, 0, F32_FLOPS)["bound_s"] * 1e3 == pytest.approx(25.25, abs=0.01)


def test_unit_shapes_follow_the_strides():
    t = dac.padded(DAC, TEN_S)
    enc = dac.encoder_units(DAC, t)
    dec = dac.decoder_units(DAC, t // 512)
    assert [(c, n) for c, n, _ in enc[::3]] == [(64, t), (128, t // 2), (256, t // 8),
                                                (512, t // 64)]
    assert [(c, n) for c, n, _ in dec[::3]] == [(768, t // 64), (384, t // 8), (192, t // 2),
                                                (96, t)]
    assert [d for _, _, d in enc[:3]] == [1, 3, 9]


def test_roundtrip_of_the_served_batch():
    assert dac.roundtrip_flops(DAC, TEN_S, 4) == pytest.approx(8.0e12, rel=0.01)
    # the decode of codes adds the stages' out_proj only
    f = 862
    assert dac.decode_flops(DAC, f, 4, from_codes=True) - dac.decode_flops(DAC, f, 4) == \
        9 * 2.0 * 4 * f * 8 * 1024


def test_dense_units_are_bound_by_operations():
    for c, t, _ in dac.roundtrip_units(DAC, TEN_S):
        b = bound(3 * dac.unit_flops(c, t, 1), dac.unit_bytes(c, t, 1), TF32_FLOPS)
        assert b["bound_by"] == "operations"


def test_dia_step_bytes_and_the_recorded_figure():
    got = dia.step_bytes(DIA, rows=8, text_len=128, live=29)
    assert got == 2_688_860_160
    missed = dia.logits_params(DIA) + DIA["decoder"]["n_layer"] * 2 * 2048 * 16 * 128
    assert missed == 169_943_040
    assert got + 2 * missed == 3_028_746_240


def test_dia_parameters_a_step_and_in_all():
    from benchmarks.reference import dia as ref

    total = sum(math.prod(s) for s in ref.param_shapes(DIA).values())
    assert total == DIA["parameters"] == 1_611_160_576
    assert dia.step_params(DIA) == 1_264_656_384
    # a step of 8 rows reading 512 self positions and the 256 text bucket:
    # the projections, then 18 layers x 4 x 8 x 2048 x (512 + 256)
    assert dia.step_flops(DIA, 8, 256, 512) == 2 * 1_264_656_384 * 8 + 905_969_664


def test_dac_parameters():
    from benchmarks.reference import dac as ref

    assert sum(math.prod(s) for s in ref.param_shapes(DAC).values()) == DAC["parameters"]
