"""The control of each cell, on the card at the cell's own size: the plain
reference one step below the configuration's precision (TF32 products for
DAC's float32, fp8-rounded weights for Dia's bf16), put in the program's
place, must fail the cell's check, while the program on the same seed
passes it; and the port's own int8 weight path, a step below Dia's bf16,
fails Dia's. ``python3 -m pytest benchmarks/tests -m card`` on the card;
skipped without one.
"""

import pytest

from benchmarks import harness

CELLS = [w.stem for w in sorted((harness.BENCH / "workloads").glob("*.json"))]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = harness.load_cell(name)
    got = harness.load_module("drivers", cell["driver"]).readings(cell, 2**31 + 101, card)
    assert all(c.passed for c in got["program"]), got["program"]
    assert not all(c.passed for c in got["control"]), got["control"]


@pytest.mark.card
def test_int8_path_fails_the_tts_check(card):
    cell = harness.load_cell("dia1.6b-bf16-tts-4x512")
    got = harness.load_module("drivers", cell["driver"]).readings(cell, 2**31 + 103, card,
                                                                   int8=True)
    assert not all(c.passed for c in got["program"]), got["program"]
