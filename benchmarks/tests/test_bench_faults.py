"""Whole runs of the tiny cells on the CPU with the timed path broken
underneath: each fault the cell can have must turn ``correct`` false, and
the unbroken run must stay correct. The tiny cells take their limits from
the real cells' workload files, so these are the limits the card's runs
are held to.

Faults (``benchmarks/faults.py``): an answer altered where it is produced
(an RVQ stage's codes of one clip, a clip's audio, a sampled token, the
vocoder's audio); half of the batch left out (the first half's answers
given to the second half); a decode step that returns its state unchanged;
the sampler's top-k and top-p filter left out, its temperature left out,
its noise drawn once for every step. A one-chip cell has no exchange
between chips to leave out. The temperature left out (1.2 -> 1) is read at
the cell's own size on the card only (``control.py --fault``): a tiny
call's 750 sampled tokens move its z-score to 6-7, under the cell's limit.
"""

import json
import time

import pytest

from benchmarks import faults, harness
from benchmarks.tests.tiny import LIKE, SECONDS, tiny_bench


def _run(tmp_path, name: str) -> dict:
    bench = tiny_bench(tmp_path)
    real = json.loads((harness.BENCH / "workloads" / f"{LIKE[name]}.json").read_text())
    cell = harness.load_cell(name, bench)
    cell["limits"] = real["limits"]
    return harness.run_cell(cell, 2**31 + 3, SECONDS[name], False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["tiny-dac", "tiny-ragged", "tiny-dia"])
def test_sound_runs_are_correct(tmp_path, name):
    result = _run(tmp_path, name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.CODEC)
def test_codec_faults_are_caught(tmp_path, fault):
    with faults.planted("codec", fault):
        result = _run(tmp_path, "tiny-dac")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [f for f in faults.TTS if f != "no_temperature"])
def test_tts_faults_are_caught(tmp_path, fault):
    with faults.planted("tts", fault):
        result = _run(tmp_path, "tiny-dia")
    assert not result["correct"], result["checks"]


def test_a_forbidden_module_withholds_the_result(tmp_path, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert _run(tmp_path, "tiny-dac") is None
