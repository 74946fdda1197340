"""The harness on the CPU: its files found by name, BENCHMARK.json within the
contract's limits, the metric readers on a synthetic trace, tiny cells run
end to end, and no forbidden module loaded."""

import json
import re
import subprocess
import sys
import time

import pytest

from benchmarks import harness
from benchmarks.tests.tiny import CELLS, SECONDS, tiny_bench

BENCH = harness.BENCH
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def test_benchmark_json_has_the_contracts_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmarks"]
    assert SPEC["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                    and "\t" not in entry[key]
    for entry in SPEC["workloads"]:
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)
    for entry in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_.-]+$", path.name), path


def test_every_cell_names_files_that_exist():
    assert sorted(w["name"] for w in SPEC["workloads"]) == WORKLOADS
    configs = {c["name"]: c for c in SPEC["configs"]}
    for entry in SPEC["workloads"]:
        cell = harness.load_cell(entry["name"])
        assert cell["config"] == entry["config"] and cell["chips"] == entry["chips"]
        assert configs[cell["config"]]["file"] == f"benchmarks/configs/{cell['config']}.json"
        assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
        e2e, per_layer = harness.cell_metrics(cell)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and per_layer
        for m in per_layer:
            assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()
            assert m["moves"] in [e["name"] for e in e2e]


def test_every_metric_names_cells_that_exist():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    readers = {p.stem for p in (BENCH / "metrics").glob("*.py") if p.stem != "__init__"}
    # a quantity split by the end-to-end metric its cells report shares a reader
    assert {m["name"].split(".")[0] for m in SPEC["per_layer"]} == readers


def test_a_dropped_workload_is_found(tmp_path):
    bench = tiny_bench(tmp_path)
    extra = dict(CELLS["tiny-dac"], traffic=dict(CELLS["tiny-dac"]["traffic"], batch=1))
    (bench / "workloads" / "dropped-in.json").write_text(json.dumps(extra))
    cell = harness.load_cell("dropped-in", bench)
    assert cell["config_data"]["encoder_dim"] == 8
    result = harness.run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] and result["attempted"] >= 1


def _synthetic():
    ms = 1_000_000
    spans = [("bench.call", 0, 100 * ms), ("bench.generate_codes", 0, 80 * ms),
             ("bench.vocode", 85 * ms, 95 * ms), ("bench.call", 100 * ms, 200 * ms)]
    device = [("void resunit_gemm<128, true>(CUtensorMap_st)", 10 * ms, 30 * ms),
              ("snake_rows(float const*, float const*, float*, int, int)", 25 * ms, 40 * ms),
              ("ampere_sgemm", 50 * ms, 60 * ms), ("Memcpy DtoH", 150 * ms, 190 * ms),
              ("outside", 250 * ms, 260 * ms)]
    return harness.TraceSummary(device, spans, launches=30)


def test_metric_readers_on_a_synthetic_trace():
    trace = _synthetic()
    assert trace.window_s == pytest.approx(0.2)
    assert trace.busy_s() == pytest.approx(0.030 + 0.010 + 0.040)
    ctx = {"calls": 2, "steps": 40, "flops": 1e12, "peak_flops": 1e14, "resunit_bound_s": 0.015}

    def read(name):
        return harness.load_module("metrics", name).read(trace, ctx)

    assert read("idle_share") == pytest.approx(60.0)
    assert read("launches_per_call") == 15
    assert read("dia_step_ms") == pytest.approx(2.0)
    # busy inside generate_codes (0-80 ms): 10-40 and 50-60
    assert read("dia_step_device_ms") == pytest.approx(1.0)
    assert read("vocode_share") == pytest.approx(5.0)
    assert read("mfu") == pytest.approx(5.0)
    assert read("resunit_dense_roofline") == pytest.approx(100 * 0.015 / 0.035)
    top = dict(trace.top_ops())
    assert top["Memcpy DtoH"] == pytest.approx(0.04)
    gaps = dict(trace.idle_gaps())
    # 0-10, 40-50 and 60-80 in generate_codes; 80-85 and 95-100 in the
    # first call; 85-95 in vocode; 100-150 and 190-200 in the second call
    assert gaps["bench.generate_codes"] == pytest.approx(0.040)
    assert gaps["bench.call"] == pytest.approx(0.010 + 0.060)
    assert gaps["bench.vocode"] == pytest.approx(0.010)


def test_readers_find_nothing_in_an_empty_trace():
    trace = harness.TraceSummary([], [("bench.call", 0, 10)], launches=0)
    for m in SPEC["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read(trace, {"calls": 1}) is None


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cells_run_end_to_end(tmp_path, name, trace):
    bench = tiny_bench(tmp_path)
    result = harness.run_cell(harness.load_cell(name, bench), 2**31 + 11, SECONDS[name], trace,
                              "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]
    else:
        assert {"peak_gb", "setup_s"} <= set(result["metrics"])
        assert any(m.split(".")[0] == "audio_s_per_s" for m in result["metrics"])


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_forbidden_module_is_loaded():
    loaded = _loaded("from benchmarks import harness, traffic\n"
                     "from benchmarks.reference import dac, dia\n"
                     "for d in ('codec_roundtrip', 'tts_generate'):\n"
                     "    harness.load_module('drivers', d)\n"
                     "import neuralcodecs_tpu_torch.models.dac, neuralcodecs_tpu_torch.models.dia")
    assert not loaded & set(harness.FORBIDDEN)
    assert "neuralcodecs_tpu_torch" in loaded   # compared as whole names


def test_references_load_nothing_of_the_program():
    loaded = _loaded("from benchmarks.reference import dac, dia\n"
                     "from benchmarks.arith import dac as a, dia as b, peaks")
    assert not loaded & {*harness.FORBIDDEN, "neuralcodecs_tpu_torch"}
