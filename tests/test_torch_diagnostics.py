"""The port's diagnostics against the JAX package's, on the CPU.

``TensorStats`` (NaN / Inf / outlier anomalies included), the anomaly list,
the event JSONL lines (apart from timestamps and measured times), the dumps
and the generated comparison script equal the JAX package's on the same
arrays; a logged torch tensor gives the stats of its values. ``nan_guard``
names the first module whose output is non-finite; ``trace`` writes a
Chrome trace with a span's region and the span. SNAC's and DAC's ``process_audio``
with diagnostics on log the JAX package's modules and tensors (codes equal,
audio stats within rtol 1e-4 / atol 1e-5) and return the audio of a run with
diagnostics off (DAC bit for bit; SNAC within rtol 1e-5 / atol 1e-6: its
staged decode embeds the codes where the forward adds the straight-through
residual).
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralcodecs_tpu.diagnostics import context as jcontext
from neuralcodecs_tpu.diagnostics.eventsource import log as jevent_log
from neuralcodecs_tpu_torch.diagnostics import context
from neuralcodecs_tpu_torch.diagnostics.eventsource import CodecEventSource
from neuralcodecs_tpu_torch.diagnostics.eventsource import log as event_log
from neuralcodecs_tpu_torch.diagnostics.profiler import nan_guard, span, trace
from test_torch_dac import build_pair as dac_pair
from test_torch_dac import tiny_kwargs as dac_kwargs
from test_torch_snac import build_pair as snac_pair
from test_torch_snac import tiny_kwargs as snac_kwargs

AUDIO_TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays():
    rng = np.random.default_rng(0)
    outlier = rng.standard_normal(4000).astype(np.float32)
    outlier[17] = 40.0
    return {
        "normal": rng.standard_normal((3, 50)).astype(np.float32),
        "nan": np.array([1.0, 2.0, np.nan], np.float32),
        "inf": np.array([[1.0, -np.inf], [np.inf, 0.5]], np.float32),
        "outlier": outlier,
        "constant": np.full(7, 0.25, np.float32),
        "codes": rng.integers(0, 1024, (2, 9)).astype(np.int32),
        "f64": rng.standard_normal(11),
        "empty": np.zeros((0, 4), np.float32),
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_tensor_stats_match_jax(name):
    arr = _arrays()[name]
    got_ctx, want_ctx = context.DiagnosticsContext(), jcontext.DiagnosticsContext()
    with _quiet():
        got = got_ctx.log_tensor("enc", name, torch.from_numpy(arr.copy()))
        got_np = context.DiagnosticsContext().log_tensor("enc", name, arr)
        want = want_ctx.log_tensor("enc", name, arr)
    np.testing.assert_equal(dataclasses.asdict(got), dataclasses.asdict(want))  # NaN == NaN
    np.testing.assert_equal(dataclasses.asdict(got_np), dataclasses.asdict(want))
    assert got.has_anomaly == want.has_anomaly
    assert got_ctx.anomalies == want_ctx.anomalies
    assert bool(got_ctx.anomalies) == (name in ("nan", "inf", "outlier"))


class _quiet:
    """Silence numpy's all-NaN / empty-slice warnings, as both packages see them."""

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("ignore")

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)


def _run_events(ctx_cls, source, path):
    seen = []
    source.subscribe(seen.append)
    source.open_jsonl(path)
    try:
        ctx = ctx_cls()
        with ctx.track_scope("enc"):
            pass
        for name, arr in _arrays().items():
            if arr.size:
                ctx.log_tensor("enc", name, arr)
        source.module_execution("dec", 1.5, memory_bytes=7)
    finally:
        source.unsubscribe(seen.append)
        source.close()
    return seen, [json.loads(line) for line in path.read_text().splitlines()]


def test_event_lines_equal_jax(tmp_path):
    with _quiet():
        got_seen, got = _run_events(context.DiagnosticsContext, event_log, tmp_path / "p.jsonl")
        want_seen, want = _run_events(jcontext.DiagnosticsContext, jevent_log,
                                      tmp_path / "j.jsonl")
    assert len(got) == len(got_seen) == len(want) == len(want_seen) > 5
    for g, w in zip(got, want):
        assert g.pop("ts") > 0 and w.pop("ts") > 0
        if g["event"] == "ModuleExecution" and g["module"] == "enc":
            assert g.pop("ms") >= 0 and w.pop("ms") >= 0  # measured times differ
        assert g == w
    assert {e["event"] for e in got} == {"ModuleExecution", "TensorStats", "AnomalyDetected"}


def test_event_source_disabled_is_free():
    src = CodecEventSource()
    assert not src.enabled
    src.module_execution("m", 1.0)
    src.tensor_stats("m", "t", 0.0, 1.0, "(1,)")
    src.anomaly_detected("m", "x")


def test_track_scope_summary_and_json_match_jax():
    got, want = context.DiagnosticsContext(), jcontext.DiagnosticsContext()
    for ctx in (got, want):
        for _ in range(3):
            with ctx.track_scope("snac.encode"):
                pass
        with _quiet():
            ctx.log_tensor("snac.encode", "codes_0", np.arange(6, dtype=np.int32))
            ctx.log_tensor("snac", "input", np.array([np.nan, 1.0], np.float32))

    def strip(text):
        return [line.split(" total=")[0] + line.split("ms", 2)[-1] if " total=" in line else line
                for line in text.splitlines()]

    assert strip(got.summary()) == strip(want.summary())
    a, b = json.loads(got.to_json()), json.loads(want.to_json())
    for mod in (a, b):
        for entry in mod.values():
            assert entry.pop("total_seconds") >= 0
    assert a == b
    null = context.NullDiagnosticsContext()
    assert not null.enabled and null.log_tensor("x", "y", torch.ones(3)) is None
    with null.track_scope("x"):
        pass
    assert null.modules == {}
    assert context.get_diagnostics().enabled is False


def test_compare_tensors_matches_jax():
    a = np.random.default_rng(0).standard_normal(100)
    for other in (a + 1e-7, a + 0.01, np.zeros(100), np.zeros(50)):
        got = context.compare_tensors(torch.from_numpy(a), torch.from_numpy(other), "t")
        assert got == jcontext.compare_tensors(a, other, "t")


def test_dumps_and_comparison_script(tmp_path):
    """The port's dumps hold the JAX package's arrays; its generated script
    equals the JAX one but for its name line and passes, or fails, the same
    dump directories."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal((4, 8)).astype(np.float32)
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    ctx, jctx = context.DiagnosticsContext(dump_dir=mine), jcontext.DiagnosticsContext(
        dump_dir=theirs)
    ctx.dump_tensor("enc_out", torch.from_numpy(t))
    ctx.log_tensor("codes", "stage/0", torch.arange(12, dtype=torch.int32))
    jctx.dump_tensor("enc_out", t)
    jctx.log_tensor("codes", "stage/0", np.arange(12, dtype=np.int32))
    for name in ("enc_out.npy", "codes.stage_0.npy"):
        got, want = np.load(mine / name), np.load(theirs / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    script = ctx.generate_comparison_script(tmp_path / "compare.py")
    (tmp_path / "jax").mkdir()
    jscript = jctx.generate_comparison_script(tmp_path / "jax" / "compare.py")
    assert script.read_text().replace(str(mine.resolve()), "<dump>").replace(
        "neuralcodecs_tpu_torch", "neuralcodecs_tpu") == \
        jscript.read_text().replace(str(theirs.resolve()), "<dump>")
    run = subprocess.run([sys.executable, str(script), str(theirs)],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "enc_out.npy: ok" in run.stdout
    drift = tmp_path / "drift"
    drift.mkdir()
    np.save(drift / "enc_out.npy", t + 0.01)
    run = subprocess.run([sys.executable, str(script), str(drift)],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "FAIL" in run.stdout and "MISSING" in run.stdout


# ---------------------------------------------------------------- profiler


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


def test_nan_guard_names_the_failing_module():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Identity(), torch.nn.Sequential(_Log(), torch.nn.ReLU()))
    guarded = nan_guard(net)
    ok = guarded(torch.tensor([1.0, 2.0]))
    torch.testing.assert_close(ok, torch.log(torch.tensor([1.0, 2.0])))
    with pytest.raises(ValueError, match=r"module '1\.0' \(_Log\)"):
        guarded(torch.tensor([-1.0, 2.0]))
    assert not any(m._forward_hooks for m in net.modules())  # hooks removed
    with pytest.raises(ValueError, match=r"module '1\.0' \(_Log\)"):
        nan_guard(lambda x: net(x) * 2, module=net)(torch.tensor([0.5, -2.0]))

    def bare(x):
        return torch.sqrt(x)

    with pytest.raises(ValueError, match="from test_nan_guard_names_the_failing_module"):
        nan_guard(bare)(torch.tensor([-4.0]))
    assert nan_guard(bare)(torch.tensor([4.0])).item() == 2.0


def test_nan_guard_inside_a_codec():
    """A NaN weight in one of SNAC's residual units is reported at that
    unit: it runs as one fused kernel (its plain version here), so its
    submodules' forwards never run, and it is the first module to output
    the NaN."""
    _, model = snac_pair(snac_kwargs())
    unit = model.encoder.block[1].block[0]
    weight = [p for p in unit.parameters() if p.dim() > 1][0]
    with torch.no_grad():
        weight.view(-1)[0] = float("nan")
    with pytest.raises(ValueError, match=r"module 'encoder\.block\.1\.block\.0' \(ResidualUnit\)"):
        nan_guard(model.forward, module=model)(np.zeros(2048, np.float32) + 0.1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "prof") as prof:
        with span("region") as region:
            torch.ones(64, 64) @ torch.ones(64, 64)
            region.set(rows=2)
    assert prof.trace_path.parent == tmp_path / "prof" and prof.trace_path.exists()
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    assert any(e.get("name") == "nc.region" for e in events)
    assert any(e.key == "nc.region" for e in prof.key_averages())
    # the session's spans beside its trace, the recorder cleared on entry
    assert [(s.name, s.attrs) for s in prof.spans] == [("region", {"rows": 2})]
    with trace(tmp_path / "prof") as again:
        pass
    assert list(again.spans) == []


# ------------------------------------------------------- process_audio


def _logged(ctx) -> dict:
    return {name: [(s.name, s.shape) for s in mod.tensor_stats]
            for name, mod in sorted(ctx.modules.items())}


@pytest.mark.parametrize("codec,rate", [("snac", None), ("snac", 11025), ("dac", None),
                                        ("dac", 22050)])
def test_process_audio_diagnostics_match_jax(codec, rate):
    if codec == "snac":
        jmodel, model = snac_pair(snac_kwargs())
    else:
        jmodel, model = dac_pair(dac_kwargs())
    sr = rate or model.config.sample_rate
    audio = (0.3 * np.random.default_rng(1).standard_normal(3000)).astype(np.float32)
    off = model.process_audio(audio, sr)
    ctx, jctx = context.DiagnosticsContext(), jcontext.DiagnosticsContext()
    context.set_diagnostics(ctx)
    jcontext.set_diagnostics(jctx)
    try:
        got = model.process_audio(audio, sr)
        want = jmodel.process_audio(audio, sr)
    finally:
        context.set_diagnostics(context.NullDiagnosticsContext())
        jcontext.set_diagnostics(jcontext.NullDiagnosticsContext())
    assert _logged(ctx) == _logged(jctx)
    assert ctx.modules[f"{codec}.encode"].calls == ctx.modules[f"{codec}.decode"].calls == 1
    for name, mod in ctx.modules.items():
        for s, js in zip(mod.tensor_stats, jctx.modules[name].tensor_stats):
            if "codes" in s.name:
                assert dataclasses.asdict(s) == dataclasses.asdict(js)
            else:
                np.testing.assert_allclose([s.min, s.max, s.mean, s.std],
                                           [js.min, js.max, js.mean, js.std], **AUDIO_TOL)
    assert got.shape == off.shape == np.asarray(want).shape
    if codec == "dac":
        np.testing.assert_array_equal(got, off)
    else:
        np.testing.assert_allclose(got, off, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), **AUDIO_TOL)
