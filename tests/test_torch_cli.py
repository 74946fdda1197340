"""The port's CLI (``neuralcodecs-torch``) against the JAX package's, on the CPU.

``build_parser()`` has the JAX parser's subcommands, options, defaults and
choices apart from two divergences, which ``test_parser_matches_jax``
names: ``--device`` on every subcommand that builds a model, and no
``bench``; Dia's ``--dtype`` defaults to ``bf16`` as in the JAX CLI. ``visualize`` gives the
JAX stats (SNR within 0.01 dB, mel difference within 1e-3) and the same PPM
headers with pixels within 1. The commands run end to end with
``--device cpu`` on tiny models: ``roundtrip`` (with diagnostics and events)
within 1 LSB of the JAX CLI's WAV on the same weights, ``compress`` raw
byte-exact to the JAX CLI's and ``--lm`` lossless, ``decompress``,
``validate``, ``zoo``, and ``tts`` (one-shot and streamed, f32 and the
default bf16) from saved exports equal to a direct ``generate``. The error
report has the JAX keys.
"""

import argparse
import json
import wave

import numpy as np
import pytest
import torch

import neuralcodecs_tpu.cli.main as jcli
import neuralcodecs_tpu_torch.cli.main as cli
from neuralcodecs_tpu.cli import visualize as jvisualize
from neuralcodecs_tpu.diagnostics import context as jcontext
from neuralcodecs_tpu_torch.cli import visualize
from neuralcodecs_tpu_torch.diagnostics import context
from neuralcodecs_tpu_torch.diagnostics.eventsource import log as event_log
from test_torch_dac import build_pair as dac_pair
from test_torch_dac import tiny_kwargs as dac_kwargs
from test_torch_dia import _dac_pair as dia_dac_pair
from test_torch_dia import build_pair as dia_pair
from test_torch_encodec import _golden_port
from test_torch_lm import _golden_lms
from test_torch_snac import build_pair as snac_pair
from test_torch_snac import tiny_kwargs as snac_kwargs

MODEL_COMMANDS = ("roundtrip", "compress", "decompress", "tts", "validate", "serve")


def _subparsers(parser: argparse.ArgumentParser) -> dict:
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required, a.nargs,
                     a.type, a.const) for a in parser._actions}


def test_parser_matches_jax_apart_from_the_divergences():
    got, want = cli.build_parser(), jcli.build_parser()
    g, w = _options(got), _options(want)
    assert g.pop("command")[3] is w.pop("command")[3] is True  # a subcommand is required
    assert g == w  # --help, --traceback
    got_sub, want_sub = _subparsers(got), _subparsers(want)
    # divergence 2: no bench until the port has its benchmark
    assert set(want_sub) - set(got_sub) == {"bench"} and set(got_sub) <= set(want_sub)
    for name, parser in got_sub.items():
        g, w = _options(parser), _options(want_sub[name])
        if name in MODEL_COMMANDS:
            # divergence 1: --device, default cuda, no CPU fallback
            assert g.pop("device") == (("--device",), "cuda", None, False, None, None, None)
        if name in ("tts", "serve"):
            # Dia's --dtype: JAX's choices and its bf16 default
            assert g["dtype"][1] == "bf16" and g["dtype"][2] == ["bf16", "f32"]
        assert g == w, name
        assert parser.get_default("fn").__name__ == want_sub[name].get_default("fn").__name__
        assert parser.get_default("operation") == want_sub[name].get_default("operation")


def test_parser_subcommands():
    parser = cli.build_parser()
    args = parser.parse_args(["roundtrip", "--input", "a.wav", "--output", "b.wav",
                              "--codec", "dac", "--device", "cpu"])
    assert args.codec == "dac" and args.device == "cpu" and args.fn is cli.cmd_roundtrip
    args = parser.parse_args(["compress", "--input", "a.wav", "--output", "b.ecdc", "--lm",
                              "--bandwidth", "6"])
    assert args.lm and args.bandwidth == 6.0 and args.device == "cuda"
    args = parser.parse_args(["tts", "--text", "[S1]x", "--output", "t.wav",
                              "--audio-prompt", "voice.wav"])
    assert args.fn is cli.cmd_tts and args.dtype == "bf16" and args.audio_prompt == "voice.wav"
    assert parser.parse_args(["interactive"]).fn is cli.cmd_interactive
    with pytest.raises(SystemExit):
        parser.parse_args(["bench"])


# ---------------------------------------------------------------- visualize


def test_visualize_matches_jax(tmp_path):
    sr = 8000
    t = np.arange(4000) / sr
    tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    noisy = (0.5 * tone + 0.01 * np.random.default_rng(0).standard_normal(4000)).astype(
        np.float32)
    got = visualize.compare_spectrograms(tone, noisy, sr, tmp_path / "port")
    want = jvisualize.compare_spectrograms(tone, noisy, sr, tmp_path / "jax")
    assert abs(got["snr_db"] - want["snr_db"]) < 0.01
    assert abs(got["mel_mean_abs_diff"] - want["mel_mean_abs_diff"]) < 1e-3
    assert got["peak_original"] == want["peak_original"]
    assert got["peak_processed"] == want["peak_processed"]
    for name in ("compare_original.ppm", "compare_processed.ppm", "compare_diff.ppm"):
        a, b = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        header = a.index(b"255\n") + 4
        assert a[:header] == b[:header] and len(a) == len(b)
        diff = np.abs(np.frombuffer(a[header:], np.uint8).astype(int)
                      - np.frombuffer(b[header:], np.uint8).astype(int))
        assert diff.max() <= 1, (name, diff.max())
    np.testing.assert_allclose(visualize.log_mel_image(tone, sr),
                               jvisualize.log_mel_image(tone, sr), atol=1e-4)
    np.testing.assert_allclose(visualize.log_mel_image(torch.from_numpy(tone), sr),
                               visualize.log_mel_image(tone, sr), atol=0)
    assert visualize.audio_stats(noisy, sr) == jvisualize.audio_stats(noisy, sr)
    visualize.save_spectrogram(tone, sr, tmp_path / "spec.ppm")
    assert (tmp_path / "spec.ppm").read_bytes().startswith(b"P6\n")


# ----------------------------------------------------------------- commands


def _write_wav(path, x: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype(np.int16).tobytes())


def _pcm(path) -> np.ndarray:
    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.int32)


def _tone(sr: int, seconds: float, freq: float = 440.0) -> np.ndarray:
    return (0.3 * np.sin(2 * np.pi * freq * np.arange(int(sr * seconds)) / sr)).astype(
        np.float32)


@pytest.fixture
def patched(monkeypatch):
    """Point both CLIs' codec loaders at given models (the JAX tests'
    pattern); the port's loader gets the device the command passed."""
    devices = []

    def use(port_model, jax_model=None):
        def load(codec, model_path, preset, device="cuda"):
            devices.append(device)
            return port_model
        monkeypatch.setattr(cli, "_load_codec", load)
        if jax_model is not None:
            monkeypatch.setattr(jcli, "_load_codec", lambda codec, path, preset: jax_model)
    use.devices = devices
    return use


@pytest.mark.parametrize("codec", ["snac", "dac"])
def test_cli_roundtrip_with_diagnostics_and_events(codec, tmp_path, capsys, patched):
    """roundtrip --diagnostics --events --spectrograms: the summary names
    the staged modules, the events file holds the three event kinds, and
    the WAV is within 1 LSB of the JAX CLI's on the same weights."""
    if codec == "snac":
        jmodel, model = snac_pair(snac_kwargs(sampling_rate=16000))
    else:
        jmodel, model = dac_pair(dac_kwargs())
    patched(model, jmodel)
    wav_in = tmp_path / "in.wav"
    _write_wav(wav_in, _tone(22050, 0.25), 22050)
    events = tmp_path / "events.jsonl"
    try:
        rc = cli.main(["roundtrip", "--codec", codec, "--input", str(wav_in),
                       "--output", str(tmp_path / "out.wav"), "--diagnostics",
                       "--events", str(events), "--dump-dir", str(tmp_path / "dump"),
                       "--spectrograms", "--device", "cpu"])
    finally:
        event_log.close()
        context.set_diagnostics(context.NullDiagnosticsContext())
    assert rc == 0 and patched.devices == ["cpu"]
    captured = capsys.readouterr()
    assert "Diagnostics summary" in captured.err
    assert f"{codec}.encode" in captured.err and f"{codec}.decode" in captured.err
    kinds = {json.loads(line)["event"] for line in events.read_text().splitlines()}
    assert {"ModuleExecution", "TensorStats"} <= kinds
    assert (tmp_path / "dump" / f"{codec}.input.npy").exists()
    assert (tmp_path / "compare_diff.ppm").exists()
    out = captured.out
    stats = json.loads(out[: out.index("}\n{") + 1])
    try:
        assert jcli.main(["roundtrip", "--codec", codec, "--input", str(wav_in),
                          "--output", str(tmp_path / "jax.wav")]) == 0
    finally:
        jcontext.set_diagnostics(jcontext.NullDiagnosticsContext())
    jstats = json.loads(capsys.readouterr().out)
    assert stats["input"] == jstats["input"]
    assert stats["output"]["samples"] == jstats["output"]["samples"]
    got, want = _pcm(tmp_path / "out.wav"), _pcm(tmp_path / "jax.wav")
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


@pytest.mark.parametrize("lm", [False, True])
def test_cli_compress_decompress(lm, tmp_path, capsys, patched):
    """compress (raw: the JAX CLI's bytes; --lm: through the golden LM set
    on the model) then decompress, on the golden's tiny Encodec."""
    from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
    from test_encodec import tiny_config

    import jax.numpy as jnp

    model, g = _golden_port()
    model.set_language_model(_golden_lms()[1])
    jmodel = JEncodec(tiny_config(), params={k[3:]: jnp.asarray(g[k]) for k in g.files
                                             if k.startswith("sd/")})
    patched(model, jmodel)
    wav_in = tmp_path / "in.wav"
    _write_wav(wav_in, _tone(16000, 0.1, 330.0), 16000)
    ecdc = tmp_path / "out.ecdc"
    flags = ["--lm"] if lm else []
    assert cli.main(["compress", "--input", str(wav_in), "--output", str(ecdc),
                     "--device", "cpu"] + flags) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bytes"] == ecdc.stat().st_size and rec["ratio"] > 1
    if not lm:
        jecdc = tmp_path / "jax.ecdc"
        assert jcli.main(["compress", "--input", str(wav_in), "--output", str(jecdc)]) == 0
        assert ecdc.read_bytes() == jecdc.read_bytes()
        capsys.readouterr()
    wav_out = tmp_path / "rec.wav"
    assert cli.main(["decompress", "--input", str(ecdc), "--output", str(wav_out),
                     "--device", "cpu"]) == 0
    direct = model.decompress(ecdc.read_bytes()).numpy()[0, 0]
    want = (np.clip(direct, -1, 1) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(_pcm(wav_out), want)


def test_cli_validate_and_zoo(capsys, patched):
    jmodel, model = snac_pair(snac_kwargs(sampling_rate=16000))
    patched(model, jmodel)
    assert cli.main(["validate", "--codec", "snac", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["validate", "--codec", "snac"]) == 0
    assert rec == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["zoo"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["zoo"]) == 0
    assert got == capsys.readouterr().out and "dia_1.6b" in got


def test_cli_tts_from_saved_exports(tmp_path, capsys):
    """tts --model <Dia export> --dac-model <DAC export> --device cpu, one
    shot and --stream: the WAVs equal a direct generate on the same weights."""
    from neuralcodecs_tpu_torch.core.export import save_pretrained
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

    dia = dia_pair()[1]
    dac = dia_dac_pair()[1]
    save_pretrained(dia, tmp_path / "dia")
    save_pretrained(dac, tmp_path / "dac")
    dia.set_dac_model(dac)
    common = ["--text", "[S1]hi", "--model", str(tmp_path / "dia"), "--dac-model",
              str(tmp_path / "dac"), "--max-tokens", "12", "--device", "cpu", "--dtype", "f32"]
    assert cli.main(["tts", "--output", str(tmp_path / "one.wav")] + common) == 0
    want = dia.generate(["[S1]hi"], max_tokens=12)[0]
    expect = tmp_path / "want.wav"
    AudioSignal(want, dia.config.sample_rate, device="cpu").write(expect)
    assert (tmp_path / "one.wav").read_bytes() == expect.read_bytes()
    assert cli.main(["tts", "--output", str(tmp_path / "stream.wav"), "--stream",
                     "--segment-tokens", "5"] + common) == 0
    chunks = [c for _, c in dia.generate_stream("[S1]hi", max_tokens=12, segment_tokens=5)]
    AudioSignal(np.concatenate(chunks), dia.config.sample_rate, device="cpu").write(expect)
    assert (tmp_path / "stream.wav").read_bytes() == expect.read_bytes()
    assert "first audio after" in capsys.readouterr().out


def _report(capsys) -> dict:
    err = capsys.readouterr().err
    return json.loads([line for line in err.strip().splitlines() if line.startswith("{")][-1])


def test_cli_error_report_matches_jax(tmp_path, capsys):
    args = ["roundtrip", "--input", str(tmp_path / "missing.wav"),
            "--output", str(tmp_path / "out.wav")]
    assert jcli.main(args) == 1
    want = _report(capsys)
    assert cli.main(args + ["--device", "cpu"]) == 1
    got = _report(capsys)
    assert got == want
    assert got.keys() == {"success", "operation", "error", "message"}
    assert got["success"] is False and got["operation"] == "encoding"


def test_cli_dia_bf16_raises_before_loading(tmp_path, capsys):
    """--dtype bf16 is a mode the port has: what raises, before any weights
    load, is the --model directory that holds no weights, and no longer the
    dtype."""
    (tmp_path / "empty-export").mkdir()
    assert cli.main(["tts", "--text", "x", "--output", str(tmp_path / "o.wav"),
                     "--model", str(tmp_path / "empty-export"), "--dtype", "bf16",
                     "--device", "cpu"]) == 1
    rec = _report(capsys)
    assert rec["error"] == "LoadError" and "No model file" in rec["message"]


@pytest.mark.parametrize("dtype_args", [[], ["--dtype", "bf16"]])
def test_cli_tts_bf16_from_a_saved_export(dtype_args, tmp_path, capsys):
    """tts with the default --dtype, and with --dtype bf16, on a tiny
    export: the Dia it builds is bf16 and the WAV it writes is a bf16 Dia's
    direct generate on the same weights."""
    from neuralcodecs_tpu_torch.core.export import save_pretrained
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal
    from neuralcodecs_tpu_torch.models.dia import Dia

    dia = dia_pair()[1]
    dac = dia_dac_pair()[1]
    save_pretrained(dia, tmp_path / "dia")
    save_pretrained(dac, tmp_path / "dac")
    built = cli._load_dia_cli(str(tmp_path / "dia"), device="cpu")
    assert built.compute_dtype == torch.bfloat16
    bf16 = Dia(dia.config, device="cpu", compute_dtype=torch.bfloat16)
    bf16.load_state_dict(dia.state_dict())
    bf16.set_dac_model(dac)
    out = tmp_path / "one.wav"
    assert cli.main(["tts", "--text", "[S1]hi", "--model", str(tmp_path / "dia"),
                     "--dac-model", str(tmp_path / "dac"), "--max-tokens", "12",
                     "--device", "cpu", "--output", str(out)] + dtype_args) == 0
    assert "wrote" in capsys.readouterr().out
    want = tmp_path / "want.wav"
    AudioSignal(bf16.generate(["[S1]hi"], max_tokens=12)[0], dia.config.sample_rate,
                device="cpu").write(want)
    assert out.read_bytes() == want.read_bytes()


def test_cli_without_a_card_does_not_fall_back(tmp_path, capsys):
    """With no --device the model goes to the card; with none present the
    command fails rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["tts", "--text", "x", "--output", str(tmp_path / "o.wav")]) == 1
    rec = _report(capsys)
    assert rec["success"] is False and not (tmp_path / "o.wav").exists()
