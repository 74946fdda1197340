"""neuralcodecs-torch CLI — codec round-trips, .ecdc compression, TTS, serving.

Counterpart of neuralcodecs_tpu.cli.main (the reference's interactive
examples app, NeuralCodecs.Torch.Examples/Program.cs:28-354: SNACEncodeDecode,
DACEncodeDecode, EncodecEncodeDecode, CompressDecompress, DiaTTS), exposed
as argparse subcommands:

    python -m neuralcodecs_tpu_torch.cli roundtrip --codec snac --input in.wav --output out.wav
    python -m neuralcodecs_tpu_torch.cli compress --input in.wav --output out.ecdc
    python -m neuralcodecs_tpu_torch.cli decompress --input out.ecdc --output rec.wav
    python -m neuralcodecs_tpu_torch.cli tts --text "[S1]Hello!" --output tts.wav [--audio-prompt v.wav]
    python -m neuralcodecs_tpu_torch.cli serve --codec snac --port 8799
    python -m neuralcodecs_tpu_torch.cli stream --port 8800 --input in.wav --output out.wav
    python -m neuralcodecs_tpu_torch.cli validate --codec snac --model path_or_repo
    python -m neuralcodecs_tpu_torch.cli zoo

Where it differs from the JAX CLI: every subcommand that builds a model
takes ``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, and
nothing falls back to it unasked); there is no ``bench`` subcommand until
the port has its benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np


def _load_codec(codec: str, model_path: str | None, preset: str | None,
                device: str = "cuda"):
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
    from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
    from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

    presets = {
        "snac": {"24khz": SNACConfig.snac_24khz, "32khz": SNACConfig.snac_32khz,
                 "44khz": SNACConfig.snac_44khz},
        "dac": {"44khz": DACConfig.dac_44khz, "24khz": DACConfig.dac_24khz,
                "16khz": DACConfig.dac_16khz},
        "encodec": {"24khz": EncodecConfig.encodec_24khz,
                    "48khz": EncodecConfig.encodec_48khz},
    }
    classes = {"snac": SNAC, "dac": DAC, "encodec": Encodec}
    default_preset = {"snac": "24khz", "dac": "44khz", "encodec": "24khz"}
    config = presets[codec][preset or default_preset[codec]]()
    if model_path:
        from neuralcodecs_tpu_torch.core.loader import load_model

        return load_model(codec, model_path, config, device=device).eval()
    print(f"note: no --model given; using randomly initialized {codec} "
          f"({preset or default_preset[codec]})", file=sys.stderr)
    return classes[codec](config, device=device).eval()


def _load_dia_cli(model_path: str | None, dtype: str = "bf16",
                  int8: bool = False, int4: bool = False,
                  kv_int8: bool = False, kv_dot_int8: bool = False,
                  dac_model: str | None = None, device: str = "cuda"):
    """Build the serving-ready Dia (+DAC vocoder) the tts/serve commands share."""
    import torch

    from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig

    # Reject bad flag combinations BEFORE the 1.6B checkpoint load, not after.
    if int4 and int8:
        raise SystemExit(
            "error: --int8 and --int4 are mutually exclusive; pick one "
            "weight format")
    if kv_dot_int8 and not kv_int8:
        raise SystemExit("error: --kv-dot-int8 requires --kv-int8 "
                         "(it reads the int8 cache without dequantizing)")
    # bf16 is the serving default, as in the JAX CLI
    tdtype = torch.float32 if dtype == "f32" else torch.bfloat16
    if model_path:
        from neuralcodecs_tpu_torch.core.loader import load_dia

        model = load_dia(model_path, compute_dtype=tdtype, device=device)
    else:
        print("note: no --model given; using a randomly initialized Dia "
              "(output will be noise)", file=sys.stderr)
        model = Dia(DiaConfig(), compute_dtype=tdtype, device=device)
    if int4:
        model.quantize_int4()
    elif int8:
        model.quantize_int8()
    if kv_int8:
        model.enable_int8_kv_cache()
    model.kv_dot_int8 = bool(kv_dot_int8)
    if dac_model:
        model.load_dac_model(dac_model)
    else:
        from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig

        model.set_dac_model(DAC(DACConfig(), device=device).eval())
    return model


def _host(signal, index=(0, 0)) -> np.ndarray:
    """An AudioSignal's audio at ``index`` as a numpy array."""
    return signal.audio_data[index].cpu().numpy()


def _write_wav(audio: np.ndarray, sample_rate: int, path: str) -> None:
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

    AudioSignal(audio, sample_rate, device="cpu").write(path)


def cmd_roundtrip(args) -> int:
    from neuralcodecs_tpu_torch.cli.visualize import audio_stats, compare_spectrograms
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

    diag = None
    if args.diagnostics:
        from neuralcodecs_tpu_torch.diagnostics.context import (
            DiagnosticsContext, set_diagnostics)

        diag = DiagnosticsContext(dump_dir=args.dump_dir)
        set_diagnostics(diag)
        if args.events:
            from neuralcodecs_tpu_torch.diagnostics.eventsource import log as event_log

            event_log.open_jsonl(args.events)

    model = _load_codec(args.codec, args.model, args.preset, device=args.device)
    signal = AudioSignal.load(args.input, device=args.device)
    # match the model's channel layout: multichannel codecs (Encodec-48k
    # stereo) take [C, T]; mono codecs take a mixdown (reference examples
    # do the same per codec)
    channels = getattr(model.config, "channels", 1)
    if channels <= 1:
        signal = signal.to_mono()
        audio = _host(signal)
    else:
        audio = _host(signal, 0)  # [C, T]

    start = time.perf_counter()
    out = model.process_audio(audio, signal.sample_rate)
    elapsed = time.perf_counter() - start

    if diag is not None:
        print(diag.summary(), file=sys.stderr)

    sr = model.config.sample_rate
    _write_wav(out, sr, args.output)
    mono_in = audio if audio.ndim == 1 else audio.mean(axis=0)
    mono_out = out if out.ndim == 1 else out.mean(axis=0)
    print(json.dumps({
        "input": audio_stats(mono_in, signal.sample_rate),
        "output": audio_stats(mono_out, sr),
        "elapsed_s": elapsed,
        "x_realtime": (out.shape[-1] / sr) / max(elapsed, 1e-9),
    }, indent=2))
    if args.spectrograms:
        resampled_in = _host(signal.resample(sr))
        stats = compare_spectrograms(resampled_in,
                                     out if out.ndim == 1 else out[0], sr,
                                     Path(args.output).parent)
        print(json.dumps(stats, indent=2))
    return 0


def cmd_compress(args) -> int:
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

    model = _load_codec("encodec", args.model, args.preset, device=args.device)
    signal = AudioSignal.load(args.input, device=args.device)
    if args.bandwidth:
        model.set_target_bandwidth(args.bandwidth)
    audio = _host(signal.resample(model.config.sample_rate), 0)
    if audio.shape[0] != model.config.channels:
        audio = np.broadcast_to(audio.mean(0, keepdims=True),
                                (model.config.channels, audio.shape[1]))
    blob = model.compress(audio, use_lm=args.lm, lm_batch=args.lm_batch)
    Path(args.output).write_bytes(blob)
    raw_bytes = audio.size * 2
    print(json.dumps({"bytes": len(blob), "ratio": raw_bytes / len(blob),
                      "kbps": len(blob) * 8 / 1000
                      / (audio.shape[-1] / model.config.sample_rate)}))
    return 0


def cmd_decompress(args) -> int:
    model = _load_codec("encodec", args.model, args.preset, device=args.device)
    audio = model.decompress(Path(args.input).read_bytes()).cpu().numpy()
    _write_wav(audio[0], model.config.sample_rate, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_tts(args) -> int:
    model = _load_dia_cli(args.model, dtype=args.dtype, int8=args.int8,
                          int4=args.int4, kv_int8=args.kv_int8,
                          kv_dot_int8=getattr(args, "kv_dot_int8", False),
                          dac_model=args.dac_model, device=args.device)
    if getattr(args, "stream", False):
        # incremental decode: chunks land in the output file as they are
        # generated (time-to-first-audio ~= one segment, not the whole
        # utterance); the whole-utterance slowdown resample is skipped
        kwargs = {}
        if args.audio_prompt:
            kwargs["audio_prompt_path"] = args.audio_prompt
        t0 = time.perf_counter()
        chunks = []
        for sr, chunk in model.generate_stream(
                args.text, max_tokens=args.max_tokens,
                segment_tokens=args.segment_tokens, **kwargs):
            if not chunks and len(chunk):
                print(f"first audio after {time.perf_counter() - t0:.2f}s")
            chunks.append(chunk)
        audio = np.concatenate(chunks) if chunks else np.zeros(1, np.float32)
        _write_wav(audio, model.config.sample_rate, args.output)
        print(f"wrote {args.output} "
              f"({len(audio) / model.config.sample_rate:.2f}s)")
        return 0
    gen_kwargs = {}
    if args.audio_prompt:
        gen_kwargs["audio_prompt_paths"] = [args.audio_prompt]
    audios = model.generate([args.text], max_tokens=args.max_tokens,
                            **gen_kwargs)
    _write_wav(audios[0], model.config.sample_rate, args.output)
    print(f"wrote {args.output} ({len(audios[0]) / model.config.sample_rate:.2f}s)")
    return 0


def cmd_stream(args) -> int:
    """Client for a running `serve --stream-port` server: stream a WAV
    chunk-by-chunk over one TCP session and reassemble the result. The
    client builds no model: it reads and resamples the WAV on the CPU."""
    from neuralcodecs_tpu_torch.cli.stream_serve import StreamClient
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

    cli = StreamClient(args.host, args.port, args.op, 0)
    hop, sr = cli.info["hop"], cli.info["sample_rate"]
    signal = AudioSignal.load(args.input, device="cpu").to_mono().resample(sr)
    audio = _host(signal).astype(np.float32)
    n_in = audio.size  # real (resampled) length, before hop-grid padding
    if n_in == 0:
        cli.close()
        raise ValueError(f"input {args.input} contains no audio samples")
    chunk = max(1, round(args.chunk_ms * sr / 1000 / hop)) * hop
    pad = (-audio.size) % hop
    audio = np.pad(audio, (0, pad))

    outs, walls = [], []
    for off in range(0, audio.size, chunk):
        t0 = time.perf_counter()
        raw = cli.push(audio[off: off + chunk])
        walls.append(time.perf_counter() - t0)
        outs.append(raw)
    cli.close()

    if args.op == "roundtrip":
        # trim the hop-grid zero-pad tail so output length == input length
        pcm = np.concatenate([np.frombuffer(r, "<f4") for r in outs])[:n_in]
        _write_wav(pcm, sr, args.output)
    else:  # encode: save framed codes as one [n_q, F_total] array
        import struct as _struct

        mats = []
        for r in outs:
            n_q, f = _struct.unpack(">II", r[:8])
            mats.append(np.frombuffer(r[8:], ">i4").reshape(n_q, f))
        np.save(args.output, np.concatenate(mats, axis=1).astype(np.int32))
    walls_ms = sorted(1000 * w for w in walls)
    print(json.dumps({
        "output": args.output, "op": args.op, "chunks": len(walls),
        "chunk_samples": chunk, "chunk_ms": 1000 * chunk / sr,
        "per_chunk_ms": {"p50": walls_ms[len(walls_ms) // 2],
                         "max": walls_ms[-1]},
        "x_realtime": (audio.size / sr) / max(sum(walls), 1e-9),
    }))
    return 0


def cmd_interactive(args) -> int:
    """Interactive menu (counterpart of the Spectre.Console examples app,
    NeuralCodecs.Torch.Examples/Program.cs:28-170)."""
    print("neuralcodecs interactive — choose a task:")
    print("  1) codec round-trip (SNAC/DAC/Encodec)")
    print("  2) compress WAV to .ecdc")
    print("  3) decompress .ecdc")
    print("  4) Dia text-to-speech")
    print("  5) benchmark")
    choice = input("> ").strip()
    if choice == "1":
        codec = input("codec [snac/dac/encodec] (snac)> ").strip() or "snac"
        inp = input("input wav> ").strip()
        out = input("output wav (out.wav)> ").strip() or "out.wav"
        model = input("model path or HF id (blank = random init)> ").strip() or None
        return main(["roundtrip", "--codec", codec, "--input", inp,
                     "--output", out, "--spectrograms"]
                    + (["--model", model] if model else []))
    if choice == "2":
        inp = input("input wav> ").strip()
        out = input("output .ecdc (out.ecdc)> ").strip() or "out.ecdc"
        return main(["compress", "--input", inp, "--output", out])
    if choice == "3":
        inp = input("input .ecdc> ").strip()
        out = input("output wav (rec.wav)> ").strip() or "rec.wav"
        return main(["decompress", "--input", inp, "--output", out])
    if choice == "4":
        text = input("text ([S1]Hello!)> ").strip() or "[S1]Hello!"
        out = input("output wav (tts.wav)> ").strip() or "tts.wav"
        return main(["tts", "--text", text, "--output", out])
    if choice == "5":
        print("the PyTorch port has no benchmark yet (ROADMAP.md section 1 "
              "item 1); chip_smoke.py runs and times its paths on the card")
        return 1
    print("unknown choice")
    return 1


def cmd_zoo(args) -> int:
    """List the well-known model ids (counterpart of the Examples app's
    model picker, backed by core/zoo.py)."""
    from neuralcodecs_tpu_torch.core.zoo import zoo_models

    for name in zoo_models():
        print(name)
    return 0


def cmd_validate(args) -> int:
    """Config sanity + runtime smoke round-trip on a loaded model (the
    reference's SNACValidator flow, Config/SNAC/SNACValidator.cs:21-147)."""
    from neuralcodecs_tpu_torch.core.validation import validate_config, validate_model

    model = _load_codec(args.codec, args.model, args.preset, device=args.device)
    validate_config(model.config)
    validate_model(model)
    print(json.dumps({
        "success": True,
        "codec": args.codec,
        "architecture": model.config.architecture,
        "sample_rate": model.config.sample_rate,
        "params": sum(v.numel() for v in model.state_dict().values()),
    }))
    return 0


def cmd_serve(args) -> int:
    """Serve one codec (or Dia TTS) over HTTP (see cli/serve.py)."""
    from neuralcodecs_tpu_torch.cli.serve import CodecServer

    if args.codec == "dia":
        model = _load_dia_cli(args.model, dtype=args.dtype, int8=args.int8,
                              int4=args.int4, kv_int8=args.kv_int8,
                              kv_dot_int8=getattr(args, "kv_dot_int8", False),
                              dac_model=args.dac_model, device=args.device)
        if getattr(args, "dia_kv_block", None) is not None:
            model.kv_read_block = args.dia_kv_block
    else:
        model = _load_codec(args.codec, args.model, args.preset, device=args.device)
    server = CodecServer(model, args.codec, host=args.host, port=args.port,
                         batch_window_ms=args.batch_window_ms,
                         max_batch=args.max_batch,
                         dia_token_bucket=args.dia_token_bucket)
    stream_server = None
    if getattr(args, "stream_port", None) is not None:
        if args.codec != "encodec":
            print("--stream-port requires --codec encodec (causal preset)",
                  file=sys.stderr)
            return 2
        from neuralcodecs_tpu_torch.cli.stream_serve import StreamingCodecServer

        # share the HTTP server's device lock: one device, so batched HTTP
        # forwards and streaming steps must stay mutually serialized
        stream_server = StreamingCodecServer(model, host=args.host,
                                             port=args.stream_port,
                                             device_lock=server._device_lock)
    print(f"warming up {args.codec} ...", file=sys.stderr)
    t0 = time.perf_counter()
    server.warmup()
    if stream_server is not None:
        stream_server.warmup()
        stream_server.start_background()
        print(f"streaming sessions on tcp://{args.host}:{stream_server.port} "
              f"(see cli/stream_serve.py for the wire protocol)",
              file=sys.stderr)
    print(f"warm-up took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(f"serving {args.codec} on http://{args.host}:{server.port} "
          f"(POST /roundtrip /encode /decode, GET /healthz)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
        if stream_server is not None:
            stream_server.shutdown()
    return 0


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device the model runs on (default cuda; "
                             "'cpu' runs on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="neuralcodecs-torch", description=__doc__)
    p.add_argument("--traceback", action="store_true",
                   help="re-raise errors with the full stack trace instead "
                        "of the OperationResult JSON summary")
    sub = p.add_subparsers(dest="command", required=True)

    rt = sub.add_parser("roundtrip", help="encode+decode a WAV through a codec")
    rt.add_argument("--codec", choices=["snac", "dac", "encodec"], default="snac")
    rt.add_argument("--input", required=True)
    rt.add_argument("--output", required=True)
    rt.add_argument("--model", help="weights path or HF repo id")
    rt.add_argument("--preset", help="e.g. 24khz / 44khz / 48khz")
    rt.add_argument("--spectrograms", action="store_true",
                    help="write before/after/diff spectrogram images")
    rt.add_argument("--diagnostics", action="store_true",
                    help="route per-stage tensor stats + timings through "
                         "DiagnosticsContext (summary on stderr)")
    rt.add_argument("--dump-dir", default=None,
                    help="with --diagnostics: dump logged tensors as .npy here")
    rt.add_argument("--events", default=None,
                    help="with --diagnostics: stream live events to this "
                         ".jsonl file (ETW analog)")
    _add_device(rt)
    rt.set_defaults(fn=cmd_roundtrip, operation="encoding")

    cp = sub.add_parser("compress", help="compress WAV to .ecdc")
    cp.add_argument("--input", required=True)
    cp.add_argument("--output", required=True)
    cp.add_argument("--model")
    cp.add_argument("--preset")
    cp.add_argument("--bandwidth", type=float)
    cp.add_argument("--lm", action="store_true", help="use the LM entropy coder")
    cp.add_argument("--lm-batch", type=int, default=1,
                    help="batch this many frames per LM step (segmented "
                         "streams); recorded in the header for exact decode")
    _add_device(cp)
    cp.set_defaults(fn=cmd_compress, operation="encoding")

    dc = sub.add_parser("decompress", help="decompress .ecdc to WAV")
    dc.add_argument("--input", required=True)
    dc.add_argument("--output", required=True)
    dc.add_argument("--model")
    dc.add_argument("--preset")
    _add_device(dc)
    dc.set_defaults(fn=cmd_decompress, operation="decoding")

    tts = sub.add_parser("tts", help="Dia text-to-speech")
    tts.add_argument("--text", required=True)
    tts.add_argument("--output", required=True)
    tts.add_argument("--model")
    tts.add_argument("--dac-model")
    tts.add_argument("--max-tokens", type=int, default=None)
    tts.add_argument("--audio-prompt",
                     help="WAV voice-clone prompt (DAC-encoded on the fly, "
                          "Dia.LoadAudioPrompts parity)")
    tts.add_argument("--stream", action="store_true",
                     help="segment-wise generation: audio chunks are "
                          "vocoded as tokens decode (low first-audio "
                          "latency; skips the slowdown resample)")
    tts.add_argument("--segment-tokens", type=int, default=64,
                     help="decode-loop steps per streamed segment")
    tts.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    tts.add_argument("--int8", action="store_true",
                     help="weight-only int8")
    tts.add_argument("--int4", action="store_true",
                     help="weight-only int4 with group scales")
    tts.add_argument("--kv-int8", action="store_true",
                     help="int8 decode KV cache: halves the per-step "
                          "K/V read")
    tts.add_argument("--kv-dot-int8", action="store_true",
                     help="integer attention dots against the int8 KV "
                          "cache (requires --kv-int8); only active when the "
                          "blocked KV read is on (auto at generation buffer "
                          ">= 1024; --dia-kv-block on serve) — a notice is "
                          "printed when it gates off")
    _add_device(tts)
    tts.set_defaults(fn=cmd_tts, operation="encoding")

    zo = sub.add_parser("zoo", help="list well-known model ids")
    zo.set_defaults(fn=cmd_zoo, operation="initialization")

    va = sub.add_parser("validate", help="config + smoke round-trip validation")
    va.add_argument("--codec", choices=["snac", "dac", "encodec"], default="snac")
    va.add_argument("--model", help="weights path or HF repo id")
    va.add_argument("--preset")
    _add_device(va)
    va.set_defaults(fn=cmd_validate, operation="initialization")

    sv = sub.add_parser("serve", help="serve a codec over HTTP")
    sv.add_argument("--codec", choices=["snac", "dac", "encodec", "dia"], default="snac")
    sv.add_argument("--model", help="weights path or HF repo id")
    sv.add_argument("--preset")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8799)
    sv.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                    help="Dia compute dtype (serving default bf16)")
    sv.add_argument("--int8", action="store_true",
                    help="Dia weight-only int8")
    sv.add_argument("--int4", action="store_true",
                    help="Dia weight-only int4 with group scales")
    sv.add_argument("--kv-int8", action="store_true",
                    help="Dia int8 decode KV cache: halves the per-step "
                         "K/V read")
    sv.add_argument("--kv-dot-int8", action="store_true",
                    help="Dia integer attention dots against the int8 KV "
                         "cache (requires --kv-int8)")
    sv.add_argument("--dia-kv-block", type=int, default=None,
                    help="Dia block-skipped decode KV read: read the cache "
                         "in N-sized blocks only up to the live step "
                         "(default: auto — 512 once the generation buffer "
                         "reaches 1024; 0 forces the full-cache read)")
    sv.add_argument("--dac-model", help="DAC vocoder weights for Dia")
    sv.add_argument("--batch-window-ms", type=float, default=4.0,
                    help="micro-batching window for concurrent /roundtrip "
                         "requests (0 disables batching)")
    sv.add_argument("--max-batch", type=int, default=16,
                    help="micro-batching cap per device call")
    sv.add_argument("--dia-token-bucket", type=int, default=None,
                    help="cap the Dia generation-buffer bucket (default: the "
                         "model's audio_length ceiling); a smaller bucket "
                         "shrinks the per-step KV-cache read for deployments "
                         "with a known generation ceiling, and oversize "
                         "requests fall back to the model ceiling")
    sv.add_argument("--stream-port", type=int, default=None,
                    help="also serve low-latency streaming sessions on this "
                         "TCP port (encodec causal preset only; 0 = ephemeral)")
    _add_device(sv)
    sv.set_defaults(fn=cmd_serve, operation="initialization")

    st = sub.add_parser("stream",
                        help="stream a WAV through a serve --stream-port "
                             "server (one TCP session, chunk by chunk)")
    st.add_argument("--host", default="127.0.0.1")
    st.add_argument("--port", type=int, required=True,
                    help="the server's --stream-port")
    st.add_argument("--op", choices=["roundtrip", "encode"],
                    default="roundtrip")
    st.add_argument("--input", "--in", dest="input", required=True)
    st.add_argument("--output", "--out", dest="output", required=True,
                    help="WAV for roundtrip, .npy codes for encode")
    st.add_argument("--chunk-ms", type=float, default=100.0,
                    help="target chunk duration (rounded to the model hop)")
    st.set_defaults(fn=cmd_stream, operation="encoding")

    it = sub.add_parser("interactive", help="interactive menu (Examples-app style)")
    it.set_defaults(fn=cmd_interactive)
    return p


def main(argv=None) -> int:
    from neuralcodecs_tpu_torch.core.operations import CodecOperation, OperationResult

    args = build_parser().parse_args(argv)
    operation = CodecOperation(getattr(args, "operation", "initialization"))
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        raise
    except Exception as exc:
        if getattr(args, "traceback", False) or \
                os.environ.get("NEURALCODECS_DEBUG"):
            raise
        result = OperationResult.from_error(exc)
        print(json.dumps({
            "success": False,
            "operation": operation.value,
            "error": type(exc).__name__,
            "message": result.message,
        }), file=sys.stderr)
        print("(re-run with --traceback or NEURALCODECS_DEBUG=1 for the "
              "full stack trace)", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
