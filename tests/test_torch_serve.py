"""The port's HTTP serving surface against the JAX package's, on the CPU.

The host helpers (WAV I/O, channel adaptation, the streaming WAV header,
the .ecdc header peek, the metrics) must equal the JAX ones byte for byte.
Port servers run tiny SNAC, DAC and Encodec models holding the weights of
seeded JAX models (``from_jax_params``; Encodec the ``ecdc_golden.npz``
weights) on ``127.0.0.1:0``:

- ``/roundtrip`` and ``/decode`` replies are within 1 LSB (of 16-bit PCM)
  of ``_array_to_wav`` of the JAX model's output; ``/encode`` codes equal
  the JAX model's;
- micro-batched replies equal the serial server's bit for bit;
- ``/compress`` gives the JAX package's ``.ecdc`` (raw) and ``.dac`` bytes;
- error statuses and JSON bodies equal a JAX server's for the same request;
- a tiny Dia's ``/tts`` (single, batched ``texts``, micro-batched singles)
  and ``/tts/stream`` equal the port's direct ``generate`` (which
  ``tests/test_torch_dia.py`` holds to JAX), bit for bit;
- the handler and batcher threads run the models with autograd off.
"""

import base64
import concurrent.futures
import http.client
import io
import json
import time
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralcodecs_tpu.cli import serve as jserve
from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu_torch.cli import serve
from neuralcodecs_tpu_torch.cli.serve import CodecServer
from test_encodec import tiny_config as encodec_tiny_config
from test_torch_dac import build_pair as dac_pair
from test_torch_dac import tiny_kwargs as dac_kwargs
from test_torch_dia import _dac_pair as dia_dac_pair
from test_torch_dia import build_pair as dia_pair
from test_torch_encodec import GOLDEN as ECDC_GOLDEN
from test_torch_encodec import _golden_port
from test_torch_lm import _golden_lms
from test_torch_snac import build_pair as snac_pair
from test_torch_snac import tiny_kwargs as snac_kwargs

LSB = 1  # 16-bit PCM steps between a port reply and the JAX model's output


# ----------------------------------------------------------------- helpers


def _post(port: int, path: str, body: bytes, headers=None, timeout: float = 120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _metrics(port: int, route: str, count: int) -> dict:
    """GET /metrics once ``route`` has recorded ``count`` requests: a handler
    records its request after the reply is out, so a client can get there
    first."""
    deadline = time.monotonic() + 30
    while True:
        status, m = _get(port, "/metrics")
        if m["routes"].get(route, {}).get("count") == count or time.monotonic() > deadline:
            return m


def _concurrent(port: int, path: str, bodies: list) -> list:
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        return list(pool.map(lambda b: _post(port, path, b)[:2], bodies))


def _pcm(wav_bytes: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(wav_bytes), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.int32)


def _assert_within_lsb(got: bytes, want: bytes) -> None:
    """Equal WAV headers, PCM within LSB steps."""
    assert got[:44] == want[:44]
    diff = np.abs(_pcm(got) - _pcm(want))
    assert diff.max() <= LSB, diff.max()


def _audio(n: int, channels: int = 1, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal((channels, n))).astype(np.float32)


class _Serving:
    """A started server, shut down on exit."""

    def __init__(self, server):
        self.server = server

    def __enter__(self):
        self.server.start_background()
        return self.server

    def __exit__(self, *exc):
        self.server.shutdown()


# ------------------------------------------------------------ host helpers


WAV_CASES = {
    "mono-16k": (1, 16000, 0.3),
    "stereo-8k": (2, 8000, 0.3),
    "clipping-24k": (1, 24000, 1.7),  # samples beyond full scale clip
}


@pytest.mark.parametrize("name", list(WAV_CASES))
def test_wav_helpers_match_jax(name):
    channels, sr, scale = WAV_CASES[name]
    audio = _audio(999, channels) / 0.3 * scale
    wav = serve._array_to_wav(audio, sr)
    assert wav == jserve._array_to_wav(audio, sr)
    assert serve._array_to_wav(audio[0], sr) == jserve._array_to_wav(audio[0], sr)
    got, got_sr = serve._wav_to_array(wav)
    want, want_sr = jserve._wav_to_array(wav)
    assert got_sr == want_sr == sr and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for want_ch in (1, 2, 3):
        np.testing.assert_array_equal(serve._adapt_channels(got, want_ch),
                                      jserve._adapt_channels(want, want_ch))
    assert serve._streaming_wav_header(sr, channels) == jserve._streaming_wav_header(sr, channels)
    assert serve._streaming_wav_header(sr) == jserve._streaming_wav_header(sr)


@pytest.mark.parametrize("blob", ["blob_lm", "blob_raw", "garbage"])
def test_ecdc_needs_lm_matches_jax(blob):
    g = np.load(ECDC_GOLDEN)
    data = g[blob].tobytes() if blob in g.files else b"ECDC\x00\xff\xff"
    assert serve._ecdc_needs_lm(data) == jserve._ecdc_needs_lm(data)
    assert serve._ecdc_needs_lm(data) == (blob == "blob_lm")


def test_limits_and_metrics_match_jax():
    assert serve.MAX_BODY_BYTES == jserve.MAX_BODY_BYTES
    assert serve.MAX_SERVE_LM_BATCH == jserve.MAX_SERVE_LM_BATCH
    assert serve._Metrics.KNOWN_ROUTES == jserve._Metrics.KNOWN_ROUTES
    got, want = serve._Metrics(), jserve._Metrics()
    for i, route in enumerate(["/roundtrip", "/encode", "/roundtrip", "/x", "/tts"] * 3):
        got.record(route, 0.001 * i, i % 4 != 0)
        want.record(route, 0.001 * i, i % 4 != 0)

    class Batcher:
        observed_batches = [4, 1, 2]

    a, b = got.snapshot(Batcher()), want.snapshot(Batcher())
    a.pop("uptime_s"), b.pop("uptime_s")
    assert a == b and "<other>" in a["routes"]


# ------------------------------------------------------------ codec servers


@pytest.fixture(scope="module")
def codecs():
    """codec -> (JAX model, port model, sample rate, channels)."""
    jsnac, snac = snac_pair(snac_kwargs(sampling_rate=16000, encoder_dim=8, decoder_dim=32,
                                        codebook_size=32, codebook_dim=4))
    jdac, dac = dac_pair(dac_kwargs(encoder_dim=8, encoder_rates=[2, 2], decoder_dim=32,
                                    decoder_rates=[2, 2], codebook_size=64))
    enc, g = _golden_port()
    params = {k[3:]: jnp.asarray(g[k]) for k in g.files if k.startswith("sd/")}
    jenc = JEncodec(encodec_tiny_config(), params=params)
    return {"snac": (jsnac, snac), "dac": (jdac, dac), "encodec": (jenc, enc)}


def _jax_roundtrip(codec: str, jmodel, x: np.ndarray) -> np.ndarray:
    if codec == "encodec":
        return np.asarray(jmodel.forward(x))[0]
    return np.asarray(jmodel.process_audio(x[0], jmodel.config.sample_rate))


def _jax_codes(codec: str, jmodel, x: np.ndarray):
    if codec == "encodec":
        return [np.asarray(f.codes).tolist() for f in jmodel.encode(x)]
    if codec == "dac":
        return np.asarray(jmodel.encode(x[0])[1]).tolist()
    return [np.asarray(c).tolist() for c in jmodel.encode(x[0])]


def _jax_decode(codec: str, jmodel, codes) -> np.ndarray:
    if codec == "encodec":
        from neuralcodecs_tpu.models.encodec.model import EncodedFrame

        return np.asarray(jmodel.decode([EncodedFrame(jnp.asarray(c, jnp.int32), None)
                                         for c in codes]))[0]
    if codec == "dac":
        return np.asarray(jmodel.from_codes(np.asarray(codes, np.int32)))[0]
    return np.asarray(jmodel.decode([np.asarray(c, np.int32) for c in codes]))[0]


def _poison(codes):
    """The codes with their first entry out of any codebook's range."""
    codes = json.loads(json.dumps(codes))
    leaf = codes
    while isinstance(leaf[0], list):
        leaf = leaf[0]
    leaf[0] = 10 ** 6
    return codes


@pytest.mark.parametrize("codec", ["snac", "dac", "encodec"])
def test_roundtrip_encode_decode_match_jax(codecs, codec):
    jmodel, model = codecs[codec]
    sr = model.config.sample_rate
    x = _audio(2000, seed=1)
    body = serve._array_to_wav(x, sr)
    x = serve._wav_to_array(body)[0]  # what the server sees
    with _Serving(CodecServer(model, codec, port=0, batch_window_ms=0)) as srv:
        assert _get(srv.port, "/healthz") == (200, {"status": "ok", "codec": codec,
                                                     "sample_rate": sr})
        status, wav, _ = _post(srv.port, "/roundtrip", body)
        assert status == 200
        _assert_within_lsb(wav, serve._array_to_wav(_jax_roundtrip(codec, jmodel, x), sr))
        status, enc, _ = _post(srv.port, "/encode", body)
        assert status == 200
        enc = json.loads(enc)
        assert enc["codes"] == _jax_codes(codec, jmodel, x), "codes must equal JAX's"
        assert enc["scales"] is None and enc["sample_rate"] == sr
        status, dec, _ = _post(srv.port, "/decode", json.dumps({"codes": enc["codes"]}).encode())
        assert status == 200
        _assert_within_lsb(dec, serve._array_to_wav(_jax_decode(codec, jmodel, enc["codes"]), sr))
        status, err, _ = _post(srv.port, "/decode", json.dumps(
            {"codes": _poison(enc["codes"])}).encode())
        assert status == 400 and b"codes must be in" in err


@pytest.mark.parametrize("codec", ["snac", "dac", "encodec"])
def test_microbatched_replies(codecs, codec):
    """Four concurrent equal-length requests coalesce into one batch-4
    forward: each reply equals, bit for bit, its row of a direct
    ``model.forward`` of the batch the batcher stacked, and the serial
    server's reply within 1 LSB (the CPU's conv library sums a batch of 4 in
    another order than a batch of 1). A request at a foreign rate is
    resampled in its handler thread and equals the serial reply."""
    _, model = codecs[codec]
    sr = model.config.sample_rate
    bodies = [serve._array_to_wav(_audio(1600, seed=10 + i), sr) for i in range(4)]
    foreign = serve._array_to_wav(_audio(1100, seed=20), 11025)
    # the window closes as soon as the fourth request is in
    batched = CodecServer(model, codec, port=0, batch_window_ms=1000, max_batch=4)
    serial = CodecServer(model, codec, port=0, batch_window_ms=0)
    batched.warmup(lengths_s=(0.1,))  # its batch runs in the batcher's thread, uncounted
    stacked = []
    forward_batch = batched._forward_batch
    batched._forward_batch = lambda x: stacked.append(x.clone()) or forward_batch(x)
    with _Serving(batched), _Serving(serial):
        got = _concurrent(batched.port, "/roundtrip", bodies)
        assert list(batched.batcher.observed_batches) == [4]
        got_foreign = _post(batched.port, "/roundtrip", foreign)[:2]
        want = [_post(serial.port, "/roundtrip", b)[:2] for b in bodies]
        want_foreign = _post(serial.port, "/roundtrip", foreign)[:2]
        m = _metrics(batched.port, "/roundtrip", 5)
    assert [s for s, _ in got + want] == [200] * 8
    assert got_foreign == want_foreign and got_foreign[0] == 200
    assert m["routes"]["/roundtrip"]["count"] == 5
    assert m["batcher"] == {"batches": 2, "mean_batch": 2.5, "max_batch_seen": 4}
    with torch.no_grad():
        rows = forward_batch(stacked[0]).numpy()
    for body, (_, wav), (_, serial_wav) in zip(bodies, got, want):
        x = serve._wav_to_array(body)[0]
        x = x if codec == "encodec" else x[0]
        (i,) = [i for i in range(4) if np.array_equal(stacked[0][i].numpy(), x)]
        assert wav == serve._array_to_wav(rows[i], sr)
        _assert_within_lsb(wav, serial_wav)


def test_compress_decompress_byte_exact(codecs):
    """Encodec's raw .ecdc and DAC's .dac from the server equal the JAX
    package's bytes; /decompress equals the direct decode."""
    jenc, enc = codecs["encodec"]
    jdac, dac = codecs["dac"]
    x = _audio(2000, seed=2)
    for codec, jmodel, model in (("encodec", jenc, enc), ("dac", jdac, dac)):
        sr = model.config.sample_rate
        body = serve._array_to_wav(x, sr)
        xs = serve._wav_to_array(body)[0]
        with _Serving(CodecServer(model, codec, port=0, batch_window_ms=0)) as srv:
            status, blob, _ = _post(srv.port, "/compress", body)
            assert status == 200
            if codec == "encodec":
                assert blob == jmodel.compress(xs)
                direct = model.decompress(blob).numpy()[0]
            else:
                from neuralcodecs_tpu.models.dac.dacfile import dac_file_bytes

                assert blob == dac_file_bytes([np.asarray(jmodel.encode(xs[0])[1])],
                                              jmodel.config)
                direct = dac.from_codes(dac.encode(xs[0])[1]).numpy()
            status, wav, _ = _post(srv.port, "/decompress?fmt=wav", blob)
            assert status == 200 and wav == serve._array_to_wav(direct[0], sr)


def test_compress_lm_route(codecs):
    """?lm=1 / ?lm_batch=N code with the model's LM (the golden's, set on
    the model); the bytes equal a direct compress, and /decompress resolves
    the LM from the header and equals the direct decode."""
    _, enc = codecs["encodec"]
    enc.set_language_model(_golden_lms()[1])
    sr = enc.config.sample_rate
    body = serve._array_to_wav(_audio(1200, seed=3), sr)
    xs = serve._wav_to_array(body)[0]
    with _Serving(CodecServer(enc, "encodec", port=0, batch_window_ms=0)) as srv:
        for query, lm_batch in (("?lm=1", 1), ("?lm=true&lm_batch=4", 4)):
            status, blob, _ = _post(srv.port, "/compress" + query, body)
            assert status == 200
            assert blob == enc.compress(xs, use_lm=True, lm_batch=lm_batch)
            status, wav, _ = _post(srv.port, "/decompress", blob)
            assert status == 200
            assert wav == serve._array_to_wav(enc.decompress(blob).numpy()[0, 0], sr)


# ------------------------------------------------------------------- errors


@pytest.fixture(scope="module")
def jax_servers(codecs):
    """JAX servers of the same tiny models (for their error replies)."""
    from neuralcodecs_tpu.models.dac import DAC as JDAC
    from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
    from test_torch_dia import tiny_config as dia_tiny_config

    from neuralcodecs_tpu.models.dia import Dia as JDia

    jdia = JDia(dia_tiny_config(), seed=0)
    jdia.set_dac_model(JDAC(JDACConfig(encoder_dim=8, encoder_rates=[2, 2], decoder_dim=32,
                                       decoder_rates=[2, 2], n_codebooks=3,
                                       codebook_size=1024, codebook_dim=4,
                                       sample_rate=44100)))
    servers = {name: jserve.CodecServer(m, name, port=0, batch_window_ms=0)
               for name, m in (("snac", codecs["snac"][0]), ("dac", codecs["dac"][0]),
                               ("encodec", codecs["encodec"][0]), ("dia", jdia))}
    for s in servers.values():
        s.start_background()
    yield servers
    for s in servers.values():
        s.shutdown()


def _port_dia():
    dia = dia_pair()[1]
    dia.set_dac_model(dia_dac_pair()[1])
    return dia


ERROR_CASES = {
    "bad-wav": ("snac", "/roundtrip", b"not a wav file", None),
    "bad-wav-encode": ("dac", "/encode", b"RIFF....WAVEfmt ", None),
    "bad-json": ("snac", "/decode", b"{ bad json", None),
    "missing-codes": ("snac", "/decode", b"{}", None),
    "oversize": ("snac", "/roundtrip", b"x" * 16,
                 {"Content-Length": str(serve.MAX_BODY_BYTES + 1)}),
    "unknown-route": ("snac", "/nothing", b"{}", None),
    "lm-batch-0": ("encodec", "/compress?lm=1&lm_batch=0", b"x", None),
    "lm-batch-huge": ("encodec", "/compress?lm=1&lm_batch=1000000000", b"x", None),
    "bad-ecdc": ("encodec", "/decompress", b"not an ecdc stream", None),
    "bad-dac": ("dac", "/decompress", b"not a dac artifact", None),
    "texts-empty": ("dia", "/tts", json.dumps({"texts": []}).encode(), None),
    "texts-string": ("dia", "/tts", json.dumps({"texts": "[S1]hi"}).encode(), None),
    "text-not-str": ("dia", "/tts/stream", json.dumps({"text": 5}).encode(), None),
    "segment-range": ("dia", "/tts/stream",
                      json.dumps({"text": "[S1]hi", "segment_tokens": 5000}).encode(), None),
    "no-text": ("dia", "/tts", b"{}", None),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_replies_match_jax(codecs, jax_servers, case):
    codec, path, body, headers = ERROR_CASES[case]
    model = _port_dia() if codec == "dia" else codecs[codec][1]
    with _Serving(CodecServer(model, codec, port=0, batch_window_ms=0)) as srv:
        got = _post(srv.port, path, body, headers)
    want = _post(jax_servers[codec].port, path, body, headers)
    assert got[0] == want[0] and got[0] in (400, 404, 413)
    assert got[1] == want[1]
    assert got[2].get("Connection") == want[2].get("Connection")


# ---------------------------------------------------------------------- Dia


class _Recorder:
    """Wraps a model method: records each call's arguments and whether
    autograd was off in the calling thread."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, torch.is_inference_mode_enabled()))
        return out


def test_dia_tts_routes_equal_generate():
    dia = _port_dia()
    bucket = 16
    kw = dict(max_tokens=12, pad_tokens_to=bucket)
    sr = dia.config.sample_rate
    with _Serving(CodecServer(dia, "dia", port=0, batch_window_ms=0,
                              dia_token_bucket=bucket)) as srv:
        status, wav, _ = _post(srv.port, "/tts", json.dumps(
            {"text": "[S1]hi", "max_tokens": 12}).encode())
        assert status == 200
        assert wav == serve._array_to_wav(dia.generate(["[S1]hi"], **kw)[0], sr)
        texts = ["[S1]hello there", "[S2]ok", "[S1]third"]
        status, body, _ = _post(srv.port, "/tts", json.dumps(
            {"texts": texts, "max_tokens": 12}).encode())
        assert status == 200
        payload = json.loads(body)
        assert payload["sample_rate"] == sr
        want = dia.generate(texts, **kw)
        assert [base64.b64decode(b) for b in payload["wavs_b64"]] == \
            [serve._array_to_wav(a, sr) for a in want]
        status, blob, headers = _post(srv.port, "/tts/stream", json.dumps(
            {"text": "[S1]hi", "max_tokens": 12, "segment_tokens": 5}).encode())
        assert status == 200 and headers["X-Sample-Rate"] == str(sr)
        assert blob[:44] == serve._streaming_wav_header(sr)
        chunks = [c for _, c in dia.generate_stream("[S1]hi", segment_tokens=5, seed=0, **kw)]
        want_pcm = b"".join((np.clip(c, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                            for c in chunks)
        assert blob[44:] == want_pcm and len(want_pcm) > 0


def test_dia_microbatched_singles_equal_generate():
    """Four concurrent single-text requests coalesce into one generate; each
    reply equals a direct generate of the four texts in the order the
    batcher stacked them (a row's noise follows its slot); a request with
    another max_tokens runs as a group of its own."""
    dia = _port_dia()
    rec = _Recorder(dia.generate)
    dia.generate = rec
    texts = [f"[S1]request {i}" for i in range(4)]
    server = CodecServer(dia, "dia", port=0, batch_window_ms=1000, max_batch=4,
                         dia_token_bucket=16)
    server.warmup()
    assert [kw["max_tokens"] for _, kw, _ in rec.calls] == [8, 8]  # serial, then batched
    rec.calls.clear()
    with _Serving(server) as srv:
        replies = _concurrent(srv.port, "/tts", [json.dumps(
            {"text": t, "max_tokens": 12}).encode() for t in texts])
        odd = _post(srv.port, "/tts", json.dumps({"text": "[S2]odd", "max_tokens": 8}).encode())
    assert [s for s, _ in replies] == [200] * 4 and odd[0] == 200
    assert list(srv.batcher.observed_batches) == [4, 1]
    (args, kwargs, inference), odd_call = rec.calls[0], rec.calls[1]
    assert inference and odd_call[2]
    stacked = args[0]
    assert sorted(stacked) == texts and kwargs == dict(max_tokens=12, pad_tokens_to=16)
    want = dict(zip(stacked, rec.fn(stacked, max_tokens=12, pad_tokens_to=16)))
    sr = dia.config.sample_rate
    for t, (_, wav) in zip(texts, replies):
        assert wav == serve._array_to_wav(want[t], sr)
    assert odd[1] == serve._array_to_wav(rec.fn(["[S2]odd"], max_tokens=8,
                                                pad_tokens_to=16)[0], sr)


def test_dia_token_bucket_matches_jax(jax_servers):
    dia = _port_dia()
    jdia = jax_servers["dia"].model
    for cap in (None, 16, 24, 10 ** 6):
        got = CodecServer(dia, "dia", port=0, batch_window_ms=0, dia_token_bucket=cap)
        want = jserve.CodecServer(jdia, "dia", port=0, batch_window_ms=0, dia_token_bucket=cap)
        try:
            for mt in (None, 8, 16, 24, 31):
                assert got._dia_token_bucket(mt) == want._dia_token_bucket(mt)
        finally:
            got.httpd.server_close()
            want.httpd.server_close()


# ----------------------------------------------------------------- autograd


def test_handler_threads_run_without_autograd(codecs):
    """Grad mode is thread-local: every model call of the handler and batcher
    threads runs in inference mode and returns no grad_fn, though the
    parameters require grad."""
    _, model = codecs["snac"]
    assert any(p.requires_grad for p in model.parameters())
    seen = []
    orig = {name: getattr(model, name) for name in ("forward", "encode", "decode",
                                                   "process_audio")}

    def spy(name):
        def call(*args, **kwargs):
            out = orig[name](*args, **kwargs)
            leaves = out if isinstance(out, (list, tuple)) else [out]
            leaves = [t for x in leaves for t in (x if isinstance(x, list) else [x])]
            seen.append((name, torch.is_inference_mode_enabled(),
                         [t.grad_fn for t in leaves if isinstance(t, torch.Tensor)]))
            return out
        return call

    for name in orig:
        setattr(model, name, spy(name))
    try:
        body = serve._array_to_wav(_audio(1600, seed=4), model.config.sample_rate)
        for window in (0, 50):
            with _Serving(CodecServer(model, "snac", port=0, batch_window_ms=window)) as srv:
                assert _post(srv.port, "/roundtrip", body)[0] == 200
                status, enc, _ = _post(srv.port, "/encode", body)
                assert _post(srv.port, "/decode", enc)[0] == 200
    finally:
        for name in orig:
            delattr(model, name)
    names = [name for name, _, _ in seen]
    assert {"forward", "encode", "decode", "process_audio"} <= set(names)
    assert all(inference for _, inference, _ in seen), seen
    assert all(fn is None for _, _, fns in seen for fn in fns)
