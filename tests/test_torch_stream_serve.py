"""The port's TCP streaming server against the JAX package's, on the CPU.

The parameters of ``ecdc_golden.npz`` (``tiny_config()``: causal, mono,
hop 8) drive both packages, as in ``tests/test_torch_streaming.py``, and the
same bars hold: a session's codes at least 99% equal to the JAX
``StreamingEncoder``'s on the same pushes, its audio within rtol 1e-4 /
atol 1e-5 of the JAX ``StreamingDecoder``'s. Against the port's own local
sessions the server's replies are bit for bit; concurrent sessions stay
isolated; an encode session pipes into a decode session; the wire errors
equal the JAX server's bytes; and ``neuralcodecs-torch stream`` runs end to
end.
"""

import json
import socket
import struct
import threading

import numpy as np
import pytest

import jax.numpy as jnp

from neuralcodecs_tpu.cli import stream_serve as jstream_serve
from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu.models.encodec import streaming as jstreaming
from neuralcodecs_tpu_torch.cli import stream_serve
from neuralcodecs_tpu_torch.cli.stream_serve import StreamClient, StreamingCodecServer
from neuralcodecs_tpu_torch.models.encodec import StreamingDecoder, StreamingEncoder
from test_encodec import tiny_config
from test_torch_encodec import _golden_port

AUDIO_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """The JAX Encodec and the port with the golden's weights."""
    port, g = _golden_port()
    params = {k[3:]: jnp.asarray(g[k]) for k in g.files if k.startswith("sd/")}
    return JEncodec(tiny_config(), params=params), port


@pytest.fixture(scope="module")
def servers(pair):
    """Warmed port and JAX servers, one each, for the whole file."""
    jmodel, model = pair
    srv = StreamingCodecServer(model, port=0)
    jsrv = jstream_serve.StreamingCodecServer(jmodel, port=0)
    for s in (srv, jsrv):
        s.warmup()
        s.start_background()
    yield srv, jsrv
    srv.shutdown()
    jsrv.shutdown()


def _audio(n: int, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _codes(raw: bytes) -> np.ndarray:
    n_q, f = struct.unpack(">II", raw[:8])
    return np.frombuffer(raw[8:], ">i4").reshape(n_q, f).astype(np.int32)


def _local(model, audio, chunk, encoder, decoder, block_hops=(8, 1)):
    """A local session pair: per-chunk (codes [n_q, F], audio [T])."""
    enc, dec = encoder(model, block_hops=block_hops), decoder(model, block_hops=block_hops)
    out = []
    for o in range(0, audio.size, chunk):
        codes = enc.push(audio[o: o + chunk])
        out.append((np.asarray(codes)[0], np.asarray(dec.push(codes))[0, :, 0]))
    return out


def test_hello_frame_equals_jax(servers):
    srv, jsrv = servers
    for op in ("roundtrip", "encode", "decode"):
        got = StreamClient("127.0.0.1", srv.port, op, 0)
        want = jstream_serve.StreamClient("127.0.0.1", jsrv.port, op, 0)
        assert got.info == want.info == {"hop": 8, "sample_rate": 16000, "n_q": 4}
        assert got.close() == want.close() == b""


@pytest.mark.parametrize("chunk_hops", [8, 3, 13])
def test_roundtrip_session_equals_jax_and_local(pair, servers, chunk_hops):
    """Pushes of 8 hops (a block), 3 (decomposed into 1s after the first)
    and 13 (8 + 5 x 1): the served audio equals the port's local session bit
    for bit and the JAX session within tolerance."""
    jmodel, model = pair
    srv, _ = servers
    chunk = 8 * chunk_hops
    audio = _audio(8 * 40, seed=chunk_hops)
    cli = StreamClient("127.0.0.1", srv.port, "roundtrip", chunk)
    got = [np.frombuffer(cli.push(audio[o: o + chunk]), "<f4")
           for o in range(0, audio.size, chunk)]
    assert cli.close() == b""
    local = _local(model, audio, chunk, StreamingEncoder, StreamingDecoder)
    for g, (_, want) in zip(got, local):
        np.testing.assert_array_equal(g, want)
    jlocal = _local(jmodel, audio, chunk, jstreaming.StreamingEncoder,
                    jstreaming.StreamingDecoder)
    codes = np.concatenate([c for c, _ in local], -1)
    jcodes = np.concatenate([c for c, _ in jlocal], -1)
    assert (codes == jcodes).mean() >= 0.99
    # decode the port's codes in a JAX session: the decoders side by side
    jdec = jstreaming.StreamingDecoder(jmodel, block_hops=(8, 1))
    want = [np.asarray(jdec.push(c[None]))[0, :, 0] for c, _ in local]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), **AUDIO_TOL)


def test_concurrent_sessions_stay_isolated(pair, servers):
    """Four encode sessions pushed from four threads at once, their pushes
    interleaved on the device lock: each one's codes equal its local
    session's, bit for bit."""
    _, model = pair
    srv, _ = servers
    chunk = 8 * 8
    audios = [_audio(chunk * 6, seed=20 + i) for i in range(4)]
    got: list = [None] * 4
    barrier = threading.Barrier(4)

    def run(i):
        cli = StreamClient("127.0.0.1", srv.port, "encode", chunk)
        barrier.wait(timeout=60)
        got[i] = [_codes(cli.push(audios[i][o: o + chunk]))
                  for o in range(0, audios[i].size, chunk)]
        cli.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        want = _local(model, audios[i], chunk, StreamingEncoder, StreamingDecoder)
        assert len(got[i]) == len(want)
        for g, (w, _) in zip(got[i], want):
            np.testing.assert_array_equal(g, w)


def test_encode_pipes_into_decode(pair, servers):
    _, model = pair
    srv, _ = servers
    chunk = 8 * 8
    audio = _audio(chunk * 3, seed=5)
    ce = StreamClient("127.0.0.1", srv.port, "encode", chunk)
    cd = StreamClient("127.0.0.1", srv.port, "decode", 0)
    got = []
    for o in range(0, audio.size, chunk):
        got.append(np.frombuffer(cd.push_codes(_codes(ce.push(audio[o: o + chunk]))), "<f4"))
    ce.close(), cd.close()
    want = [a for _, a in _local(model, audio, chunk, StreamingEncoder, StreamingDecoder)]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def _raw_exchange(port: int, header: bytes, frames: bytes) -> bytes:
    """Send a header line and raw frames; everything the server sends back
    until it closes."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(header + frames)
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            piece = sock.recv(65536)
            if not piece:
                return out
            out += piece


def _frame(payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + payload


WIRE_ERRORS = {
    "bad-op": (b'{"op": "transcode", "chunk_samples": 0}\n', b""),
    "chunk-off-hop": (b'{"op": "roundtrip", "chunk_samples": 7}\n', b""),
    "bad-json": (b"{not json\n", b""),
    "frame-length": (b'{"op": "encode", "chunk_samples": 0}\n', struct.pack(">I", 6) + b"x" * 6),
    "pcm-off-hop": (b'{"op": "encode", "chunk_samples": 0}\n', _frame(b"\0" * 4 * 12)),
    "codes-missing-header": (b'{"op": "decode"}\n', _frame(b"\0" * 4)),
    "codes-nq": (b'{"op": "decode"}\n', _frame(struct.pack(">II", 5, 1) + b"\0" * 20)),
    "codes-length": (b'{"op": "decode"}\n', _frame(struct.pack(">II", 2, 2) + b"\0" * 12)),
    "close": (b'{"op": "decode"}\n', struct.pack(">I", 0)),
}


@pytest.mark.parametrize("case", list(WIRE_ERRORS))
def test_wire_errors_equal_jax(servers, case):
    srv, jsrv = servers
    header, frames = WIRE_ERRORS[case]
    got = _raw_exchange(srv.port, header, frames)
    assert got == _raw_exchange(jsrv.port, header, frames)
    if case != "close":
        assert struct.pack(">I", stream_serve.ERR_MARK) in got


def test_codes_out_of_range_get_an_error_frame(servers):
    """A decode frame whose codes fall outside the codebook gets an error
    frame (on the card an out-of-range index would be a device-side
    assert); the server keeps serving."""
    srv, _ = servers
    cli = StreamClient("127.0.0.1", srv.port, "decode", 0)
    with pytest.raises(RuntimeError, match=r"bad codes frame: codes must be in \[0, 32\)"):
        cli.push_codes(np.full((2, 3), 32, np.int32))
    cli = StreamClient("127.0.0.1", srv.port, "decode", 0)
    assert len(cli.push_codes(np.zeros((2, 3), np.int32))) == 4 * 3 * 8
    cli.close()


def test_cli_stream_command(pair, servers, tmp_path, capsys):
    """`neuralcodecs-torch stream` pushes a WAV through the live server and
    writes the local sessions' audio (16-bit, within 2 LSB) or codes."""
    import wave

    from neuralcodecs_tpu_torch.cli.main import main
    from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

    _, model = pair
    srv, _ = servers
    sr = model.config.sample_rate
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(sr // 4) / sr)).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    with wave.open(str(wav_in), "wb") as w:
        w.setnchannels(1), w.setsampwidth(2), w.setframerate(sr)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    wav_out = tmp_path / "out.wav"
    assert main(["stream", "--port", str(srv.port), "--input", str(wav_in),
                 "--output", str(wav_out), "--chunk-ms", "50"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["chunks"] == 5 and stats["chunk_samples"] == 800
    loaded = AudioSignal.load(str(wav_in), device="cpu").audio_data[0, 0].numpy()
    local = _local(model, loaded, 800, StreamingEncoder, StreamingDecoder)
    want = np.concatenate([a for _, a in local])
    got = AudioSignal.load(str(wav_out), device="cpu").audio_data[0, 0].numpy()
    assert got.size == want.size
    np.testing.assert_allclose(got, want, atol=2 / 32767)
    npy = tmp_path / "codes.npy"
    assert main(["stream", "--port", str(srv.port), "--op", "encode", "--input", str(wav_in),
                 "--output", str(npy), "--chunk-ms", "50"]) == 0
    np.testing.assert_array_equal(np.load(npy), np.concatenate([c for c, _ in local], -1))
