"""Minimal production serving endpoint for the codecs, PyTorch port.

Counterpart of neuralcodecs_tpu.cli.serve: a dependency-free (stdlib
http.server) HTTP endpoint around one codec or Dia model on the card:

    python -m neuralcodecs_tpu_torch.cli serve --codec snac --preset 24khz --port 8799

Routes (WAV = 16-bit PCM RIFF bytes):
    GET  /healthz            -> {"status": "ok", "codec": ..., "sample_rate": ...}
    GET  /metrics            -> per-route counts/latency percentiles + batcher stats
    POST /roundtrip          WAV in  -> WAV out (encode+decode)
    POST /encode             WAV in  -> {"codes": [[...]...], "sample_rate": N}
    POST /decode             {"codes": ...} JSON in -> WAV out
    POST /compress           WAV in  -> .ecdc (Encodec; ?lm=1, ?lm_batch=N)
                                     or .dac (DAC) bytes
    POST /decompress         .ecdc / .dac bytes in -> WAV out
    POST /tts                {"text": ...} -> WAV, {"texts": [...]} -> base64 WAVs (Dia)
    POST /tts/stream         {"text": ...} -> chunked WAV as it is generated (Dia)

Design notes (serving on one CUDA device):
- eager PyTorch compiles nothing, but ``warmup`` still runs before the
  socket opens: the first use builds the kernels' library with nvcc, cuDNN
  picks its algorithms for each shape, and the allocator grows its pool, so
  a first request pays none of it;
- device work is serialised behind one lock on torch's one current stream
  while ThreadingHTTPServer overlaps network I/O. The LSTM kernel hands its
  steps over through a counter in device memory that no launch resets, so
  two of its launches must never overlap: no server code makes a side
  stream;
- grad mode is thread-local, so every device call of the handler and
  batcher threads runs under ``torch.inference_mode()``;
- requests are size-capped and malformed input returns 400 with a JSON
  error body, never a traceback. Client codes are range-checked on the
  host: an out-of-range index on the card is a device-side assert that
  ends the process's CUDA context.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import queue
import threading
import time
import wave
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

MAX_BODY_BYTES = 256 * 1024 * 1024  # ~25 min of 16-bit 48 kHz stereo

# ceiling on the client-supplied ?lm_batch= (each row costs ~1 MB of LM
# state plus per-step host work, all while holding the device lock);
# tighter than the library's own MAX_LM_BATCH format bound
MAX_SERVE_LM_BATCH = 16


def _ecdc_needs_lm(blob: bytes) -> bool:
    """Header-only peek: does this .ecdc stream need the language model?

    Used to resolve (and possibly download) the LM before taking the
    device lock; parse errors return False and surface later in the real
    decode path with a proper 400.
    """
    try:
        from neuralcodecs_tpu_torch.models.encodec import ecdc

        return bool(ecdc.read_header(io.BytesIO(blob)).get("lm"))
    except Exception:
        return False


def _wav_to_array(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (audio [C, T] float32, sample_rate)."""
    with wave.open(io.BytesIO(data), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        if f.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV is supported")
        pcm = np.frombuffer(f.readframes(n), dtype="<i2").reshape(-1, ch)
    return pcm.astype(np.float32).T / 32768.0, sr


def _adapt_channels(audio: np.ndarray, want: int) -> np.ndarray:
    """[C, T] -> [want, T]: mixdown extra channels, duplicate a mono input."""
    have = audio.shape[0]
    if have == want:
        return audio
    mono = audio.mean(axis=0, keepdims=True)
    return np.broadcast_to(mono, (want, audio.shape[1]))


def _array_to_wav(audio: np.ndarray, sr: int) -> bytes:
    """[T] or [C, T] float32 -> 16-bit PCM WAV bytes."""
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[None, :]
    pcm = (np.clip(a, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.T.reshape(-1).tobytes())
    return buf.getvalue()


def _streaming_wav_header(sr: int, channels: int = 1) -> bytes:
    """A 44-byte WAV header with the streaming convention of 0xFFFFFFFF
    RIFF/data sizes (length unknown at header time); players and stdlib
    readers treat it as read-until-EOF."""
    import struct

    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt " +
            struct.pack("<IHHIIHH", 16, 1, channels, sr, sr * 2 * channels,
                        2 * channels, 16) +
            b"data" + struct.pack("<I", 0xFFFFFFFF))


class _Metrics:
    """Thread-safe per-route serving counters (GET /metrics).

    Bounded latency windows (last 512 requests per route) keep a
    long-lived server's memory flat; percentiles are computed on read.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._routes: dict = {}

    KNOWN_ROUTES = frozenset(
        {"/healthz", "/metrics", "/roundtrip", "/encode", "/decode", "/tts",
         "/tts/stream", "/compress", "/decompress"})

    def record(self, route: str, seconds: float, ok: bool) -> None:
        # bucket unknown (attacker-controlled) paths so the route table --
        # and therefore server memory -- stays bounded
        if route not in self.KNOWN_ROUTES:
            route = "<other>"
        with self._lock:
            r = self._routes.setdefault(
                route, {"count": 0, "errors": 0,
                        "lat": collections.deque(maxlen=512)})
            r["count"] += 1
            if not ok:
                r["errors"] += 1
            r["lat"].append(seconds)

    def snapshot(self, batcher=None) -> dict:
        with self._lock:
            routes = {}
            for name, r in self._routes.items():
                lat = sorted(r["lat"])
                routes[name] = {
                    "count": r["count"],
                    "errors": r["errors"],
                    "p50_ms": round(1e3 * lat[len(lat) // 2], 2) if lat else None,
                    "p95_ms": round(1e3 * lat[int(len(lat) * 0.95)], 2)
                    if lat else None,
                    "max_ms": round(1e3 * lat[-1], 2) if lat else None,
                }
        out = {"uptime_s": round(time.monotonic() - self._t0, 1),
               "routes": routes}
        if batcher is not None:
            sizes = list(batcher.observed_batches)
            if sizes:
                out["batcher"] = {
                    "batches": len(sizes),
                    "mean_batch": round(sum(sizes) / len(sizes), 2),
                    "max_batch_seen": max(sizes),
                }
        return out


@contextlib.contextmanager
def _device_section(lock: threading.Lock):
    """``lock`` held with autograd off in the calling thread (grad mode is
    thread-local): every model call of the servers runs inside one."""
    with lock, torch.inference_mode():
        yield


def _in_thread(fn):
    """Run ``fn`` in a short-lived thread and return its result (or raise
    its exception) once the thread has ended."""
    fut: Future = Future()

    def run():
        try:
            fut.set_result(fn())
        except BaseException as exc:  # handed to the caller below
            fut.set_exception(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    return fut.result()


def _check_codes(codes: np.ndarray, codebook_size: int) -> None:
    """Client codes must index the codebook: on the card an out-of-range
    index is a device-side assert, not an exception."""
    if codes.size and (int(codes.min()) < 0 or int(codes.max()) >= codebook_size):
        raise ValueError(f"codes must be in [0, {codebook_size})")


class _MicroBatcher:
    """Coalesce concurrent ``/roundtrip`` requests into one batched device
    call (the per-stream forward is partly latency-bound; a stacked batch
    amortises launches and host work across B streams).

    A worker thread drains the queue: the first request opens a ``window_s``
    collection window (bounded at ``max_batch``); requests sharing the same
    prepared shape are stacked into one ``model.forward`` batch. Distinct
    lengths run as separate groups — equal-length stacking keeps per-stream
    semantics identical to serial execution (no cross-stream padding, so
    Encodec's per-frame normalization scales are untouched). Caveat: SNAC
    configs with ``noise=True`` draw the decoder noise from one generator
    over the whole batch, so a stream's noise realization (not its signal
    content) depends on its batch slot. The batch axis is padded to the
    next power of two (dropped on output) to bound the number of distinct
    shapes cuDNN plans for.

    For a Dia server the same machinery coalesces concurrent single-text
    ``/tts`` requests into one batched ``generate`` call: the decode loop
    reads the full parameter set once per STEP regardless of B, so a batch
    of B requests costs barely more than one. Requests group by their
    ``max_tokens`` (EOS is forced at the batch's shared limit); text-length
    differences are free — ``generate`` pads text internally with zero
    attention weight. Caveat: each batch row draws its own sampling noise,
    so a request's sampled noise (not its text conditioning) depends on its
    batch slot, exactly like SNAC's decoder noise.
    """

    def __init__(self, server: "CodecServer", window_s: float = 0.004,
                 max_batch: int = 16):
        self.server = server
        self.window_s = window_s
        self.max_batch = max_batch
        # group sizes for tests/metrics; bounded so a long-lived server
        # does not leak
        self.observed_batches: "collections.deque[int]" = collections.deque(
            maxlen=256)
        self._stopped = False
        # serializes the stopped-check-then-enqueue against stop(): a submit
        # that passes the check is guaranteed to land AHEAD of the shutdown
        # sentinel, so its Future is always resolved (served or drain-failed)
        self._submit_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, prepared) -> Future:
        """Enqueue a prepared request item.

        Codec servers submit a model-rate, model-layout tensor on the
        model's device — the resample + channel adaptation happens in the
        caller's handler thread, and the one batcher thread only stacks
        equal-shape tensors and runs the device call. Dia servers submit a
        ``(text, max_tokens)`` tuple.
        """
        fut: Future = Future()
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("server is shutting down")
            self._q.put((prepared, fut))
        return fut

    def stop(self) -> None:
        # flag + sentinel under the submit lock: a submit() racing shutdown
        # either raises immediately or lands ahead of the sentinel and is
        # still served; leftovers are drained and failed below rather than
        # hanging their Future until the handler timeout
        with self._submit_lock:
            self._stopped = True
            self._q.put(None)
        self._thread.join(timeout=10)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].set_exception(RuntimeError("server is shutting down"))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _group_key(self, item):
        """Items sharing a key stack into one device call (codec: equal
        prepared shape -> no cross-stream padding; tts: equal max_tokens
        -> one shared EOS limit for the batched decode loop)."""
        if self.server.codec_name == "dia":
            _text, max_tokens = item
            return ("tts", max_tokens)
        return tuple(item.shape)

    def _flush(self, batch: list) -> None:
        groups: dict = {}
        for x, fut in batch:
            groups.setdefault(self._group_key(x), []).append((x, fut))
        for items in groups.values():
            self._run_group(items)

    def _run_group(self, items: list) -> None:
        server, model = self.server, self.server.model
        self.observed_batches.append(len(items))
        try:
            if server.codec_name == "dia":
                # one batched generation; generate_codes buckets the batch
                # axis to the next power of two internally, so no padding
                # is needed here
                texts = [text for (text, _mt), _fut in items]
                max_tokens = items[0][0][1]
                with server._on_device():
                    audios = model.generate(
                        texts, max_tokens=max_tokens,
                        pad_tokens_to=server._dia_token_bucket(max_tokens))
                for (_item, fut), a in zip(items, audios):
                    fut.set_result(np.asarray(a))
                return
            xs = [x for x, _ in items]
            b = len(xs)
            target_b = 1 << (b - 1).bit_length()
            with server._on_device():
                out = server._forward_batch(
                    torch.stack(xs + [xs[-1]] * (target_b - b))).cpu().numpy()
            for i, (_, fut) in enumerate(items):
                fut.set_result(out[i])
        except Exception as exc:
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(exc)


class CodecServer:
    """Wraps one codec model behind an HTTP server; device calls serialize
    behind ``_device_lock``, and concurrent ``/roundtrip`` (codec) or
    single-text ``/tts`` (Dia) requests are micro-batched into single
    device calls (``batch_window_ms > 0``)."""

    def __init__(self, model, codec_name: str, host: str = "127.0.0.1",
                 port: int = 8799, batch_window_ms: float = 4.0,
                 max_batch: int = 16, dia_token_bucket: int | None = None):
        self.model = model
        self.codec_name = codec_name
        self._dia_bucket = dia_token_bucket
        self._device_lock = threading.Lock()
        self.metrics = _Metrics()
        self.batcher = (_MicroBatcher(self, batch_window_ms / 1000.0, max_batch)
                        if batch_window_ms > 0 else None)
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: clients reuse one TCP connection across
            # requests (Content-Length is always set below), removing
            # per-request handshake + thread-spawn from the serving path
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self._last_status = code
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    if self.close_connection:
                        # advertise the close (set e.g. on the unread-body
                        # 413 path) so keep-alive clients don't attempt reuse
                        self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    # client hung up mid-reply (e.g. a probe with a short
                    # timeout); nothing to salvage — drop the connection
                    # without socketserver's full-traceback stderr dump
                    self.close_connection = True

            def _reply_json(self, code: int, obj) -> None:
                self._reply(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply_json(200, {
                        "status": "ok",
                        "codec": server.codec_name,
                        "sample_rate": server.model.config.sample_rate,
                    })
                elif self.path == "/metrics":
                    self._reply_json(
                        200, server.metrics.snapshot(server.batcher))
                else:
                    self._reply_json(404, {"error": "unknown route"})

            def do_POST(self):
                start = time.monotonic()
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    if length <= 0 or length > MAX_BODY_BYTES:
                        # the body is never read, so a keep-alive connection
                        # would parse its bytes as the next request line --
                        # force-close instead of desyncing the stream
                        self.close_connection = True
                        self._reply_json(413, {"error": "bad request size"})
                        return
                    body = self.rfile.read(length)
                    if self.path == "/roundtrip":
                        audio, sr = _wav_to_array(body)
                        if server.batcher is not None:
                            # prepare here (handler thread) so concurrent
                            # requests prepare in parallel; the batcher
                            # thread only stacks + runs the device call
                            x = server._prepare_audio(audio, sr)
                            out = server.batcher.submit(x).result(
                                timeout=600)
                        else:
                            with server._on_device():
                                out = server.roundtrip(audio, sr)
                        self._reply(200, _array_to_wav(
                            out, server.model.config.sample_rate),
                            "audio/wav")
                    elif self.path == "/encode":
                        audio, sr = _wav_to_array(body)
                        with server._on_device():
                            codes, scales = server.encode(audio, sr)
                        self._reply_json(200, {
                            "codes": codes,
                            "scales": scales,
                            "sample_rate": server.model.config.sample_rate,
                        })
                    elif self.path == "/decode":
                        payload = json.loads(body)
                        with server._on_device():
                            out = server.decode(payload["codes"],
                                                payload.get("scales"))
                        self._reply(200, _array_to_wav(
                            out, server.model.config.sample_rate), "audio/wav")
                    elif (self.path.split("?", 1)[0] == "/compress"
                          and server.codec_name == "encodec"):
                        # WAV in -> .ecdc container out; ?lm=1 selects the
                        # LM entropy coder (requires a loaded LM), ?lm_batch=N
                        # batches a segmented stream's frames per LM step
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        use_lm = q.get("lm", ["0"])[0] in ("1", "true")
                        lm_batch = int(q.get("lm_batch", ["1"])[0])
                        if not 1 <= lm_batch <= MAX_SERVE_LM_BATCH:
                            raise ValueError(
                                f"lm_batch must be in [1, "
                                f"{MAX_SERVE_LM_BATCH}], got {lm_batch}")
                        audio, sr = _wav_to_array(body)
                        x = server._prepare_audio(audio, sr)
                        # resolve the LM BEFORE taking the device lock: the
                        # first use may build (or download) weights, and that
                        # must not stall every other route on the server
                        lm = (server.model.get_language_model()
                              if use_lm else None)
                        with server._on_device():
                            blob = server.model.compress(
                                x, use_lm=use_lm, lm=lm, lm_batch=lm_batch)
                        self._reply(200, blob, "application/octet-stream")
                    elif (self.path.split("?", 1)[0] == "/compress"
                          and server.codec_name == "dac"):
                        # WAV in -> .dac artifact out (the reference's
                        # DACFile.cs container, frozen framing in
                        # models/dac/dacfile.py)
                        from neuralcodecs_tpu_torch.models.dac.dacfile import (
                            dac_file_bytes,
                        )

                        audio, sr = _wav_to_array(body)
                        x = server._prepare_audio(audio, sr)
                        with server._on_device():
                            _, codes, _, _, _ = server.model.encode(x)
                            codes = codes.cpu().numpy()
                        blob = dac_file_bytes([codes], server.model.config)
                        self._reply(200, blob, "application/octet-stream")
                    elif (self.path.split("?", 1)[0] == "/decompress"
                          and server.codec_name == "dac"):
                        from neuralcodecs_tpu_torch.models.dac.dacfile import (
                            parse_dac_file,
                        )

                        codes, _cfg = parse_dac_file(body)
                        if not codes:
                            raise ValueError("empty .dac artifact")
                        codes = np.array(codes[0], np.int32)  # writable
                        _check_codes(codes, server.model.config.codebook_size)
                        with server._on_device():
                            out = server.model.from_codes(codes).cpu().numpy()
                        self._reply(200, _array_to_wav(
                            out[0], server.model.config.sample_rate),
                            "audio/wav")
                    elif (self.path.split("?", 1)[0] == "/decompress"
                          and server.codec_name == "encodec"):
                        # peek the header outside the lock so an LM stream's
                        # first request resolves/downloads the LM without
                        # blocking other routes (same reason as /compress)
                        lm = None
                        if _ecdc_needs_lm(body):
                            lm = server.model.get_language_model()
                        with server._on_device():
                            out = server.model.decompress(
                                body, lm=lm).cpu().numpy()
                        self._reply(200, _array_to_wav(
                            out[0], server.model.config.sample_rate),
                            "audio/wav")
                    elif self.path == "/tts" and server.codec_name == "dia":
                        payload = json.loads(body)
                        max_tokens = payload.get("max_tokens")
                        if "texts" in payload:
                            # batched TTS: the decode loop reads the full
                            # parameter set once per STEP regardless of B,
                            # so one batch-B generation call costs barely
                            # more than B=1
                            if not isinstance(payload["texts"], list):
                                # a bare string would iterate into characters
                                raise ValueError(
                                    "'texts' must be a list of strings")
                            texts = list(payload["texts"])
                            if not texts or not all(
                                    isinstance(t, str) for t in texts):
                                raise ValueError(
                                    "'texts' must be a non-empty list of "
                                    "strings")
                            with server._on_device():
                                audios = server.model.generate(
                                    texts, max_tokens=max_tokens,
                                    pad_tokens_to=server._dia_token_bucket(
                                        max_tokens))
                            import base64

                            sr = server.model.config.sample_rate
                            self._reply_json(200, {
                                "sample_rate": sr,
                                "wavs_b64": [
                                    base64.b64encode(
                                        _array_to_wav(np.asarray(a), sr)
                                    ).decode("ascii")
                                    for a in audios],
                            })
                        else:
                            text = payload["text"]
                            if not isinstance(text, str):
                                raise ValueError("'text' must be a string")
                            if server.batcher is not None:
                                # concurrent single-text requests coalesce
                                # into one batched generation (the decode
                                # loop's weight reads are shared across B)
                                out = server.batcher.submit(
                                    (text, max_tokens)).result(timeout=600)
                            else:
                                with server._on_device():
                                    audios = server.model.generate(
                                        [text], max_tokens=max_tokens,
                                        pad_tokens_to=server._dia_token_bucket(
                                            max_tokens))
                                out = np.asarray(audios[0])
                            self._reply(200, _array_to_wav(
                                out, server.model.config.sample_rate),
                                "audio/wav")
                    elif (self.path == "/tts/stream"
                          and server.codec_name == "dia"):
                        payload = json.loads(body)
                        text = payload["text"]
                        if not isinstance(text, str):
                            raise ValueError("'text' must be a string")
                        max_tokens = payload.get("max_tokens")
                        seg = int(payload.get("segment_tokens") or 64)
                        if not 1 <= seg <= 4096:
                            raise ValueError("segment_tokens out of range")
                        kwargs = dict(
                            segment_tokens=seg,
                            seed=int(payload.get("seed") or 0),
                            pad_tokens_to=server._dia_token_bucket(max_tokens))
                        if max_tokens is not None:
                            kwargs["max_tokens"] = int(max_tokens)
                        # device work happens inside next(gen); take the lock
                        # per segment so codec/tts requests interleave with
                        # the stream instead of stalling behind it
                        gen = server.model.generate_stream(text, **kwargs)
                        sr = server.model.config.sample_rate
                        # pull the FIRST chunk before committing headers so
                        # validation errors still return clean JSON
                        with server._on_device():
                            first = next(gen, None)
                        self._last_status = 200
                        self.send_response(200)
                        self.send_header("Content-Type", "audio/wav")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.send_header("X-Sample-Rate", str(sr))
                        self.end_headers()

                        def _chunk(data: bytes) -> None:
                            if data:
                                self.wfile.write(
                                    f"{len(data):X}\r\n".encode()
                                    + data + b"\r\n")

                        def _pcm(chunk) -> bytes:
                            return (np.clip(chunk, -1.0, 1.0)
                                    * 32767.0).astype("<i2").tobytes()

                        try:
                            _chunk(_streaming_wav_header(sr))
                            if first is not None:
                                _chunk(_pcm(first[1]))
                            while True:
                                with server._on_device():
                                    try:
                                        _, chunk = next(gen)
                                    except StopIteration:
                                        break
                                _chunk(_pcm(chunk))
                            self.wfile.write(b"0\r\n\r\n")
                        except Exception:
                            # headers are out: no second response possible —
                            # drop the connection so the client sees a
                            # truncated chunked stream, not a silent success
                            self._last_status = 500
                            self.close_connection = True
                    else:
                        self._reply_json(404, {"error": "unknown route"})
                except (ValueError, KeyError, json.JSONDecodeError,
                        wave.Error) as exc:
                    self._reply_json(400, {"error": str(exc)})
                except Exception as exc:  # keep the server alive
                    from neuralcodecs_tpu_torch.core.exceptions import (
                        NeuralCodecError,
                    )

                    code = 400 if isinstance(exc, NeuralCodecError) else 500
                    self._reply_json(
                        code, {"error": f"{type(exc).__name__}: {exc}"})
                finally:
                    server.metrics.record(
                        self.path.split("?", 1)[0], time.monotonic() - start,
                        getattr(self, "_last_status", 500) < 400)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port

    # -- codec-family adapters -------------------------------------------------

    def _on_device(self):
        """This server's device section (see ``_device_section``)."""
        return _device_section(self._device_lock)

    def _dia_token_bucket(self, max_tokens=None) -> int:
        """The generation-buffer bucket for a request: by default the
        model's audio_length ceiling. Pinning one bucket sizes the
        self-attention cache (and the per-step KV read) the same for every
        request, whatever its ``max_tokens``; EOS is still forced at the
        exact requested limit.

        Operators who know their deployment's generation ceiling can cap
        the bucket (``--dia-token-bucket``): a smaller self-attention
        cache cuts the per-step KV read. A request whose ``max_tokens``
        exceeds the cap falls back to the model-ceiling bucket instead of
        failing."""
        full = self.model.config.data.audio_length
        bucket = min(self._dia_bucket or full, full)
        if max_tokens is not None and int(max_tokens) > bucket:
            return full
        return bucket

    def _prepare_audio(self, audio: np.ndarray, sr: int) -> torch.Tensor:
        """[C, T] request audio -> model-rate, model-channel layout, as a
        tensor on the model's device (the resample runs there)."""
        from neuralcodecs_tpu_torch.dsp.resample import resample_poly

        model = self.model
        with torch.inference_mode():
            x = torch.tensor(audio, dtype=torch.float32, device=model.device)
            if sr != model.config.sample_rate:
                x = resample_poly(x, sr, model.config.sample_rate)
            want = getattr(model.config, "channels", 1)
            if x.shape[0] != want:  # _adapt_channels on the device
                x = x.mean(dim=0, keepdim=True).expand(want, x.shape[1])
            return x if self.codec_name == "encodec" else x[0]

    def _forward_batch(self, stacked: torch.Tensor) -> torch.Tensor:
        """Round trip of a stacked [B, T] (Encodec: [B, C, T]) batch ->
        audio of the same layout, on the device."""
        model = self.model
        if self.codec_name == "dac":
            return model.forward(stacked)["audio"]
        if self.codec_name == "encodec":
            return model.forward(stacked)
        return model.forward(stacked)[0]  # snac

    def roundtrip(self, audio: np.ndarray, sr: int) -> np.ndarray:
        model = self.model
        x = self._prepare_audio(audio, sr)
        if self.codec_name == "encodec":
            # keep all channels (process_audio's contract is mono)
            return model.forward(x)[0].cpu().numpy()
        return model.process_audio(x, model.config.sample_rate)

    def encode(self, audio: np.ndarray, sr: int):
        """Returns (codes, scales-or-None) as JSON-ready lists."""
        model = self.model
        x = self._prepare_audio(audio, sr)
        if self.codec_name == "encodec":
            frames = model.encode(x)
            codes = [f.codes.cpu().numpy().tolist() for f in frames]
            scales = ([None if f.scale is None else f.scale.cpu().numpy().tolist()
                       for f in frames]
                      if any(f.scale is not None for f in frames) else None)
            return codes, scales
        if self.codec_name == "dac":
            _, codes, _, _, _ = model.encode(x)
            return codes.cpu().numpy().tolist(), None
        return [c.cpu().numpy().tolist() for c in model.encode(x)], None  # snac

    def decode(self, codes, scales=None) -> np.ndarray:
        model = self.model
        size = model.config.codebook_size
        if self.codec_name == "encodec":
            from neuralcodecs_tpu_torch.models.encodec.model import EncodedFrame

            frames = []
            for i, c in enumerate(codes):
                c = np.asarray(c, np.int32)
                _check_codes(c, size)
                frames.append(EncodedFrame(
                    torch.as_tensor(c, device=model.device),
                    None if scales is None or scales[i] is None
                    else torch.as_tensor(scales[i], dtype=torch.float32,
                                         device=model.device)))
            return model.decode(frames)[0].cpu().numpy()
        if self.codec_name == "dac":
            codes = np.asarray(codes, np.int32)
            _check_codes(codes, size)
            return model.from_codes(codes)[0].cpu().numpy()
        codes = [np.asarray(c, np.int32) for c in codes]  # snac
        for c in codes:
            _check_codes(c, size)
        return model.decode(codes)[0].cpu().numpy()

    # -- lifecycle -------------------------------------------------------------

    def warmup(self, lengths_s: tuple[float, ...] = (1.0,)) -> None:
        """Run the hot paths once before accepting traffic: the first use
        builds the kernels' library with nvcc, cuDNN picks its algorithms
        for each shape, and the caching allocator sizes its pool.

        The serial B=1 path is always warmed. When micro-batching is on,
        the ``max_batch`` stacked shape is warmed too (group sizes pad to
        powers of two, so the full-batch shape is the one every saturated
        burst hits; intermediate power-of-two sizes and unseen lengths are
        planned on first use). A Dia server runs one short generation at
        batch 1 and, with batching on, one at ``max_batch``, in the bucket
        its requests use.

        Each call runs in a thread that serves: torch gives every thread its
        own cuBLAS and cuDNN handles, made at its first device call. The
        batched shape goes through the batcher's own thread; the serial
        path runs in a short-lived thread, whose handles go back to torch's
        pool for the first handler thread. Returns when the device is done.
        """
        if self.codec_name == "dia":
            full = self._dia_token_bucket()
            _in_thread(self._locked(lambda: self.model.generate(
                ["[S1]warmup"], max_tokens=8, pad_tokens_to=full)))
            if self.batcher is not None:
                self._through_batcher(("[S1]warmup", 8))
            return
        sr = self.model.config.sample_rate
        want = getattr(self.model.config, "channels", 1)
        for seconds in lengths_s:
            n = int(sr * seconds)
            tone = np.broadcast_to(
                (0.1 * np.sin(2 * np.pi * 440 * np.arange(n) / sr))
                .astype(np.float32), (want, n))
            _in_thread(self._locked(lambda: self.roundtrip(tone, sr)))
            if self.batcher is not None:
                self._through_batcher(self._prepare_audio(tone, sr))

    def _locked(self, fn):
        """``fn`` as a call that holds the device lock in autograd-off mode."""
        def call():
            with self._on_device():
                return fn()
        return call

    def _through_batcher(self, item) -> None:
        """Submit ``max_batch`` copies of a prepared item at once, so the
        batcher runs them as one full batch; the warm-up batch is left out
        of the batcher's statistics."""
        futures = [self.batcher.submit(item) for _ in range(self.batcher.max_batch)]
        for fut in futures:
            fut.result(timeout=600)
        self.batcher.observed_batches.clear()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.stop()
