"""Low-latency streaming serving for causal Encodec over TCP, PyTorch port.

Counterpart of neuralcodecs_tpu.cli.stream_serve, with the same wire
protocol. The HTTP endpoint (`cli/serve.py`) covers request/response
serving; live streams (telephony, live transcription front-ends) need
chunk-in/chunk-out with carried state. This wraps the streaming sessions of
`models/encodec/streaming.py` (state carried on the device) in a
dependency-free TCP framing:

wire protocol (all integers big-endian):
    client -> server, once:   one JSON header line ending in ``\n``:
        {"op": "roundtrip" | "encode" | "decode", "chunk_samples": N}
        N (advisory) must be 0 — "frames sized per the hello below" — or
        a multiple of the model hop (320 for the 24 kHz preset); for
        "decode" it is ignored (frame sizing comes from the codes).
    then repeated frames:     u32 length | payload
        roundtrip/encode: float32 little-endian mono PCM samples,
            len % hop == 0 (the final chunk may be shorter than
            chunk_samples; zero-pad to the hop grid client-side)
        decode: u32 n_q | u32 F | int32 codes [n_q, F] row-major
            (the same framing "encode" responses use, so an encode
            session's output can be piped into a decode session)
    server -> client, once, after accepting the header: a hello frame
        u32 length | JSON {"hop": H, "sample_rate": R, "n_q": N}
        so clients can size chunks without knowing the model preset.
    server -> client, per frame:  u32 length | payload
        roundtrip/decode: float32 PCM, exactly the decoded samples
        encode:           u32 n_q | u32 F | int32 codes [n_q, F] row-major
    a zero-length client frame ends the stream; the server closes after
    echoing a zero-length frame.
    On a malformed header/frame the server sends u32 0xFFFFFFFF | JSON
    error body and closes.

Each connection owns its session state (conv tails + LSTM carry), so
concurrent streams are isolated; device steps serialize behind one lock on
torch's one current stream: the LSTM kernel hands its steps over through a
counter in device memory that no launch resets, so two of its launches
must never overlap. Each push runs under ``torch.inference_mode()`` (grad
mode is thread-local, and every session has a thread of its own). Decode
frames whose codes fall outside the codebook are refused with an error
frame: on the card an out-of-range index is a device-side assert.
"""

from __future__ import annotations

import json
import socketserver
import struct
import threading

import numpy as np
import torch

from neuralcodecs_tpu_torch.cli.serve import _device_section, _in_thread

MAX_FRAME_BYTES = 16 * 1024 * 1024
ERR_MARK = 0xFFFFFFFF


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        piece = rfile.read(n - len(buf))
        if not piece:
            raise ConnectionError("client closed mid-frame")
        buf += piece
    return buf


class StreamingCodecServer:
    """TCP server exposing per-connection streaming Encodec sessions.

    ``device_lock`` lets the caller share one lock across every serving
    surface on the device (e.g. the HTTP ``CodecServer`` running alongside),
    so batched HTTP forwards and streaming steps stay mutually serialized.
    ``block_hops`` bounds the steady-state chunk shapes (see
    ``StreamingEncoder``): the default ``(8, 1)`` covers the CLI client's
    100 ms default (8 hops) and any hop-grid remainder, so :meth:`warmup`
    runs every steady-state shape a session can step and cuDNN has its
    plans before a client arrives. A session's first chunk runs whole
    (exact-boundary semantics); first-chunk sizes equal to a block size are
    warmed, others are planned at session start."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 device_lock: threading.Lock | None = None,
                 block_hops: tuple[int, ...] = (8, 1)):
        from neuralcodecs_tpu_torch.models.encodec.streaming import (
            StreamingDecoder, StreamingEncoder, _check_streamable)

        _check_streamable(model)
        self.model = model
        self.hop = model.encoder.hop_length
        self.codebook_size = model.config.codebook_size
        self.block_hops = block_hops
        self._device_lock = device_lock or threading.Lock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def _send(self, payload: bytes) -> None:
                self.wfile.write(struct.pack(">I", len(payload)) + payload)
                self.wfile.flush()

            def _fail(self, msg: str) -> None:
                body = json.dumps({"error": msg}).encode()
                self.wfile.write(struct.pack(">I", ERR_MARK)
                                 + struct.pack(">I", len(body)) + body)
                self.wfile.flush()

            def handle(self) -> None:
                try:
                    self._handle()
                except (ConnectionError, BrokenPipeError):
                    pass  # routine client abort mid-send; nothing to log

            def _handle(self) -> None:
                try:
                    header = json.loads(self.rfile.readline(4096) or b"{}")
                    op = header.get("op")
                    chunk = int(header.get("chunk_samples", 0))
                    if op not in ("roundtrip", "encode", "decode") or (
                            op != "decode"
                            and (chunk < 0 or chunk % outer.hop)):
                        self._fail(f"bad header: op must be roundtrip|encode|"
                                   f"decode and chunk_samples 0 or a "
                                   f"multiple of {outer.hop}")
                        return
                except (ValueError, json.JSONDecodeError):
                    self._fail("malformed JSON header")
                    return
                self._send(json.dumps({
                    "hop": outer.hop,
                    "sample_rate": outer.model.config.sample_rate,
                    "n_q": outer.model.num_codebooks,
                }).encode())
                enc = (StreamingEncoder(outer.model,
                                        block_hops=outer.block_hops)
                       if op != "decode" else None)
                dec = (StreamingDecoder(outer.model,
                                        block_hops=outer.block_hops)
                       if op != "encode" else None)
                n_q_max = outer.model.num_codebooks
                while True:
                    try:
                        (n,) = struct.unpack(">I", _read_exact(self.rfile, 4))
                        if n == 0:
                            self._send(b"")
                            return
                        if n > MAX_FRAME_BYTES or n % 4:
                            self._fail("bad frame length")
                            return
                        payload = _read_exact(self.rfile, n)
                    except ConnectionError:
                        return  # client went away between/mid frame
                    if enc is not None:
                        pcm = np.frombuffer(bytearray(payload), "<f4")
                        if pcm.size % outer.hop:
                            self._fail(f"chunk length {pcm.size} not a "
                                       f"multiple of hop {outer.hop}")
                            return
                        with _device_section(outer._device_lock):
                            codes = enc.push(pcm)
                            out = (dec.push(codes).cpu().numpy()
                                   if dec is not None else None)
                            codes = codes.cpu().numpy()
                    else:
                        if n < 8:
                            self._fail("bad codes frame: missing n_q/F")
                            return
                        n_q, f = struct.unpack(">II", payload[:8])
                        if not (1 <= n_q <= n_q_max) or f < 1 \
                                or n != 8 + 4 * n_q * f:
                            self._fail(f"bad codes frame: n_q must be in "
                                       f"[1, {n_q_max}] and length match "
                                       f"n_q*F int32s")
                            return
                        codes = (np.frombuffer(payload[8:], ">i4")
                                 .astype(np.int32).reshape(1, n_q, f))
                        if codes.min() < 0 or codes.max() >= outer.codebook_size:
                            self._fail(f"bad codes frame: codes must be in "
                                       f"[0, {outer.codebook_size})")
                            return
                        with _device_section(outer._device_lock):
                            out = dec.push(codes).cpu().numpy()
                    if dec is not None:
                        audio = out[0, :, 0].astype("<f4")
                        self._send(audio.tobytes())
                    else:
                        c = codes[0].astype(">i4")
                        self._send(struct.pack(">II", *c.shape) + c.tobytes())

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.tcpd = Server((host, port), Handler)
        self.port = self.tcpd.server_address[1]

    def warmup(self) -> None:
        """Run the first-chunk and steady-state pushes of every block size
        (sessions decompose arbitrary hop-multiple chunks into
        ``block_hops`` blocks after their first push), so the first use
        builds the kernels' library and cuDNN plans each shape before a
        client arrives. Non-block first-chunk sizes and decode sessions at
        a non-default ``n_q`` are planned at session start. The pushes run
        in a short-lived thread, whose cuBLAS and cuDNN handles then go back
        to torch's pool for the first session's thread. Returns when the
        device is done."""
        from neuralcodecs_tpu_torch.models.encodec.streaming import (
            StreamingDecoder, StreamingEncoder)

        enc = StreamingEncoder(self.model, block_hops=self.block_hops)
        dec = StreamingDecoder(self.model, block_hops=self.block_hops)

        def warm():
            with _device_section(self._device_lock):
                enc.warm()
                dec.warm()
                if self.model.device.type == "cuda":
                    torch.cuda.synchronize(self.model.device)
        _in_thread(warm)

    def serve_forever(self) -> None:
        self.tcpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.tcpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.tcpd.shutdown()
        self.tcpd.server_close()


class StreamClient:
    """Minimal client for tests/examples (and a reference for other
    implementations of the wire protocol)."""

    def __init__(self, host: str, port: int, op: str, chunk_samples: int):
        import socket

        self.sock = socket.create_connection((host, port), timeout=300)
        self.rfile = self.sock.makefile("rb")
        self.sock.sendall(json.dumps(
            {"op": op, "chunk_samples": chunk_samples}).encode() + b"\n")
        self.info = json.loads(self._recv())  # hello: hop/sample_rate/n_q

    def push(self, pcm: np.ndarray):
        self.sock.sendall(struct.pack(">I", 4 * pcm.size)
                          + pcm.astype("<f4").tobytes())
        return self._recv()

    def push_codes(self, codes: np.ndarray):
        """codes: [n_q, F] int32 -> decoded PCM bytes ("decode" sessions)."""
        body = (struct.pack(">II", *codes.shape)
                + codes.astype(">i4").tobytes())
        self.sock.sendall(struct.pack(">I", len(body)) + body)
        return self._recv()

    def close(self) -> bytes:
        self.sock.sendall(struct.pack(">I", 0))
        tail = self._recv()
        self.sock.close()
        return tail

    def _recv(self):
        (n,) = struct.unpack(">I", _read_exact(self.rfile, 4))
        if n == ERR_MARK:
            (m,) = struct.unpack(">I", _read_exact(self.rfile, 4))
            raise RuntimeError(json.loads(_read_exact(self.rfile, m))["error"])
        return _read_exact(self.rfile, n) if n else b""
