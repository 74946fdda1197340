"""Low-latency streaming Encodec sessions (causal models), PyTorch port.

Counterpart of neuralcodecs_tpu.models.encodec.streaming. A session pushes
one chunk at a time through the SEANet ``stream()`` methods with carried
state: conv input tails, transposed-conv overlap tails and each SLSTM's
(h, c). The concatenated chunk outputs are the full causal forward: the
same computation per sample, equal to float tolerance (not bit for bit
across chunk sizes: cuDNN and the codebook search sum in their own order
at each shape).

On a CUDA device every push runs the LSTM kernel once a layer with the
carried state as h0 / c0, at T = frames in the push (1 for a one-hop push),
and the codebook kernel once an RVQ stage on B x frames rows. The first
push of a session runs eagerly: its left padding reflects the chunk's own
samples. Every later push replays a CUDA graph of its shapes (ops/graphs.py;
one for each side, batch, hops and n_q, shared by the model's sessions):
the session keeps its state (conv tails, transposed-conv tails, each
SLSTM's (h, c)) in one flat buffer, which is copied into the graph's static
state before the replay and back after, and the output is a copy of the
graph's. ``warm()`` captures them; ``ops.graphs.graphs_disabled()`` runs the
eager pushes instead. The LSTM kernel hands its steps over through a
counter in device memory that each launch zeroes on its stream, so two of
its launches on one device must never overlap: a session launches (and
replays) on torch's current stream, and sessions that run in threads must
share one stream.

Requirements: ``use_causal_conv=True``, no time_group_norm, no per-chunk
normalisation, an unsegmented model (the 24 kHz preset meets all).

Layouts are the JAX package's: audio chunks [T], [B, T] or [B, T, C] in,
codes [B, n_q, F]; decoded audio [B, F·hop, C].
"""

from __future__ import annotations

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.exceptions import CodecError
from neuralcodecs_tpu_torch.ops.graphs import (
    GraphCache,
    StaticStep,
    carve,
    flatten,
    graphs_enabled,
    signature,
    unflatten,
)


def _check_streamable(model) -> None:
    cfg = model.config
    if not cfg.use_causal_conv:
        raise CodecError("streaming requires a causal model (24 kHz preset)")
    if cfg.normalize:
        raise CodecError("streaming does not support per-frame normalization")
    if cfg.norm_type == "time_group_norm":
        raise CodecError("time_group_norm normalizes over the whole chunk; not streamable")
    if model.segment_length is not None:
        raise CodecError("streaming applies to unsegmented models")


def _decompose(total: int, blocks: tuple[int, ...]) -> list[int]:
    """Split ``total`` units greedily, largest first, into sizes from
    ``blocks`` (descending, ending in 1, so any total is representable)."""
    out: list[int] = []
    rem = total
    for b in blocks:
        while rem >= b:
            out.append(b)
            rem -= b
    return out


def _norm_blocks(block_hops) -> tuple[int, ...] | None:
    if not block_hops:
        return None
    blocks = tuple(sorted({int(h) for h in block_hops if int(h) >= 1}, reverse=True))
    return blocks if blocks and blocks[-1] == 1 else blocks + (1,)


def _graphs(model) -> GraphCache:
    """The model's push programs (dropped with its weights: Encodec._apply)."""
    cache = model.__dict__.get("_graph_cache")
    if cache is None:
        cache = model.__dict__["_graph_cache"] = GraphCache(model.device)
    return cache


def _static_push(session, side, x: torch.Tensor, step) -> torch.Tensor:
    """A steady push through the program of its shapes: ``step(x, state)
    -> (out, next state)`` over static copies of x and of the session's
    state, which the session holds flat (``_flat``, its ``_state`` tree a
    set of views of it) and gets back advanced in place."""
    leaves, spec = flatten(session._state)
    shapes = [tuple(t.shape) for t in leaves]
    if session._flat is None:
        if len({t.dtype for t in leaves}) > 1:
            raise TypeError("a streaming state of several dtypes: "
                            f"{sorted({str(t.dtype) for t in leaves})}")
        with torch.inference_mode(False):
            session._flat = torch.cat([t.reshape(-1) for t in leaves])
        session._state = unflatten(carve(session._flat, shapes), spec)

    def program(x_in: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        out, nxt = step(x_in, unflatten(carve(flat, shapes), spec))
        flat.copy_(torch.cat([t.reshape(-1) for t in flatten(nxt)[0]]))
        return out

    args = [x, session._flat]
    key = (side, tuple(x.shape), x.dtype, signature(leaves))
    return _graphs(session.model).get(
        key, lambda pool: StaticStep(program, args, n_state=1, pool=pool)).run(args)


class StreamingEncoder:
    """Chunked audio in -> RVQ codes out, with carried state.

    >>> enc = StreamingEncoder(model, n_q=8)
    >>> for chunk in chunks:              # [T] with T % hop_length == 0
    ...     codes = enc.push(chunk)       # [B, n_q, T/hop]

    ``block_hops`` (e.g. ``(8, 1)``) bounds the chunk shapes a session runs:
    after the first push every chunk is split greedily into sub-steps of
    those sizes (in hops), so a server that takes any client chunk size runs
    a fixed set of shapes (each run once by :meth:`warm`). The split is
    exact: the carried tails make the sub-steps' outputs the whole chunk's.
    The first push always runs whole, because its left padding reflects the
    chunk's own samples."""

    def __init__(self, model, n_q: int | None = None, block_hops=None):
        _check_streamable(model)
        self.model = model
        self.hop = model.encoder.hop_length
        self.n_q = n_q or model.quantizer.num_quantizers_for_bandwidth(model.frame_rate,
                                                                      model.bandwidth)
        self.block_hops = _norm_blocks(block_hops)
        self._state = None
        self._flat = None

    @torch.no_grad()
    def push(self, audio_chunk) -> torch.Tensor:
        """audio_chunk [T] | [B, T] | [B, T, C], T % hop_length == 0 ->
        int32 codes [B, n_q, T / hop] on the model's device."""
        x = torch.as_tensor(audio_chunk, dtype=torch.float32, device=self.model.device)
        if x.dim() == 1:
            x = x[None, :, None]
        elif x.dim() == 2:
            x = x[:, :, None]
        if x.shape[1] % self.hop:
            raise CodecError(f"chunk length {x.shape[1]} must be a multiple of the hop "
                             f"({self.hop})")
        x = x.transpose(1, 2)                                           # [B, C, T]
        n_hops = x.shape[-1] // self.hop
        if self.block_hops is None or self._state is None or n_hops in self.block_hops:
            return self._push_block(x)
        outs, off = [], 0
        for nh in _decompose(n_hops, self.block_hops):
            outs.append(self._push_block(x[..., off: off + nh * self.hop]))
            off += nh * self.hop
        return torch.cat(outs, dim=-1)

    def _push_block(self, x: torch.Tensor) -> torch.Tensor:
        if self._state is None or not graphs_enabled(self.model.device):
            codes, self._state = self._step(x, self._state)
            self._flat = None
            return codes
        return _static_push(self, ("encode", self.n_q), x, self._step)

    def _step(self, x: torch.Tensor, state) -> tuple[torch.Tensor, list]:
        emb, state = self.model.encoder.stream(x, state)
        return self.model.quantizer.encode(emb, self.n_q), state

    def warm(self) -> None:
        """Run a first-chunk and a steady push of every block size on a
        throwaway state (cuDNN picks its algorithms for each shape, and on a
        CUDA device the steady push's graph is captured); a live session is
        untouched. The graphs are keyed by the batch too: warm a session of
        batch 1 here."""
        saved = self._state, self._flat
        try:
            for nh in self.block_hops or (1,):
                self._state = self._flat = None
                z = torch.zeros(1, self.model.config.channels, nh * self.hop,
                                device=self.model.device)
                self._push_block(z)
                self._push_block(z)
        finally:
            self._state, self._flat = saved

    def reset(self) -> None:
        self._state = self._flat = None


class StreamingDecoder:
    """Chunked RVQ codes in -> audio out, with carried state. ``block_hops``
    works as in :class:`StreamingEncoder`, counted in code frames (one frame
    -> ``hop_length`` samples)."""

    def __init__(self, model, block_hops=None):
        _check_streamable(model)
        self.model = model
        self.block_hops = _norm_blocks(block_hops)
        self._default_n_q = model.quantizer.num_quantizers_for_bandwidth(model.frame_rate,
                                                                         model.bandwidth)
        self._state = None
        self._flat = None

    @torch.no_grad()
    def push(self, codes) -> torch.Tensor:
        """codes [B, n_q, F] -> audio [B, F·hop, channels]."""
        codes = torch.as_tensor(codes, device=self.model.device)
        frames = codes.shape[-1]
        if self.block_hops is None or self._state is None or frames in self.block_hops:
            return self._push_block(codes)
        outs, off = [], 0
        for nf in _decompose(frames, self.block_hops):
            outs.append(self._push_block(codes[..., off: off + nf]))
            off += nf
        return torch.cat(outs, dim=1)

    def _push_block(self, codes: torch.Tensor) -> torch.Tensor:
        if self._state is None or not graphs_enabled(self.model.device):
            audio, self._state = self._step(codes, self._state)
            self._flat = None
            return audio
        return _static_push(self, "decode", codes, self._step)

    def _step(self, codes: torch.Tensor, state) -> tuple[torch.Tensor, list]:
        audio, state = self.model.decoder.stream(self.model.quantizer.decode(codes), state)
        return audio.transpose(1, 2), state

    def warm(self, n_q: int | None = None) -> None:
        """Run a first and a steady push of every block size for one ``n_q``
        (default: the model bandwidth's) on a throwaway state of batch 1
        (capturing the steady push's graph on a CUDA device)."""
        n_q = n_q or self._default_n_q
        saved = self._state, self._flat
        try:
            for nf in self.block_hops or (1,):
                self._state = self._flat = None
                z = torch.zeros(1, n_q, nf, dtype=torch.int32, device=self.model.device)
                self._push_block(z)
                self._push_block(z)
        finally:
            self._state, self._flat = saved

    def reset(self) -> None:
        self._state = self._flat = None


def stream_roundtrip(model, audio: np.ndarray, chunk_samples: int):
    """Push audio through paired streaming encode and decode sessions chunk
    by chunk -> (audio_out [B, T, C], the codes of each chunk). A ragged tail
    is zero-padded to the hop grid, pushed as a last, shorter chunk, and the
    output trimmed back to the input length."""
    enc = StreamingEncoder(model)
    dec = StreamingDecoder(model)
    hop = enc.hop
    if chunk_samples % hop:
        raise CodecError(f"chunk_samples must be a multiple of {hop}")
    x = np.asarray(audio, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    t = x.shape[1]
    outs, codes_all = [], []
    for off in range(0, t, chunk_samples):
        chunk = x[:, off: off + chunk_samples]
        if chunk.shape[1] % hop:
            chunk = np.pad(chunk, ((0, 0), (0, hop - chunk.shape[1] % hop)))
        codes = enc.push(chunk)
        codes_all.append(codes)
        outs.append(dec.push(codes))
    return torch.cat(outs, dim=1)[:, :t], codes_all
