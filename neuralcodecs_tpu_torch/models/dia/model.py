"""Dia 1.6B text-to-dialogue TTS, PyTorch port.

Counterpart of neuralcodecs_tpu.models.dia.model: byte-level text encoding
([S1] -> 0x01, [S2] -> 0x02), the encoder over the classifier-free-guidance
batch (row 2i the unconditional copy of request i, row 2i+1 the text),
per-layer cross-attention caches, the delay-pattern audio prefill, the
autoregressive decode loop with its EOS / delay countdown, then delay revert
and the DAC vocoder bridge.

The JAX package runs the whole loop as one ``lax.while_loop`` in one jit.
Here the host steps the loop, and a step is one function of state kept on
the device (``_LoopState``: codes buffer, countdowns, caches, the step index
and the token limit as device scalars, the noise streams), written in place.
Its shapes depend only on the batch, the buffer, the text bucket and, for
the blocked KV read, the number of blocks the step reads, which the host
knows from its own copy of the step index. On a CUDA device each step is
therefore a CUDA graph (ops/graphs.py), captured once for each such shape,
sampling constants and state slot, and replayed: the host's work for a step
is one ``replay()``. The eager step, the same function, runs on the CPU,
under tensor parallelism (its collectives stage through the host) and inside
``ops.graphs.graphs_disabled()``.

Generations interleave (a ``/tts/stream`` holds the device only for a
segment), so the captured states are a pool: a generation borrows a slot of
its shape, ``_start_state`` fills the slot's buffers, and the slot goes back
when the codes are copied out or the stream ends, a closed one included.
Any change to the weights or the cache mode (``quantize_int8`` /
``quantize_int4``, ``enable_int8_kv_cache``, ``load_state_dict``, ``.to()``)
drops the graphs and the pool, as ``release_generation_caches()`` does for
every model.

The loop's stop test (every row's countdown drained) is the one
device->host read, made once every ``_SYNC_EVERY`` steps; a step taken after
the last row finished leaves the loop state as it was. The loop state stays
on the device between calls, which makes generation resumable in segments
(``generate_codes_stream``).

Sampling draws ``argmax(logits + G)``, as ``jax.random.categorical`` does,
with Gumbel noise G from ``gumbel_noise``: one ``torch.Generator`` a batch
row, so row i's noise depends only on (seed, step, i) and batch padding
leaves the real rows' tokens unchanged.
"""

from __future__ import annotations

import itertools
import math
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.core.exceptions import LoadError
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.weights import check_keys
from neuralcodecs_tpu_torch.diagnostics.profiler import span
from neuralcodecs_tpu_torch.models.dia.audio_delay import apply_audio_delay, revert_audio_delay
from neuralcodecs_tpu_torch.models.dia.config import DiaConfig
from neuralcodecs_tpu_torch.models.dia.layers import (
    Attention,
    DenseGeneral,
    KVCacheSlot,
    MlpBlock,
    RMSNorm,
)
from neuralcodecs_tpu_torch.ops.graphs import GraphCache, graphs_enabled, step_graph

# steps between two reads of the loop's stop test, the decode loop's only
# device->host transfer; up to _SYNC_EVERY - 1 steps may run after the last
# row finished, each leaving the loop state unchanged
_SYNC_EVERY = 32


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig, device: torch.device):
        super().__init__()
        e, eps = cfg.encoder, cfg.normalization_layer_epsilon
        self.pre_sa_norm = RMSNorm(e.n_embd, eps, device)
        self.self_attention = Attention(e.n_embd, e.n_embd, e.n_head, e.n_head, e.head_dim,
                                        e.n_embd, cfg.rope_min_timescale,
                                        cfg.rope_max_timescale, device)
        self.post_sa_norm = RMSNorm(e.n_embd, eps, device)
        self.mlp = MlpBlock(e.n_embd, e.n_hidden, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention.self_attn(self.pre_sa_norm(x), positions, mask)
        return x + self.mlp(self.post_sa_norm(x))


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig, device: torch.device):
        super().__init__()
        d, e, eps = cfg.decoder, cfg.encoder, cfg.normalization_layer_epsilon
        self.pre_sa_norm = RMSNorm(d.n_embd, eps, device)
        self.self_attention = Attention(d.n_embd, d.n_embd, d.gqa_query_heads, d.kv_heads,
                                        d.gqa_head_dim, d.n_embd, cfg.rope_min_timescale,
                                        cfg.rope_max_timescale, device)
        self.pre_ca_norm = RMSNorm(d.n_embd, eps, device)
        self.cross_attention = Attention(d.n_embd, e.n_embd, d.cross_query_heads,
                                         d.cross_query_heads, d.cross_head_dim, d.n_embd,
                                         cfg.rope_min_timescale, cfg.rope_max_timescale, device)
        self.pre_mlp_norm = RMSNorm(d.n_embd, eps, device)
        self.mlp = MlpBlock(d.n_embd, d.n_hidden, device)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, causal_mask: torch.Tensor,
                cross_cache: KVCacheSlot, cross_mask: torch.Tensor,
                self_cache: KVCacheSlot) -> torch.Tensor:
        x = x + self.self_attention.self_attn(self.pre_sa_norm(x), positions, causal_mask,
                                              cache=self_cache)
        x = x + self.cross_attention.cross_attn(self.pre_ca_norm(x), positions, cross_cache,
                                                cross_mask)
        return x + self.mlp(self.pre_mlp_norm(x))

    def step(self, x: torch.Tensor, position: torch.Tensor, index: int | torch.Tensor,
             self_cache: KVCacheSlot, cross_cache: KVCacheSlot, cross_mask: torch.Tensor,
             kv_block: int = 0, kv_dot: bool = False,
             n_blocks: int | None = None) -> torch.Tensor:
        x = x + self.self_attention.step_attn(self.pre_sa_norm(x), position, self_cache, index,
                                              kv_block=kv_block, kv_dot=kv_dot,
                                              n_blocks=n_blocks)
        x = x + self.cross_attention.cross_attn(self.pre_ca_norm(x), position, cross_cache,
                                                cross_mask)
        return x + self.mlp(self.pre_mlp_norm(x))


def _embedding(rows: int, dim: int, device: torch.device) -> nn.Embedding:
    return nn.Embedding(rows, dim, _weight=torch.empty(rows, dim, device=device))


class _Encoder(nn.Module):
    def __init__(self, cfg: DiaConfig, device: torch.device):
        super().__init__()
        self.embedding = _embedding(cfg.vocab_size, cfg.encoder.n_embd, device)
        self.layers = nn.ModuleList(_EncoderLayer(cfg, device)
                                    for _ in range(cfg.encoder.n_layer))
        self.norm = RMSNorm(cfg.encoder.n_embd, cfg.normalization_layer_epsilon, device)


class _Decoder(nn.Module):
    def __init__(self, cfg: DiaConfig, device: torch.device):
        super().__init__()
        d = cfg.decoder
        self.embeddings = nn.ModuleList(_embedding(cfg.tgt_vocab_size, d.n_embd, device)
                                        for _ in range(cfg.data.channels))
        self.layers = nn.ModuleList(_DecoderLayer(cfg, device) for _ in range(d.n_layer))
        self.norm = RMSNorm(d.n_embd, cfg.normalization_layer_epsilon, device)
        self.logits_dense = DenseGeneral((d.n_embd,), (cfg.data.channels, cfg.tgt_vocab_size),
                                         device)


class _RowNoise:
    """The sampling noise of one generation: a ``torch.Generator`` a batch
    row on ``device``, seeded from (seed, row); ``draws`` counts the steps
    drawn so far."""

    def __init__(self, seed: int, rows: int, device: torch.device):
        self.rows, self.device = rows, device
        self.generators = [torch.Generator(device=device) for _ in range(rows)]
        self.reseed(seed)

    def reseed(self, seed: int) -> "_RowNoise":
        """Restart every row's stream at (seed, row), in place: a pooled
        state keeps the generators its graphs registered."""
        self.seed, self.draws = int(seed), 0
        for i, g in enumerate(self.generators):
            g.manual_seed(int(np.random.SeedSequence([self.seed, i]).generate_state(1)[0]))
        return self


def gumbel_noise(noise: _RowNoise, shape: tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel noise [rows, *shape] for step ``noise.draws``: row i's
    comes from row i's generator alone. -log(-log(U)), U uniform in
    [tiny, 1), as jax.random.gumbel."""
    u = torch.stack([torch.rand(shape, generator=g, device=noise.device)
                     for g in noise.generators])
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


@dataclass(frozen=True)
class _Sampling:
    temperature: float
    top_k: int
    top_p: float
    cfg_scale: float
    kv_block: int
    kv_dot: bool


@dataclass
class _LoopState:
    """The decode loop's state, on the model's device, every tensor written
    in place by a step; ``step`` (the position the next step decodes) is
    known on the host as well as in ``step_t``."""
    step: int
    step_t: torch.Tensor           # [1] int64, the device's copy of ``step``
    generated: torch.Tensor        # [B, maxT, C] int64, -1 = not yet written
    eos_detected: torch.Tensor     # [B] bool
    finished: torch.Tensor         # [B] int64, -1 until the row's EOS
    countdown: torch.Tensor        # [B] int64: -1 running, >0 draining, 0 done
    self_caches: list[KVCacheSlot]
    cross_caches: list[KVCacheSlot]
    cross_mask: torch.Tensor       # [2B, 1, S] bool
    invalid: torch.Tensor          # [C, V] bool: tokens no channel may sample
    delay: torch.Tensor            # [C] int64
    noise: _RowNoise
    token_limit: torch.Tensor      # 0-d int64: EOS forced from token_limit - max_delay
    last_prefill: torch.Tensor     # 0-d int64: the last row's first decode position
    # under tp: whether the ranks ever sampled different tokens (0-d bool)
    disagree: torch.Tensor | None = None
    # a pooled slot's: its pool key, and its graphs by block count for the
    # generation's sampling constants (None: the steps run eagerly)
    key: tuple | None = None
    slot_id: int = -1
    owner: object = None
    graphs: dict | None = None


def _tensors(st: _LoopState) -> list[torch.Tensor]:
    caches = [t for c in st.self_caches + st.cross_caches
              for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]
    return [st.step_t, st.generated, st.eos_detected, st.finished, st.countdown,
            st.cross_mask, st.invalid, st.delay, st.token_limit, st.last_prefill, *caches]


class _StatePool:
    """A model's captured decode states: free slots by (batch, buffer, text
    bucket, int8 cache, compute dtype), the step graphs of every slot in one
    GraphCache (one memory pool), and the bytes the slots hold."""

    def __init__(self, device: torch.device):
        self.free: dict[tuple, list[_LoopState]] = {}
        self.graphs = GraphCache(device)
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.slots = 0
        self.state_bytes = 0

    def borrow(self, key: tuple) -> _LoopState | None:
        with self.lock:
            free = self.free.get(key)
            return free.pop() if free else None

    def give_back(self, st: _LoopState) -> None:
        st.graphs = None
        with self.lock:
            self.free.setdefault(st.key, []).append(st)

    def adopt(self, st: _LoopState, key: tuple) -> None:
        """Count a newly made state as the pool's."""
        st.key, st.slot_id, st.owner = key, next(self.ids), self
        with self.lock:
            self.slots += 1
            self.state_bytes += sum(t.numel() * t.element_size() for t in _tensors(st))

    def stats(self) -> dict:
        """Slots made, their GB (which only grows until the pool is
        dropped), graphs captured and their capture seconds."""
        return {"slots": self.slots, "state_gb": self.state_bytes / 1e9,
                "graphs": len(self.graphs.graphs), "capture_s": self.graphs.capture_s}


# every Dia made, for release_generation_caches()
_MODELS: "weakref.WeakSet[Dia]" = weakref.WeakSet()


def _decoder_receptive_field_frames(rates: Sequence[int],
                                    res_dilations: tuple[int, ...] = (1, 3, 9),
                                    res_kernel: int = 7) -> int:
    """One-sided receptive field of a DAC-style decoder in input frames
    (copy of neuralcodecs_tpu.ops.chunking.decoder_receptive_field_frames
    with its input conv). Conservative."""
    rf = (res_kernel - 1) / 2
    u = 1.0
    res_extent = sum((res_kernel - 1) * d // 2 for d in res_dilations)
    for s in rates:
        rf += 2.0 / u
        u *= s
        rf += res_extent / u
    rf += res_kernel / u
    return int(rf) + 2


def _bucket(requested: int, ceiling: int) -> int:
    """The generation buffer's default bucket: the next power of two from 64
    up, or the model's own ceiling if that is smaller."""
    pad = 64
    while pad < requested:
        pad *= 2
    return min(pad, max(ceiling, requested))


class Dia(nn.Module):
    """Public Dia TTS model.

    Parameter names are the JAX package's keys (``encoder.layers.3.
    self_attention.q_proj.weight`` ...). Weights are random from ``seed``,
    drawn on ``device`` ("cuda" when none is given) by one generator, until
    ``load_state_dict`` loads a checkpoint.

    ``compute_dtype`` is torch.float32, the JAX package's default;
    torch.bfloat16, its serving mode: parameters stay f32 (each
    DenseGeneral keeps a bf16 copy of its weight), activations and the
    self-attention caches are bf16, attention scores, norms and RoPE f32;
    or torch.float64: a reference mode that holds the parameters,
    activations and caches in f64 to measure the other modes' rounding. The
    sampler takes f32 logits in all three; int8 weights and KV codes are
    quantized from f32 values and dequantized to the compute dtype.

    ``parallel.sharding.shard_params(mesh, dia)`` makes it tensor-parallel
    over the mesh's tp ranks (``tp_group``): each rank computes its heads
    and its slice of each MLP, and caches its heads' K/V only. The ranks
    draw the same noise from the same seed and so sample the same token;
    the loop checks that they do at every stop test and at its end, and
    raises if they ever did not."""

    tp_group = None

    def __init__(self, config: DiaConfig | None = None, *,
                 device: torch.device | str | None = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32, torch.float64):
            raise NotImplementedError(
                f"Dia compute_dtype {compute_dtype}: the modes are torch.bfloat16, "
                "torch.float32 and torch.float64 (the reference mode)")
        self.config = config or DiaConfig()
        self.compute_dtype = compute_dtype
        device = resolve_device(device)
        self.encoder = _Encoder(self.config, device)
        self.decoder = _Decoder(self.config, device)
        self.requires_grad_(False)
        self._reset_parameters(seed)
        if compute_dtype == torch.float64:
            self.double()   # the f32 draws of this seed, widened
        # the vocoder stays outside the module tree: its weights are not Dia's
        self.__dict__["dac"] = None
        # int8 self-attention KV cache (serving)
        self.kv_cache_int8 = False
        # blocked decode KV read: None = auto (block 512 once the generation
        # buffer reaches 1024), 0 = read the slots at once, N = block size
        self.kv_read_block: int | None = None
        # integer dots against the int8 cache; needs the int8 cache and a
        # blocked read, ignored otherwise (with a notice)
        self.kv_dot_int8 = False
        self._notices_seen: set[str] = set()
        _MODELS.add(self)

    @property
    def device(self) -> torch.device:
        return self.decoder.norm.weight.device

    @torch.no_grad()
    def _reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def layer(mod: nn.Module) -> None:
            for m in mod.modules():
                if isinstance(m, DenseGeneral):
                    m.reset_parameters(gen)

        self.encoder.embedding.weight.normal_(0.0, 1.0, generator=gen).mul_(0.02)
        for enc_layer in self.encoder.layers:
            layer(enc_layer)
        for emb in self.decoder.embeddings:
            emb.weight.normal_(0.0, 1.0, generator=gen).mul_(0.02)
        for dec_layer in self.decoder.layers:
            layer(dec_layer)
        self.decoder.logits_dense.reset_parameters(gen)

    # ------------------------------------------------------------ options

    def _notice_once(self, msg: str) -> None:
        """stderr notice, once a model instance."""
        if msg not in self._notices_seen:
            self._notices_seen.add(msg)
            print(msg, file=sys.stderr)

    def _resolve_kv_block(self, buffer_len: int) -> int:
        explicit = self.kv_read_block is not None
        blk = int(self.kv_read_block) if explicit else (512 if buffer_len >= 1024 else 0)
        if blk and buffer_len % blk:
            if explicit:
                self._notice_once(
                    f"dia: kv_read_block={blk} does not divide the generation buffer "
                    f"({buffer_len}); falling back to the full-cache read")
            blk = 0
        return blk

    def _resolve_kv_dot(self, buffer_len: int) -> bool:
        """The int8-dot read applies only on the blocked path over an int8
        cache."""
        active = bool(self.kv_dot_int8 and self.kv_cache_int8
                      and self._resolve_kv_block(buffer_len))
        if self.kv_dot_int8 and self.kv_cache_int8 and not active:
            self._notice_once(
                f"dia: kv_dot_int8 is inactive for this generation buffer ({buffer_len}: "
                f"blocked KV read is off); running the dequant read instead")
        return active

    def enable_int8_kv_cache(self, enabled: bool = True) -> "Dia":
        """Store the decode self-attention KV cache as int8 (+ per-position
        scales)."""
        self.release_graphs()
        self.kv_cache_int8 = bool(enabled)
        return self

    # ------------------------------------------------------------ graphs

    def _graphed(self) -> bool:
        """Whether generation replays captured steps: a CUDA device, no
        tensor parallelism, graphs not turned off."""
        return self.tp_group is None and graphs_enabled(self.device)

    def _state_pool(self) -> _StatePool:
        pool = self.__dict__.get("_pool")
        if pool is None:
            pool = self.__dict__["_pool"] = _StatePool(self.device)
        return pool

    def graph_stats(self) -> dict:
        """The state pool's slots, GB, graphs and capture seconds."""
        pool = self.__dict__.get("_pool")
        return pool.stats() if pool is not None else _StatePool(self.device).stats()

    def release_graphs(self) -> None:
        """Drop every captured step and the state pool: the weights or the
        cache mode they were captured with changed."""
        self.__dict__["_pool"] = None

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .double() ...: the graphs read the old storage
        self.release_graphs()
        return super()._apply(fn, *args, **kwargs)

    # ------------------------------------------------------------ weights

    def load_state_dict(self, state_dict, assign: bool = False):
        """Load a Dia checkpoint: numpy arrays or tensors, keys with or
        without upstream's ``model.`` prefix. Keys the model lacks are
        ignored; a key it needs and the checkpoint lacks raises LoadError."""
        self.release_graphs()
        sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
        tensors = {}
        for key in self.state_dict():
            if key not in sd:
                raise LoadError(f"Missing key in checkpoint: {key}")
            value = sd[key]
            tensors[key] = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.array(value))
        return super().load_state_dict(tensors, strict=True, assign=assign)

    def load_upstream_state_dict(self, state_dict) -> "Dia":
        """The loader's checkpoint entry: ``load_state_dict`` (Dia's
        checkpoint names and layouts are the port's own). Returns self."""
        self.load_state_dict(state_dict)
        return self

    def native_state_dict(self) -> dict[str, np.ndarray]:
        """The weights as numpy arrays for ``save_pretrained``: the JAX
        package's layouts are the port's, so nothing is converted. A
        quantized model has no native export."""
        sd = self.state_dict()
        if any(k.endswith(("weight_q8", "weight_q4")) for k in sd):
            raise NotImplementedError("save_pretrained of a quantized Dia: export the f32 "
                                      "model, then quantize after loading")
        return {k: v.cpu().numpy() for k, v in sd.items()}

    def load_native_state_dict(self, tensors) -> "Dia":
        """Load a native export: every key of the model, and no other."""
        check_keys(self, tensors, strict=True)
        self.load_state_dict(tensors)
        return self

    def _dense_layers(self) -> list[DenseGeneral]:
        return [m for layers in (self.encoder.layers, self.decoder.layers)
                for m in layers.modules() if isinstance(m, DenseGeneral)]

    def quantize_int8(self) -> "Dia":
        """Weight-only int8 of every DenseGeneral kernel, on the device and in
        place: each f32 kernel is freed as its int8 form lands."""
        self.release_graphs()
        for dense in (*self._dense_layers(), self.decoder.logits_dense):
            dense.quantize_int8()
        return self

    def quantize_int4(self, group_size: int = 128) -> "Dia":
        """Weight-only int4 (nibble-packed, group-wise scales) of the
        transformer kernels; the logits head, which shapes the sampling
        distribution, takes int8. On the device and in place."""
        self.release_graphs()
        for dense in self._dense_layers():
            dense.quantize_int4(group_size)
        self.decoder.logits_dense.quantize_int8()
        return self

    # ------------------------------------------------------------ text

    def encode_text(self, text: str) -> np.ndarray:
        """UTF-8 bytes with [S1]/[S2] speaker tags -> token ids."""
        raw = text.encode("utf-8").replace(b"[S1]", b"\x01").replace(b"[S2]", b"\x02")
        return np.frombuffer(raw[:self.config.data.text_length], dtype=np.uint8).astype(np.int64)

    def _pad_text(self, token_lists: Sequence[np.ndarray], pad_to: int | None = None) -> np.ndarray:
        """Pad token lists to a power-of-two length bucket (floor 64, at most
        ``text_length``); ``pad_to`` pins the length, truncating longer
        prompts. Padded positions carry no attention weight."""
        cfg = self.config.data
        if pad_to is None:
            longest = max((len(t) for t in token_lists), default=0)
            pad_to = 64
            while pad_to < min(longest, cfg.text_length):
                pad_to *= 2
        pad_to = min(max(pad_to, 1), cfg.text_length)
        out = np.full((len(token_lists), pad_to), cfg.text_pad_value, np.int64)
        for i, tokens in enumerate(token_lists):
            n = min(len(tokens), pad_to)
            out[i, :n] = tokens[:n]
        return out

    # ------------------------------------------------------------ parts

    def _encode_fn(self, enc_input: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        """enc_input: [2B, S]; padding_mask: [2B, S] bool (True = real
        token) -> encoder output [2B, S, D]."""
        x = self.encoder.embedding(enc_input).to(self.compute_dtype)
        positions = torch.arange(enc_input.shape[1], device=enc_input.device)[None, :]
        mask = padding_mask[:, :, None] & padding_mask[:, None, :]
        for layer in self.encoder.layers:
            x = layer(x, positions, mask)
        return self.encoder.norm(x)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: [2B, T, C] -> summed channel embeddings [2B, T, D]."""
        x = None
        for c, emb in enumerate(self.decoder.embeddings):
            e = emb(tokens[..., c])
            x = e if x is None else x + e
        return x.to(self.compute_dtype)

    def _decoder_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder.logits_dense(self.decoder.norm(x))  # [2B, T, C, V]

    # ------------------------------------------------------------ generation

    @torch.no_grad()
    def _start_state(self, text_tokens: np.ndarray, prefill: torch.Tensor,
                     prefill_steps: np.ndarray, seed: int, row_active: np.ndarray, *,
                     max_tokens: int, token_limit: int | None = None,
                     kv_int8: bool = False, into: _LoopState | None = None) -> _LoopState:
        """Encoder, cross caches and decoder prefill -> the loop state of a
        ``max_tokens`` buffer, EOS forced at ``token_limit`` (default the
        buffer). ``into``: a pooled state of the same shapes whose buffers
        are filled in place (and returned) instead of new ones."""
        cfg, data, dev = self.config, self.config.data, self.device
        b = text_tokens.shape[0]
        channels, eos, pad = data.channels, data.audio_eos_value, data.audio_pad_value

        # encoder + cross caches over the CFG batch, [uncond; cond] interleaved
        with span("dia.encode", device=dev):
            text = torch.as_tensor(text_tokens, dtype=torch.int64, device=dev)
            enc_input = torch.stack([torch.zeros_like(text), text], dim=1).reshape(2 * b, -1)
            padding_mask = enc_input != data.text_pad_value
            enc_out = self._encode_fn(enc_input, padding_mask)
            enc_positions = torch.arange(enc_input.shape[1], device=dev)[None, :]
            cross_caches = [layer.cross_attention.precompute_cross_cache(enc_out, enc_positions,
                                                                         padding_mask)
                            for layer in self.decoder.layers]
            cross_mask = padding_mask[:, None, :]

        with span("dia.prefill", device=dev):
            d = cfg.decoder
            if into is None:
                self_caches = [KVCacheSlot.zeros(2 * b, max_tokens, layer.self_attention.n_kv,
                                                 d.gqa_head_dim, self.compute_dtype,
                                                 quantized=kv_int8, device=dev)
                               for layer in self.decoder.layers]
                generated = torch.full((b, max_tokens, channels), -1, dtype=torch.int64,
                                       device=dev)
            else:
                self_caches, generated = into.self_caches, into.generated.fill_(-1)
                for cache in self_caches:
                    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
                        if t is not None:
                            t.zero_()
            t_pre = prefill.shape[1]
            generated[:, :t_pre] = prefill

            # prefill pass over the whole prompt block, causally masked
            pre_tokens = generated[:, None, :t_pre].expand(b, 2, t_pre, channels).reshape(
                2 * b, t_pre, channels)
            pre_tokens = torch.where(pre_tokens < 0, pad, pre_tokens)
            positions = torch.arange(t_pre, device=dev)[None, :]
            causal = torch.ones(t_pre, t_pre, dtype=torch.bool, device=dev).tril()
            causal = causal[None].expand(2 * b, t_pre, t_pre)
            x = self._embed_tokens(pre_tokens)
            cross_mask_pre = cross_mask.expand(2 * b, t_pre, enc_input.shape[1])
            for layer, cross, cache in zip(self.decoder.layers, cross_caches, self_caches):
                x = layer.prefill(x, positions, causal, cross, cross_mask_pre, cache)

        vocab = torch.arange(cfg.tgt_vocab_size, device=dev)[None, :]
        first = torch.arange(channels, device=dev)[:, None] == 0
        # batch-padding rows start with countdown 0 ("already finished") so
        # they never hold the loop open past the real rows' EOS
        active = torch.as_tensor(row_active, device=dev)
        step = int(prefill_steps.min()) - 1
        st = _LoopState(
            step=step, step_t=torch.tensor([step], dtype=torch.int64, device=dev),
            generated=generated,
            eos_detected=torch.zeros(b, dtype=torch.bool, device=dev),
            finished=torch.full((b,), -1, dtype=torch.int64, device=dev),
            countdown=torch.where(active, -1, 0).to(torch.int64),
            self_caches=self_caches, cross_caches=cross_caches, cross_mask=cross_mask,
            invalid=(vocab > eos) | (~first & (vocab >= eos)),
            delay=torch.tensor(data.delay_pattern, dtype=torch.int64, device=dev),
            noise=_RowNoise(seed, b, dev) if into is None else into.noise.reseed(seed),
            token_limit=torch.tensor(max_tokens if token_limit is None else token_limit,
                                     dtype=torch.int64, device=dev),
            last_prefill=torch.tensor(int(prefill_steps.max()), dtype=torch.int64, device=dev),
            disagree=None if self.tp_group is None else torch.zeros((), dtype=torch.bool,
                                                                   device=dev))
        if into is None:
            return st
        for name in ("step_t", "eos_detected", "finished", "countdown", "cross_mask", "invalid",
                     "delay", "token_limit", "last_prefill"):
            getattr(into, name).copy_(getattr(st, name))
        for dst, src in zip(into.cross_caches, cross_caches):
            dst.k.copy_(src.k)
            dst.v.copy_(src.v)
        into.step = step
        return into

    def _decode_step(self, st: _LoopState, s: _Sampling, n_blocks: int | None = None) -> None:
        """One step of the loop at position ``st.step_t``, every state
        tensor written in place; the host's ``st.step`` is left to the
        caller (``_advance``). Reads nothing back from the device, and its
        shapes depend on ``n_blocks`` (the blocks the blocked KV read takes;
        by default what ``st.step`` needs) and not on the step, so it is the
        function the step graphs capture. Once every row's countdown is 0 a
        step changes no state: no row is active, so nothing triggers or
        drains, and the token writeback keeps what is there; the cache slot
        it writes lies past every step taken, which no later step reads."""
        data = self.config.data
        eos, pad = data.audio_eos_value, data.audio_pad_value
        max_delay = max(data.delay_pattern)
        if s.kv_block and n_blocks is None:
            n_blocks = st.step // s.kv_block + 1
        b, _, channels = st.generated.shape

        tokens = st.generated.index_select(1, st.step_t).expand(b, 2, channels)
        tokens = tokens.reshape(2 * b, channels)
        tokens = torch.where(tokens < 0, pad, tokens)[:, None]             # [2B, 1, C]
        position = st.step_t.expand(2 * b, 1)
        x = self._embed_tokens(tokens)
        for layer, self_cache, cross in zip(self.decoder.layers, st.self_caches,
                                            st.cross_caches):
            x = layer.step(x, position, st.step_t, self_cache, cross, st.cross_mask,
                           kv_block=s.kv_block, kv_dot=s.kv_dot, n_blocks=n_blocks)
        logits = self._decoder_logits(x)[:, -1].reshape(b, 2, channels, -1).to(torch.float32)
        uncond, cond = logits[:, 0], logits[:, 1]
        logits = cond + s.cfg_scale * (cond - uncond)                     # [B, C, V]
        logits = logits.masked_fill(st.invalid, -math.inf)
        logits[:, 0, eos] *= 0.8

        noise = None
        if s.temperature >= 1e-5:
            noise = gumbel_noise(st.noise, tuple(logits.shape[1:]))
        pred = _sample_next_token(logits.reshape(b * channels, -1),
                                  None if noise is None else noise.reshape(b * channels, -1),
                                  s.temperature, s.top_k, s.top_p, eos).reshape(b, channels)
        if st.disagree is not None:
            from neuralcodecs_tpu_torch.parallel.collectives import disagree

            st.disagree |= disagree(pred, self.tp_group)

        # EOS detection and the delay countdown
        done = torch.all(st.countdown == 0)
        step_idx = st.step_t + 1
        active = st.countdown != 0
        is_eos = ~st.eos_detected & (pred[:, 0] == eos) & active
        trigger = active & (is_eos | (step_idx >= st.token_limit - max_delay))
        st.eos_detected |= trigger
        start = trigger & (st.countdown < 0)
        st.countdown.copy_(torch.where(start, max_delay, st.countdown))
        st.finished.copy_(torch.where(start, step_idx, st.finished))
        draining = st.countdown > 0
        step_after = (max_delay - st.countdown)[:, None]
        pred = torch.where(draining[:, None] & (step_after == st.delay), eos, pred)
        pred = torch.where(draining[:, None] & (step_after > st.delay), pad, pred)
        st.countdown.sub_(draining.to(torch.int64))

        # BOS-protected writeback: prompt tokens stay until the prefill's
        # delayed channels are past (JAX's bos_over)
        existing = st.generated.index_select(1, step_idx)[:, 0]
        bos_over = (st.step_t - st.last_prefill) > max_delay
        keep = done | ((existing != -1) & ~bos_over)
        st.generated.index_copy_(1, step_idx, torch.where(keep, existing, pred)[:, None])
        st.step_t.add_(1)

    def _advance(self, st: _LoopState, s: _Sampling) -> None:
        """One step: the replay of the graph of the step's block count, or
        the eager step; then the host's copy of the step and the draws."""
        if st.graphs is None:
            self._decode_step(st, s)
        else:
            st.graphs[st.step // s.kv_block + 1 if s.kv_block else 0].replay()
        st.step += 1
        st.noise.draws += 1

    @torch.no_grad()
    def _run_loop(self, st: _LoopState, stop: int, s: _Sampling) -> None:
        """Step until position ``stop`` (exclusive) or until every row's
        countdown has drained, which is read once every ``_SYNC_EVERY``
        steps."""
        with span("dia.loop", device=st.generated.device) as loop:
            n = 0
            while st.step < stop:
                if n % _SYNC_EVERY == 0 and self._stop_test(st):
                    break
                self._advance(st, s)
                n += 1
            else:
                if st.disagree is not None:
                    self._stop_test(st)
            graphed = st.graphs is not None
            loop.set(replays=n if graphed else 0, eager_steps=0 if graphed else n)

    @staticmethod
    def _stop_test(st: _LoopState) -> bool:
        """Whether every row's countdown has drained: one device read. Under
        tp it also reads whether the ranks ever sampled different tokens,
        which every rank knows alike (it comes out of an all-reduce), so all
        of them raise at the same step."""
        if st.disagree is None:
            return bool(torch.all(st.countdown == 0))
        done, differ = torch.stack([torch.all(st.countdown == 0), st.disagree]).tolist()
        if differ:
            raise RuntimeError(f"tensor-parallel ranks sampled different tokens by step "
                               f"{st.step}")
        return bool(done)

    @torch.no_grad()
    def _loop_state(self, text_arr: np.ndarray, delayed: torch.Tensor,
                    prefill_steps: np.ndarray, seed: int, row_active: np.ndarray,
                    buffer_len: int, token_limit: int, s: _Sampling) -> _LoopState:
        """A generation's started state. Graphed: a slot of the pool,
        filled, with its graphs for ``s`` (captured now if the slot has none:
        the captures' warm-up steps run on the slot, which is then filled
        again); give it back with ``_release_state``. Else a new state."""
        kw = dict(max_tokens=buffer_len, token_limit=token_limit, kv_int8=self.kv_cache_int8)
        args = (text_arr, delayed, prefill_steps, seed, row_active)
        if not self._graphed():
            return self._start_state(*args, **kw)
        pool = self._state_pool()
        key = (text_arr.shape[0], buffer_len, text_arr.shape[1], self.kv_cache_int8,
               self.compute_dtype)
        slot = pool.borrow(key)
        # a slot outlives the thread and mode that made it: its tensors are
        # normal ones even when made under inference_mode (a server thread)
        with torch.inference_mode(False), torch.no_grad():
            st = self._start_state(*args, **kw, into=slot)
        if slot is None:
            pool.adopt(st, key)
        try:
            counts = list(range(1, buffer_len // s.kv_block + 1)) if s.kv_block else [0]
            missing = [n for n in counts if (st.slot_id, s, n) not in pool.graphs.graphs]
            # a greedy step draws no noise: its graphs need no generator
            generators = st.noise.generators if s.temperature >= 1e-5 else ()
            for n in missing:
                pool.graphs.get((st.slot_id, s, n), lambda handle, n=n: step_graph(
                    lambda: self._decode_step(st, s, n or None), handle,
                    generators=generators))
            if missing:
                self._start_state(*args, **kw, into=st)
            st.graphs = {n: pool.graphs.graphs[(st.slot_id, s, n)] for n in counts}
        except BaseException:
            pool.give_back(st)
            raise
        return st

    def _release_state(self, st: _LoopState) -> None:
        """Give a pooled state back (a new state is left to the collector)."""
        pool = self.__dict__.get("_pool")
        if pool is not None and st.owner is pool:
            pool.give_back(st)

    def _sampling(self, buffer_len: int, temperature, top_k, top_p, cfg_scale) -> _Sampling:
        cfg = self.config
        return _Sampling(
            temperature=float(cfg.temperature if temperature is None else temperature),
            top_k=int(cfg.top_k if top_k is None else top_k),
            top_p=float(cfg.top_p if top_p is None else top_p),
            cfg_scale=float(cfg.cfg_scale if cfg_scale is None else cfg_scale),
            kv_block=self._resolve_kv_block(buffer_len),
            kv_dot=self._resolve_kv_dot(buffer_len))

    def _prefill(self, prompts: Sequence[np.ndarray | None], b: int) -> tuple[torch.Tensor,
                                                                            np.ndarray]:
        """The delayed prefill block [B, T, C] on the device (BOS, then each
        audio prompt, -1 elsewhere) and each row's first decode position."""
        data = self.config.data
        max_delay = max(data.delay_pattern)
        prompt_len = max((0 if p is None else len(p) for p in prompts), default=0)
        t_pre = prompt_len + max_delay
        prefill = np.full((b, max(t_pre, max_delay + 1), data.channels), -1, np.int64)
        prefill[:, 0, :] = data.audio_bos_value
        prefill_steps = np.ones((b,), np.int32)
        for i, prompt in enumerate(prompts):
            if prompt is not None:
                prefill[i, 1:1 + len(prompt)] = np.asarray(prompt)
                prefill_steps[i] = len(prompt) + 1
        delayed = apply_audio_delay(torch.as_tensor(prefill, device=self.device), -1,
                                    data.audio_bos_value, data.delay_pattern)
        return delayed, prefill_steps

    @torch.no_grad()
    def _generate(self, texts: Sequence[str], *, max_tokens: int | None = None,
                  cfg_scale: float | None = None, temperature: float | None = None,
                  top_p: float | None = None, top_k: int | None = None,
                  audio_prompts: Sequence[np.ndarray] | None = None, seed: int = 0,
                  pad_text_to: int | None = None, pad_tokens_to: int | None = None,
                  pad_batch_to: int | None = None):
        """The one-shot loop: (final state, prefill steps, real batch size).
        The state may be a pooled one: ``_release_state`` it once read."""
        data = self.config.data
        requested = int(max_tokens or data.audio_length)
        if pad_tokens_to is None:
            pad_tokens_to = _bucket(requested, data.audio_length)
        buffer_len = max(int(pad_tokens_to), requested)
        b_real = len(texts)
        if pad_batch_to is None:
            pad_batch_to = 1
            while pad_batch_to < b_real:
                pad_batch_to *= 2
        b = max(int(pad_batch_to), b_real)
        texts = list(texts) + [""] * (b - b_real)
        prompts = list(audio_prompts or []) + [None] * (b - len(audio_prompts or []))
        text_arr = self._pad_text([self.encode_text(t) for t in texts], pad_to=pad_text_to)
        delayed, prefill_steps = self._prefill(prompts, b)
        if b_real and b > b_real:
            # batch-padding rows must not pull the loop's start step (min
            # over prefill_steps) below the real rows' minimum
            prefill_steps[b_real:] = prefill_steps[:b_real].min()
        sampling = self._sampling(buffer_len, temperature, top_k, top_p, cfg_scale)
        st = self._loop_state(text_arr, delayed, prefill_steps, seed, np.arange(b) < b_real,
                              buffer_len, requested, sampling)
        try:
            self._run_loop(st, buffer_len - 1, sampling)
        except BaseException:
            self._release_state(st)
            raise
        return st, prefill_steps, b_real

    def _codes(self, st: _LoopState, prefill_steps: np.ndarray, b: int):
        """Delay-reverted codes [b, L, C] int32, lengths [b] int32 and
        finished steps [b] of a finished loop's first ``b`` rows."""
        data = self.config.data
        max_delay = max(data.delay_pattern)
        generated = st.generated[:b].cpu().numpy()
        finished = st.finished[:b].cpu().numpy()
        # only batch-padding rows (sliced off here) can end the loop unfinished
        finished = np.where(finished == -1, st.step + 1 - max_delay, finished)
        lengths = np.clip(finished - prefill_steps[:b], 0, None).astype(np.int32)
        max_len = int(lengths.max()) + max_delay if b else 0
        codes_batch = np.full((b, max(max_len, 1), data.channels), data.audio_pad_value, np.int64)
        for i in range(b):
            start = int(prefill_steps[i])
            actual = int(lengths[i]) + max_delay
            codes_batch[i, :actual] = generated[i, start:start + actual]
        reverted = revert_audio_delay(torch.from_numpy(codes_batch), data.audio_pad_value,
                                      data.delay_pattern).numpy()
        if max_len > max_delay:
            reverted = reverted[:, :-max_delay]
        reverted = np.where((reverted < 0) | (reverted > 1023), 0, reverted)
        return reverted.astype(np.int32), lengths, finished

    def generate_codes(self, texts: Sequence[str], *, max_tokens: int | None = None,
                       cfg_scale: float | None = None, temperature: float | None = None,
                       top_p: float | None = None, top_k: int | None = None,
                       audio_prompts: Sequence[np.ndarray] | None = None,
                       seed: int = 0, verbose: bool = False,
                       pad_text_to: int | None = None,
                       pad_tokens_to: int | None = None,
                       pad_batch_to: int | None = None):
        """Generate delay-reverted DAC codes per batch item.

        Returns (codes [B, L, C] int32 in [0, 1023], lengths [B] int32).

        The three ``pad_*_to`` knobs pin the shapes (text length, generation
        buffer, batch); by default each is bucketed to a power of two. The
        buckets change no token: EOS is still forced at ``max_tokens``,
        batch-padding rows never hold the loop open and are sliced off, text
        padding carries no attention weight, and each row draws its own
        noise."""
        start_time = time.perf_counter()
        with span("dia.generate"):
            st, prefill_steps, b = self._generate(
                texts, max_tokens=max_tokens, cfg_scale=cfg_scale, temperature=temperature,
                top_p=top_p, top_k=top_k, audio_prompts=audio_prompts, seed=seed,
                pad_text_to=pad_text_to, pad_tokens_to=pad_tokens_to,
                pad_batch_to=pad_batch_to)
            try:
                codes, lengths, finished = self._codes(st, prefill_steps, b)
            finally:
                self._release_state(st)
        if verbose:
            # 86 tokens = 1 s of audio
            elapsed = time.perf_counter() - start_time
            steps = int(finished.max()) if finished.size else 0
            if elapsed > 0 and steps > 0:
                print(f"generate: {steps} steps in {elapsed:.2f}s = "
                      f"{steps * b / elapsed:.1f} tokens/s, "
                      f"realtime factor {steps / 86.0 / elapsed:.2f}x")
        return codes, lengths

    def generate_codes_stream(self, text: str, *, segment_tokens: int = 64,
                              max_tokens: int | None = None,
                              cfg_scale: float | None = None,
                              temperature: float | None = None,
                              top_p: float | None = None,
                              top_k: int | None = None,
                              audio_prompt: np.ndarray | None = None,
                              seed: int = 0, pad_text_to: int | None = None,
                              pad_tokens_to: int | None = None):
        """Incremental generation for ONE text: yields ``(codes_block, done)``.

        Each ``codes_block`` is [n, C] int32 delay-reverted DAC codes; their
        concatenation is ``generate_codes([text])``'s codes for the same seed
        and buckets (the loop state, noise streams included, stays on the
        device between segments). A frame is emitted once all of its delayed
        channels are decoded, ``max(delay_pattern)`` steps behind the head.
        A pooled state goes back when the stream ends or is closed."""
        data = self.config.data
        channels = data.channels
        requested = int(max_tokens or data.audio_length)
        if pad_tokens_to is None:
            pad_tokens_to = _bucket(requested, data.audio_length)
        buffer_len = max(int(pad_tokens_to), requested)
        text_arr = self._pad_text([self.encode_text(text)], pad_to=pad_text_to)
        max_delay = max(data.delay_pattern)
        delayed, prefill_steps = self._prefill([audio_prompt], 1)
        sampling = self._sampling(buffer_len, temperature, top_k, top_p, cfg_scale)
        st = self._loop_state(text_arr, delayed, prefill_steps, seed, np.ones(1, bool),
                              buffer_len, requested, sampling)
        try:
            start = int(prefill_steps[0])
            emitted = 0
            while True:
                self._run_loop(st, min(st.step + int(segment_tokens), buffer_len - 1), sampling)
                done = st.step >= buffer_len - 1 or bool(torch.all(st.countdown == 0))
                if done:
                    finished = int(st.finished[0])
                    if finished == -1:
                        finished = st.step + 1 - max_delay
                    frames_avail = max(finished - start, 0)
                else:
                    # frame f is complete once row start+f+max_delay is written
                    frames_avail = max(st.step - start - max_delay + 1, 0)
                if frames_avail > emitted or done:
                    gen = st.generated[0].cpu().numpy()  # [maxT, C]
                    block = np.zeros((frames_avail - emitted, channels), np.int64)
                    for c, dly in enumerate(data.delay_pattern):
                        lo = start + emitted + dly
                        block[:, c] = gen[lo:lo + frames_avail - emitted, c]
                    block = np.where((block < 0) | (block > 1023), 0, block)
                    if done:
                        self._release_state(st)
                        st = None
                    yield block.astype(np.int32), done
                    emitted = frames_avail
                if done:
                    return
        finally:
            if st is not None:
                self._release_state(st)

    # ------------------------------------------------------------ vocoder

    def _require_dac(self):
        if self.dac is None:
            raise RuntimeError("No DAC vocoder attached; call load_dac_model()/set_dac_model()")
        return self.dac

    def generate(self, texts: Sequence[str], audio_prompt_paths: Sequence[str] | None = None,
                 **kwargs) -> list[np.ndarray]:
        """Full TTS: text -> waveforms through the DAC vocoder.
        ``audio_prompt_paths`` are WAV voice-clone prompts, DAC-encoded on
        the fly."""
        dac = self._require_dac()
        if audio_prompt_paths:
            kwargs.setdefault("audio_prompts",
                              [self.load_audio_prompt(p) for p in audio_prompt_paths])
        codes, lengths = self.generate_codes(texts, **kwargs)
        # items of equal code length vocode as ONE batched DAC decode (a
        # served burst shares max_tokens, so its streams usually end
        # together); grouping by exact length adds no padding to any stream
        by_len: dict[int, list[int]] = {}
        for i in range(codes.shape[0]):
            by_len.setdefault(max(int(lengths[i]), 1), []).append(i)
        wavs: dict[int, torch.Tensor] = {}
        for length, idxs in by_len.items():
            stacked = np.stack([codes[i, :length].T for i in idxs])  # [G, C, L]
            decoded = dac.from_codes(stacked)                        # [G, L·hop]
            for g, i in enumerate(idxs):
                wavs[i] = decoded[g]
        audios = []
        sr = self.config.sample_rate
        for i in range(codes.shape[0]):
            wav = wavs[i]
            factor = self._speed_factor(len(texts[i]))
            if abs(factor - 1.0) > 1e-6:
                from neuralcodecs_tpu_torch.dsp.resample import resample_poly

                wav = resample_poly(wav, int(sr * factor), sr)
            audios.append(wav.cpu().numpy())
        return audios

    def generate_stream(self, text: str, *, audio_prompt_path: str | None = None, **kwargs):
        """Streaming TTS: yields ``(sample_rate, audio_chunk)`` f32 arrays.

        Each code segment is vocoded with a halo of the decoder's receptive
        field on both sides, so interior samples match the one-shot
        ``generate`` decode; audio lags the code head by one halo. The
        dynamic slowdown (``_speed_factor``) is not applied on this path."""
        dac = self._require_dac()
        dcfg = dac.config
        halo = _decoder_receptive_field_frames(list(dcfg.decoder_rates))
        hop, sr = dcfg.hop_length, dcfg.sample_rate
        if audio_prompt_path is not None:
            kwargs.setdefault("audio_prompt", self.load_audio_prompt(audio_prompt_path))
        codes_buf = np.zeros((0, self.config.data.channels), np.int32)
        sent = 0  # frames whose audio has been yielded
        for block, done in self.generate_codes_stream(text, **kwargs):
            codes_buf = np.concatenate([codes_buf, block], axis=0)
            total = len(codes_buf)
            emit_to = total if done else max(total - halo, sent)
            if emit_to > sent or (done and total == 0):
                if total == 0:
                    yield sr, np.zeros((0,), np.float32)
                    return
                lo = max(sent - halo, 0)
                hi = min(total, emit_to + halo)
                audio = dac.from_codes(codes_buf[lo:hi].T[None])[0]
                chunk = audio[(sent - lo) * hop:(emit_to - lo) * hop]
                yield sr, chunk.cpu().numpy().astype(np.float32)
                sent = emit_to

    def _speed_factor(self, text_length: int) -> float:
        """Dynamic slowdown factor of a text's audio."""
        cfg = self.config
        if cfg.slowdown_mode == "static":
            return cfg.static_slowdown_factor
        if text_length <= cfg.dynamic_slowdown_start_length:
            return 1.0
        frac = min(1.0, (text_length - cfg.dynamic_slowdown_start_length)
                   / (cfg.dynamic_slowdown_max_length - cfg.dynamic_slowdown_start_length))
        return 1.0 - cfg.dynamic_slowdown_max_percent * frac

    def load_audio_prompt(self, path) -> np.ndarray:
        """A voice-clone prompt WAV -> [T_codes, C] codes for
        ``generate_codes``'s ``audio_prompts``: mono, at the vocoder's rate,
        DAC-encoded on its device."""
        from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

        dac = self._require_dac()
        signal = AudioSignal.load(path, device=dac.device).to_mono().resample(
            dac.config.sample_rate)
        _, codes, _, _, _ = dac.encode(signal.audio_data[0, 0],
                                       n_quantizers=self.config.data.channels)
        return codes[0].T.cpu().numpy()

    def set_dac_model(self, dac) -> None:
        self.__dict__["dac"] = dac

    def load_dac_model(self, source: str = "descript/dac_44khz") -> None:
        """Load the vocoder with ``load_dac`` (a directory, file or repository
        id), on this model's device."""
        from neuralcodecs_tpu_torch.core.loader import load_dac

        self.set_dac_model(load_dac(source, device=self.device).eval())


def _sample_next_token(logits: torch.Tensor, noise: torch.Tensor | None, temperature: float,
                       top_k: int | None, top_p: float, eos_value: int | None) -> torch.Tensor:
    """Temperature / top-k / top-p sampling of [N, V] f32 logits -> [N]:
    ``argmax(logits + noise)`` over the kept tokens (Gumbel-max), or the
    plain argmax when ``temperature < 1e-5``."""
    if temperature < 1e-5:
        return torch.argmax(logits, dim=-1)
    if eos_value is not None and eos_value >= 0:
        # EOS only where it is already the argmax
        not_top = torch.argmax(logits, dim=-1) != eos_value
        logits = logits.clone()
        logits[:, eos_value] = torch.where(not_top, -math.inf, logits[:, eos_value])
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        sorted_probs = torch.sort(probs, dim=-1, descending=True).values
        cumulative = torch.cumsum(sorted_probs, dim=-1)
        # keep tokens until the cumulative probability passes top_p
        cutoff = torch.sum(cumulative <= top_p, dim=-1, keepdim=True)
        sorted_keep = torch.gather(sorted_probs, -1,
                                   torch.clamp(cutoff, max=probs.shape[-1] - 1))
        logits = torch.where(probs < sorted_keep, -math.inf, logits)
    return torch.argmax(logits + noise, dim=-1)


def release_generation_caches() -> None:
    """Drop every Dia's captured step graphs and state pool (the JAX
    package's function of this name drops its compiled generation
    programs): a process that builds models in turn frees the states and
    graph memory of the ones it is done with."""
    for model in list(_MODELS):
        model.release_graphs()


registry.register("dia", Dia, DiaConfig)  # the factory: Dia(config, device=, seed=)
