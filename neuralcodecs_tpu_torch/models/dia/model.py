"""Dia 1.6B text-to-dialogue TTS, PyTorch port.

Counterpart of neuralcodecs_tpu.models.dia.model: byte-level text encoding
([S1] -> 0x01, [S2] -> 0x02), the encoder over the classifier-free-guidance
batch (row 2i the unconditional copy of request i, row 2i+1 the text),
per-layer cross-attention caches, the delay-pattern audio prefill, the
autoregressive decode loop with its EOS / delay countdown, then delay revert
and the DAC vocoder bridge.

The JAX package runs the whole loop as one ``lax.while_loop``. Here the
loop is eager and the host steps it: every slice offset and trip count of a
step comes from the step index, a Python int, so a step reads nothing back
from the device. The loop's stop test (every row's countdown drained) is the
one device->host read, made once every ``_SYNC_EVERY`` steps; a step taken
after the last row finished leaves the loop state as it was. The loop state
(``_LoopState``: codes buffer, countdowns, caches, noise streams) stays on
the device between calls, which makes generation resumable in segments
(``generate_codes_stream``).

Sampling draws ``argmax(logits + G)``, as ``jax.random.categorical`` does,
with Gumbel noise G from ``gumbel_noise``: one ``torch.Generator`` a batch
row, so row i's noise depends only on (seed, step, i) and batch padding
leaves the real rows' tokens unchanged.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.core.exceptions import LoadError
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.weights import check_keys
from neuralcodecs_tpu_torch.models.dia.audio_delay import apply_audio_delay, revert_audio_delay
from neuralcodecs_tpu_torch.models.dia.config import DiaConfig
from neuralcodecs_tpu_torch.models.dia.layers import (
    Attention,
    DenseGeneral,
    KVCacheSlot,
    MlpBlock,
    RMSNorm,
)

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

    def step(self, x: torch.Tensor, position: torch.Tensor, index: int,
             self_cache: KVCacheSlot, cross_cache: KVCacheSlot, cross_mask: torch.Tensor,
             kv_block: int = 0, kv_dot: bool = False) -> torch.Tensor:
        x = x + self.self_attention.step_attn(self.pre_sa_norm(x), position, self_cache, index,
                                              kv_block=kv_block, kv_dot=kv_dot)
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
        self.seed, self.rows, self.device, self.draws = int(seed), rows, device, 0
        self.generators = [
            torch.Generator(device=device).manual_seed(
                int(np.random.SeedSequence([self.seed, i]).generate_state(1)[0]))
            for i in range(rows)]


def gumbel_noise(noise: _RowNoise, shape: tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel noise [rows, *shape] for step ``noise.draws``: row i's
    comes from row i's generator alone. -log(-log(U)), U uniform in
    [tiny, 1), as jax.random.gumbel."""
    u = torch.stack([torch.rand(shape, generator=g, device=noise.device)
                     for g in noise.generators])
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


@dataclass
class _Sampling:
    temperature: float
    top_k: int
    top_p: float
    cfg_scale: float
    kv_block: int
    kv_dot: bool


@dataclass
class _LoopState:
    """The decode loop's state, on the model's device; ``step`` (the
    position the next step decodes) is known on the host."""
    step: int
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
    token_limit: int
    last_prefill_step: int


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

    ``compute_dtype`` is torch.float32, the JAX package's default, or
    torch.float64: a reference mode that holds the parameters, activations
    and caches in f64 to measure the f32 model's rounding. The sampler
    takes f32 logits in both; int8 weights and KV codes are quantized from
    f32 values and dequantized to the compute dtype."""

    def __init__(self, config: DiaConfig | None = None, *,
                 device: torch.device | str | None = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"Dia compute_dtype {compute_dtype}: only torch.float32 (and torch.float64, "
                "the reference mode) is ported; the bf16 modes are ROADMAP section 1 item 4")
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
        self.kv_cache_int8 = bool(enabled)
        return self

    # ------------------------------------------------------------ weights

    def load_state_dict(self, state_dict, assign: bool = False):
        """Load a Dia checkpoint: numpy arrays or tensors, keys with or
        without upstream's ``model.`` prefix. Keys the model lacks are
        ignored; a key it needs and the checkpoint lacks raises LoadError."""
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
        for dense in (*self._dense_layers(), self.decoder.logits_dense):
            dense.quantize_int8()
        return self

    def quantize_int4(self, group_size: int = 128) -> "Dia":
        """Weight-only int4 (nibble-packed, group-wise scales) of the
        transformer kernels; the logits head, which shapes the sampling
        distribution, takes int8. On the device and in place."""
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
                     kv_int8: bool = False) -> _LoopState:
        """Encoder, cross caches and decoder prefill -> the loop state of a
        ``max_tokens`` buffer, EOS forced at ``token_limit`` (default the
        buffer)."""
        cfg, data, dev = self.config, self.config.data, self.device
        b = text_tokens.shape[0]
        channels, eos, pad = data.channels, data.audio_eos_value, data.audio_pad_value

        # encoder + cross caches over the CFG batch, [uncond; cond] interleaved
        text = torch.as_tensor(text_tokens, dtype=torch.int64, device=dev)
        enc_input = torch.stack([torch.zeros_like(text), text], dim=1).reshape(2 * b, -1)
        padding_mask = enc_input != data.text_pad_value
        enc_out = self._encode_fn(enc_input, padding_mask)
        enc_positions = torch.arange(enc_input.shape[1], device=dev)[None, :]
        cross_caches = [layer.cross_attention.precompute_cross_cache(enc_out, enc_positions,
                                                                     padding_mask)
                        for layer in self.decoder.layers]
        cross_mask = padding_mask[:, None, :]

        d = cfg.decoder
        self_caches = [KVCacheSlot.zeros(2 * b, max_tokens, d.kv_heads, d.gqa_head_dim,
                                         self.compute_dtype, quantized=kv_int8, device=dev)
                       for _ in self.decoder.layers]
        generated = torch.full((b, max_tokens, channels), -1, dtype=torch.int64, device=dev)
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
        return _LoopState(
            step=int(prefill_steps.min()) - 1, generated=generated,
            eos_detected=torch.zeros(b, dtype=torch.bool, device=dev),
            finished=torch.full((b,), -1, dtype=torch.int64, device=dev),
            countdown=torch.where(active, -1, 0).to(torch.int64),
            self_caches=self_caches, cross_caches=cross_caches, cross_mask=cross_mask,
            invalid=(vocab > eos) | (~first & (vocab >= eos)),
            delay=torch.tensor(data.delay_pattern, dtype=torch.int64, device=dev),
            noise=_RowNoise(seed, b, dev),
            token_limit=max_tokens if token_limit is None else token_limit,
            last_prefill_step=int(prefill_steps.max()))

    def _decode_step(self, st: _LoopState, s: _Sampling) -> None:
        """One step of the loop at position ``st.step``, in place. Reads
        nothing back from the device. Once every row's countdown is 0 a step
        changes no state: no row is active, so nothing triggers or drains,
        and the token writeback keeps what is there; the cache slot it
        writes lies past every step taken, which no later step reads."""
        data = self.config.data
        eos, pad = data.audio_eos_value, data.audio_pad_value
        max_delay = max(data.delay_pattern)
        step = st.step
        b, _, channels = st.generated.shape

        tokens = st.generated[:, None, step].expand(b, 2, channels).reshape(2 * b, channels)
        tokens = torch.where(tokens < 0, pad, tokens)[:, None]             # [2B, 1, C]
        position = torch.full((2 * b, 1), step, dtype=torch.int64, device=tokens.device)
        x = self._embed_tokens(tokens)
        for layer, self_cache, cross in zip(self.decoder.layers, st.self_caches,
                                            st.cross_caches):
            x = layer.step(x, position, step, self_cache, cross, st.cross_mask,
                           kv_block=s.kv_block, kv_dot=s.kv_dot)
        logits = self._decoder_logits(x)[:, -1].reshape(b, 2, channels, -1).to(torch.float32)
        uncond, cond = logits[:, 0], logits[:, 1]
        logits = cond + s.cfg_scale * (cond - uncond)                     # [B, C, V]
        logits = logits.masked_fill(st.invalid, -math.inf)
        logits[:, 0, eos] *= 0.8

        noise = None
        if s.temperature >= 1e-5:
            noise = gumbel_noise(st.noise, tuple(logits.shape[1:]))
        st.noise.draws += 1
        pred = _sample_next_token(logits.reshape(b * channels, -1),
                                  None if noise is None else noise.reshape(b * channels, -1),
                                  s.temperature, s.top_k, s.top_p, eos).reshape(b, channels)

        # EOS detection and the delay countdown
        done = torch.all(st.countdown == 0)
        step_idx = step + 1
        active = st.countdown != 0
        is_eos = ~st.eos_detected & (pred[:, 0] == eos) & active
        trigger = active & (is_eos | (step_idx >= st.token_limit - max_delay))
        st.eos_detected = st.eos_detected | trigger
        start = trigger & (st.countdown < 0)
        st.countdown = torch.where(start, max_delay, st.countdown)
        st.finished = torch.where(start, step_idx, st.finished)
        draining = st.countdown > 0
        step_after = (max_delay - st.countdown)[:, None]
        pred = torch.where(draining[:, None] & (step_after == st.delay), eos, pred)
        pred = torch.where(draining[:, None] & (step_after > st.delay), pad, pred)
        st.countdown = torch.where(draining, st.countdown - 1, st.countdown)

        # BOS-protected writeback: prompt tokens stay until the prefill's
        # delayed channels are past
        existing = st.generated[:, step_idx]
        keep = done | (existing != -1) if step - st.last_prefill_step <= max_delay else done
        st.generated[:, step_idx] = torch.where(keep, existing, pred)
        st.step = step_idx

    @torch.no_grad()
    def _run_loop(self, st: _LoopState, stop: int, s: _Sampling) -> None:
        """Step until position ``stop`` (exclusive) or until every row's
        countdown has drained, which is read once every ``_SYNC_EVERY``
        steps."""
        n = 0
        while st.step < stop:
            if n % _SYNC_EVERY == 0 and bool(torch.all(st.countdown == 0)):
                return
            self._decode_step(st, s)
            n += 1

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
        """The one-shot loop: (final state, prefill steps, real batch size)."""
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
        st = self._start_state(text_arr, delayed, prefill_steps, seed, np.arange(b) < b_real,
                               max_tokens=buffer_len, token_limit=requested,
                               kv_int8=self.kv_cache_int8)
        self._run_loop(st, buffer_len - 1,
                       self._sampling(buffer_len, temperature, top_k, top_p, cfg_scale))
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
        st, prefill_steps, b = self._generate(
            texts, max_tokens=max_tokens, cfg_scale=cfg_scale, temperature=temperature,
            top_p=top_p, top_k=top_k, audio_prompts=audio_prompts, seed=seed,
            pad_text_to=pad_text_to, pad_tokens_to=pad_tokens_to, pad_batch_to=pad_batch_to)
        codes, lengths, finished = self._codes(st, prefill_steps, b)
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
        channels are decoded, ``max(delay_pattern)`` steps behind the head."""
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
        with torch.no_grad():
            st = self._start_state(text_arr, delayed, prefill_steps, seed, np.ones(1, bool),
                                   max_tokens=buffer_len, token_limit=requested,
                                   kv_int8=self.kv_cache_int8)
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
                yield block.astype(np.int32), done
                emitted = frames_avail
            if done:
                return

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


registry.register("dia", Dia, DiaConfig)  # the factory: Dia(config, device=, seed=)
