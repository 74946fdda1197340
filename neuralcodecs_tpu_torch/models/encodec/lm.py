"""Encodec language model, PyTorch port.

Counterpart of neuralcodecs_tpu.models.encodec.lm: a streaming transformer
over RVQ code streams with the semantics of the original encodec LM. The
per-codebook embeddings of the +1-shifted codes are summed, go through
``norm_in`` and a sinusoidal position embedding, then N post-norm layers
attend over [past ‖ current] within ``past_context`` steps, and one linear
and softmax a codebook give the pdfs.

As upstream's ``LMModel.forward`` does, a stream of K codebooks (8 at
6 kbps) is embedded and predicted on the LM's first K codebooks only. The
JAX package differs where K is below the LM's count (32 for the 24 kHz
LM): its ``_embed`` reads ``indices[:, i]`` for every LM codebook, which
jnp clamps to the last one given, and it predicts all of them. Only K
matter to the coder, and streams do not cross implementations anyway
(compressor.py), so the port keeps upstream's arithmetic.

Modules and parameters carry upstream's names (``emb.{k}``, ``linears.{k}``,
``transformer.norm_in``, ``transformer.layers.{i}.self_attn.in_proj_weight``
...), in torch's own [out, in] layouts, so an upstream checkpoint loads as
it is (``load_state_dict`` drops a ``model.`` prefix); the JAX package's
[in, out] parameters cross with ``core.weights.from_jax_params``.

The streaming state is a fixed-size rolling buffer [L, B, P, D] of the last
P layer inputs (newest at slot P-1) and the absolute offset; a mask hides
the slots not yet filled. Attention and softmax are plain torch ops: the JAX
LM has no Pallas kernel. What the .ecdc path needs is that encode and
decode run the same op sequence at the same shapes on the same device,
which ``step`` gives (compressor.py). The weights are made on the CPU from
an explicit ``torch.Generator``, so one seed gives the same LM on every
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuralcodecs_tpu_torch.core.config import ModelConfig
from neuralcodecs_tpu_torch.core.device import resolve_device


@dataclass
class EncodecLMConfig(ModelConfig):
    codebook_size: int = 1024
    num_codebooks: int = 32
    dimension: int = 200
    num_heads: int = 8
    num_layers: int = 5
    hidden_scale: float = 4.0
    max_period: float = 10000.0
    past_context: int = 1000
    gelu: bool = True
    norm_in: bool = True

    def __post_init__(self) -> None:
        self.architecture = self.architecture or "encodec_lm"


class LMState(NamedTuple):
    """Rolling per-layer attention state and the absolute position."""

    buffers: torch.Tensor   # [L, B, P, D], the last P layer inputs, newest at slot P-1
    offset: int


def sin_embedding(positions: torch.Tensor, dim: int, max_period: float) -> torch.Tensor:
    """[..., T, 1] positions -> [..., T, dim]: cos then sin of position /
    max_period ** (i / (dim/2 - 1))."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    phase = positions.to(torch.float32) / (max_period ** (idx / (half - 1.0)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


class SelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed q, k, v projection
    ``in_proj_weight`` [3D, D], ``out_proj``), computed with plain ops."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """queries [B, T, D], keys (= values) [B, S, D], mask [T, S] bool,
        True where masked."""
        (b, t, d), s = queries.shape, keys.shape[1]
        w, bias = self.in_proj_weight, self.in_proj_bias
        dh = d // self.num_heads
        q = F.linear(queries, w[:d], bias[:d]).view(b, t, self.num_heads, dh).transpose(1, 2)
        k = F.linear(keys, w[d:2 * d], bias[d:2 * d]).view(b, s, self.num_heads, dh).transpose(1, 2)
        v = F.linear(keys, w[2 * d:], bias[2 * d:]).view(b, s, self.num_heads, dh).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)      # [B, h, T, S]
        weights = torch.softmax(logits.masked_fill(mask, float("-inf")), dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class TransformerLayer(nn.Module):
    """Post-norm layer: x = norm1(x + attn(x, keys)); x = norm2(x + ff(x))."""

    def __init__(self, dim: int, num_heads: int, hidden: int, gelu: bool):
        super().__init__()
        self.gelu = gelu
        self.self_attn = SelfAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, keys, mask))
        h = self.linear1(x)
        h = F.gelu(h) if self.gelu else F.relu(h)
        return self.norm2(x + self.linear2(h))


class Transformer(nn.Module):
    def __init__(self, cfg: EncodecLMConfig):
        super().__init__()
        d = cfg.dimension
        self.norm_in = nn.LayerNorm(d) if cfg.norm_in else None
        self.layers = nn.ModuleList(
            TransformerLayer(d, cfg.num_heads, int(d * cfg.hidden_scale), cfg.gelu)
            for _ in range(cfg.num_layers))


class EncodecLanguageModel(nn.Module):
    """The Encodec LM with a full-sequence forward and a single-step path.
    Lives on ``device``, "cuda" when none is given."""

    def __init__(self, config: EncodecLMConfig | None = None, *,
                 device: torch.device | str | None = None, seed: int = 0):
        super().__init__()
        self.config = cfg = config or EncodecLMConfig()
        with torch.random.fork_rng(devices=[]):  # the modules' own init draws
            self.emb = nn.ModuleList(nn.Embedding(cfg.codebook_size + 1, cfg.dimension)
                                     for _ in range(cfg.num_codebooks))
            self.linears = nn.ModuleList(nn.Linear(cfg.dimension, cfg.codebook_size)
                                         for _ in range(cfg.num_codebooks))
            self.transformer = Transformer(cfg)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init, drawn from ``gen``: embeddings N(0, 1),
        linear weights U(±1/sqrt(fan_in)), biases 0, norms 1 and 0."""
        def uniform(w: torch.Tensor) -> None:
            bound = 1.0 / math.sqrt(w.shape[1])
            w.copy_(torch.rand(w.shape, generator=gen) * (2 * bound) - bound)

        for emb, lin in zip(self.emb, self.linears):
            emb.weight.copy_(torch.randn(emb.weight.shape, generator=gen))
            uniform(lin.weight)
            lin.bias.zero_()
        for layer in self.transformer.layers:
            attn = layer.self_attn
            for w in (attn.in_proj_weight, attn.out_proj.weight, layer.linear1.weight,
                      layer.linear2.weight):
                uniform(w)
            for b in (attn.in_proj_bias, attn.out_proj.bias, layer.linear1.bias,
                      layer.linear2.bias):
                b.zero_()
        for norm in self.modules():
            if isinstance(norm, nn.LayerNorm):
                norm.weight.fill_(1.0)
                norm.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.emb[0].weight.device

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Load upstream (or the port's) names, dropping a ``model.`` prefix;
        numpy arrays (or CPU tensors) are copied in. Returns self."""
        sd = {(k[len("model."):] if k.startswith("model.") else k): torch.from_numpy(np.array(v))
              for k, v in state_dict.items()}
        super().load_state_dict(sd, strict=strict, assign=assign)
        return self

    # ----------------------------------------------------------------- compute

    def _embed(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, K, T] (+1-shifted codes, 0 = padding) -> [B, T, D]:
        the embeddings of the K codebooks given, summed."""
        out = self.emb[0](indices[:, 0])
        for k in range(1, indices.shape[1]):
            out = out + self.emb[k](indices[:, k])
        return out

    def _input(self, indices: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = self._embed(indices)
        if self.transformer.norm_in is not None:
            x = self.transformer.norm_in(x)
        return x + sin_embedding(positions, self.config.dimension, self.config.max_period)

    def _probas(self, h: torch.Tensor, k: int) -> torch.Tensor:
        """h [B, T, D] -> pdfs [B, card, k, T] of the first k codebooks."""
        outs = [torch.softmax(lin(h), dim=-1) for lin in self.linears[:k]]   # [B, T, card]
        return torch.stack(outs, dim=1).permute(0, 3, 1, 2)

    def _indices(self, indices) -> torch.Tensor:
        indices = torch.as_tensor(indices, dtype=torch.long, device=self.device)
        if not 1 <= indices.shape[1] <= self.config.num_codebooks:
            raise ValueError(f"{indices.shape[1]} codebooks given, the LM has "
                             f"{self.config.num_codebooks}")
        return indices

    @torch.no_grad()
    def forward_full(self, indices) -> torch.Tensor:
        """indices [B, K, T] shifted codes, K <= num_codebooks -> pdfs
        [B, card, K, T]."""
        indices = self._indices(indices)
        t = indices.shape[-1]
        pos = torch.arange(t, device=self.device)
        x = self._input(indices, pos[None, :, None])
        delta = pos[:, None] - pos[None, :]
        mask = ~((delta >= 0) & (delta <= self.config.past_context))
        for layer in self.transformer.layers:
            x = layer(x, x, mask)
        return self._probas(x, indices.shape[1])

    def init_state(self, batch: int = 1) -> LMState:
        cfg = self.config
        return LMState(torch.zeros(cfg.num_layers, batch, cfg.past_context, cfg.dimension,
                                   device=self.device), 0)

    @torch.no_grad()
    def step(self, indices, state: LMState) -> tuple[torch.Tensor, LMState]:
        """One autoregressive step: indices [B, K, 1] shifted codes, K <=
        num_codebooks -> (pdfs [B, card, K, 1], the next state)."""
        p_ctx = self.config.past_context
        indices = self._indices(indices)
        pos = torch.full((1, 1, 1), float(state.offset), device=self.device)
        x = self._input(indices, pos)                                     # [B, 1, D]
        # slot i holds the input at position offset - (P - i): valid once >= 0
        slots = torch.arange(p_ctx + 1, device=self.device)
        mask = (slots < p_ctx - state.offset)[None, :]                   # [1, P+1]
        buffers = []
        for layer, buf in zip(self.transformer.layers, state.buffers):
            buffers.append(torch.cat([buf[:, 1:], x], dim=1))
            x = layer(x, torch.cat([buf, x], dim=1), mask)
        return self._probas(x, indices.shape[1]), LMState(torch.stack(buffers), state.offset + 1)
