"""Dia transformer building blocks, PyTorch port.

Counterpart of neuralcodecs_tpu.models.dia.layers. DenseGeneral kernels are
stored ``[in_shapes..., out_features...]`` as in the Dia checkpoints, the
layout ``torch.tensordot`` contracts directly, so parameters cross from the
JAX package and from upstream state dicts with no transposes. RoPE is the
split-half rotation with f32 sin/cos; attention runs at scale 1.0 (the q
projection folds the 1/sqrt(d)) and GQA shares each K/V head across its
query group.

The decode cache (``KVCacheSlot``) is preallocated and written in place, one
slot a step, at a step index held on the device (``index_copy_``). Every
read of a step has a fixed shape, so the step can be captured into a CUDA
graph and replayed at any position: the full read takes the whole buffer
masked to slots <= step, as the JAX package does; the blocked read takes a
fixed number of blocks (the host knows how many the step needs) and masks
the last block's slots past the step. On CUDA a step over a float cache,
and cross-attention at one position, go through the decode-attention
kernel instead (ops/kernels/decode_attn.py), which reads the number of
live slots from the device step index.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuralcodecs_tpu_torch.ops.kernels.decode_attn import (
    decode_cross_attn,
    decode_cross_attn_plain,
    decode_self_attn,
    decode_self_attn_plain,
)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in its own dtype where that is a wider float (Dia's
    f64 reference mode)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 RMS norm over the last dim."""
    x32 = _f32(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_timescale(head_dim: int, min_timescale: float = 1.0,
                   max_timescale: float = 10000.0) -> np.ndarray:
    fraction = 2.0 * np.arange(head_dim // 2, dtype=np.float32) / head_dim
    return (min_timescale * (max_timescale / min_timescale) ** fraction).astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, timescale: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; positions: [B, T] (or [1, T]). Split-half rotation."""
    sinusoid = _f32(positions[..., None, None]) / timescale
    sin, cos = torch.sin(sinusoid), torch.cos(sinusoid)
    x32 = _f32(x)
    first, second = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([first * cos - second * sin, second * cos + first * sin], dim=-1)
    return out.to(x.dtype)


def sdpa_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor | None, scale: float = 1.0) -> torch.Tensor:
    """q: [B, T, Nq, Dh]; k/v: [B, S, Nkv, Dh]; mask: [B, T, S] bool
    (True = attend), shared across heads. Returns [B, T, Nq, Dh]. A row with
    every key masked gives zeros: the CFG batch's unconditional rows are all
    padding, so their encoder and cross-attention rows are such rows.

    The scores and the softmax are f32 whatever q's dtype (the JAX
    package's ``preferred_element_type=f32``); the weights go to q's dtype
    for the weighted sum."""
    b, t, nq, dh = q.shape
    nkv = k.shape[2]
    q = q.reshape(b, t, nkv, nq // nkv, dh)
    logits = torch.einsum("btkgd,bskd->bkgts", _f32(q), _f32(k)) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, -math.inf)
    weights = torch.nan_to_num(torch.softmax(logits, dim=-1)).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", weights, v)
    return out.reshape(b, t, nq, dh)


class DenseGeneral(nn.Module):
    """tensordot layer with kernel [in..., out...].

    Holds ``weight`` (f32) until ``quantize_int8`` replaces it with
    ``weight_q8`` (int8) + ``weight_scale`` (per output), or
    ``quantize_int4`` with ``weight_q4`` (two int4 a byte along the
    contracted dim) + ``weight_scale4`` (per group of input rows and
    output). The names are the JAX package's parameter keys.

    The product runs in the input's dtype, the weight cast to it as the JAX
    package casts it at each use. For an input of another dtype than the
    weight (bf16 against the f32 parameter) the cast weight is kept on the
    module and made again only when the weight's storage or in-place version
    changes: casting Dia's 1.6 G parameters at every decode step would move
    more bytes than the step's products read. The copy is no parameter or
    buffer, so state dicts and exports hold the f32 weight alone.

    Under tensor parallelism (``parallel.sharding.shard_params``) a layer
    holds its rank's slice: a row-parallel one (``o_proj``, ``wo``) sums
    its partial product over ``reduce_group``; a row-sharded int4 kernel
    whose group scales stay whole reads them at ``int4_rows`` = (its first
    row, the whole kernel's rows)."""

    reduce_group = None
    int4_rows: tuple[int, int] | None = None

    def __init__(self, in_shapes: tuple[int, ...], out_features: tuple[int, ...],
                 device: torch.device | None = None):
        super().__init__()
        self.in_shapes = tuple(in_shapes)
        self.out_features = tuple(out_features)
        self.weight = nn.Parameter(torch.empty(*self.in_shapes, *self.out_features,
                                               device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 1.0 / math.sqrt(int(np.prod(self.in_shapes)))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator).mul_(std)

    def _weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        """``weight.to(dtype)``, kept until the weight changes (keyed on its
        storage and in-place version, as ``ops/kernels/resunit._packed``)."""
        w = self.weight
        if w.dtype == dtype:
            return w
        key = (w.data_ptr(), w._version, dtype)
        cached = self.__dict__.get("_cast")
        if cached is None or cached[0] != key:
            cached = self._cast = (key, w.detach().to(dtype))
        return cached[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if "weight_q4" in self._buffers:
            y = self._int4_matmul(x)
        else:
            if "weight_q8" in self._buffers:
                w = self.weight_q8.to(x.dtype) * self.weight_scale.to(x.dtype)
            else:
                w = self._weight_as(x.dtype)
            n_in = len(self.in_shapes)
            y = torch.tensordot(x, w, dims=(list(range(x.dim() - n_in, x.dim())),
                                            list(range(n_in))))
        if self.reduce_group is not None:
            from neuralcodecs_tpu_torch.parallel.collectives import row_parallel_sum

            y = row_parallel_sum(y, self.reduce_group)
        return y

    @torch.no_grad()
    def quantize_int8(self) -> None:
        """Weight-only int8 in place: per-output scale = amax over the
        contracted dims / 127; the f32 kernel is freed as its int8 form lands."""
        w = self.weight.to(torch.float32)
        in_axes = tuple(range(len(self.in_shapes)))
        scale = torch.amax(torch.abs(w), dim=in_axes, keepdim=True) / 127.0
        q8 = torch.clamp(torch.round(w / torch.clamp(scale, min=1e-12)), -127, 127)
        del w
        del self.weight
        self.__dict__.pop("_cast", None)
        self.register_buffer("weight_q8", q8.to(torch.int8))
        self.register_buffer("weight_scale", scale)

    @torch.no_grad()
    def quantize_int4(self, group_size: int = 128) -> None:
        """Weight-only int4 in place, nibble-packed along the contracted dim
        (even rows in the low nibble, odd rows in the high one), scales =
        amax / 7 over ``group_size`` consecutive input rows per output (one
        group when ``group_size`` is odd or does not divide the input). An
        odd contracted dim cannot be packed: it takes int8."""
        k = int(np.prod(self.in_shapes))
        n = int(np.prod(self.out_features))
        if k % 2:
            self.quantize_int8()
            return
        g = group_size
        if g % 2 or k % g:
            g = k
        wg = self.weight.to(torch.float32).reshape(k // g, g, n)
        scale = torch.clamp(torch.amax(torch.abs(wg), dim=1, keepdim=True) / 7.0, min=1e-12)
        q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32).reshape(k, n)
        del wg
        packed = ((q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)).to(torch.uint8)
        del self.weight
        self.__dict__.pop("_cast", None)
        self.register_buffer("weight_q4", packed.view(torch.int8))
        self.register_buffer("weight_scale4", scale[:, 0, :])

    def _int4_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Even input rows against the low nibbles, odd rows against the high
        ones: two half-K products, no re-interleaved weight. int8 shifts are
        arithmetic, so each nibble comes back sign-extended."""
        q4, scale = self.weight_q4, self.weight_scale4
        k2, nf = q4.shape
        k = 2 * k2
        w_even = ((q4 << 4) >> 4).to(x.dtype)
        w_odd = (q4 >> 4).to(x.dtype)
        if self.int4_rows is None:
            n_groups = scale.shape[0]
            g = k // n_groups
            sg = scale.to(x.dtype)[:, None, :]                   # [K/G, 1, N]
            w_even = (w_even.reshape(n_groups, g // 2, nf) * sg).reshape(k2, nf)
            w_odd = (w_odd.reshape(n_groups, g // 2, nf) * sg).reshape(k2, nf)
        else:                                                    # this rank's rows of K
            first, k_full = self.int4_rows
            rows = (first + torch.arange(k, device=q4.device)) // (k_full // scale.shape[0])
            s_rows = scale.to(x.dtype)[rows]                     # [K_rank, N]
            w_even = w_even * s_rows[0::2]
            w_odd = w_odd * s_rows[1::2]
        batch_shape = x.shape[:x.dim() - len(self.in_shapes)]
        xb = x.reshape(*batch_shape, k)
        y = torch.matmul(xb[..., 0::2], w_even) + torch.matmul(xb[..., 1::2], w_odd)
        return y.reshape(*batch_shape, *self.out_features)


class RMSNorm(nn.Module):
    """The norm's weight as a module, so its key is ``{name}.weight``."""

    def __init__(self, dim: int, eps: float, device: torch.device | None = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class MlpBlock(nn.Module):
    """Fused gate+up projection [.., 2, I] -> silu(gate)·up -> wo.

    ``intermediate`` = (start, length): under tensor parallelism with
    wi_fused whole (its int4 form stays replicated), the slice of the
    intermediate that this rank's rows of wo take."""

    intermediate: tuple[int, int] | None = None

    def __init__(self, embed_dim: int, intermediate_dim: int, device: torch.device | None = None):
        super().__init__()
        self.wi_fused = DenseGeneral((embed_dim,), (2, intermediate_dim), device)
        self.wo = DenseGeneral((intermediate_dim,), (embed_dim,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = self.wi_fused(x)                                  # [..., 2, I]
        h = F.silu(fused[..., 0, :]) * fused[..., 1, :]
        if self.intermediate is not None:
            h = h.narrow(-1, *self.intermediate)
        return self.wo(h)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, position, head) int8 over the head dim, scale = amax/127."""
    x32 = _f32(x)
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0
    q = torch.round(x32 / torch.clamp(scale, min=1e-12)[..., None])
    return q.to(torch.int8), scale


def step_index(index: int | torch.Tensor, device: torch.device) -> torch.Tensor:
    """A decode step's position as the [1] int64 device tensor the step
    reads: kept as it is when it is one already."""
    if isinstance(index, torch.Tensor):
        return index.reshape(1)
    return torch.tensor([int(index)], dtype=torch.int64, device=device)


class KVCacheSlot:
    """Preallocated decode cache: k/v [B, maxT, Nkv, Dh], written in place.

    Optionally int8 with per-(batch, position, head) f32 scales ``k_scale`` /
    ``v_scale`` [B, maxT, Nkv]: the step read then streams a byte an element
    plus one scale a 128-dim vector."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None):
        self.k, self.v, self.k_scale, self.v_scale = k, v, k_scale, v_scale

    @staticmethod
    def zeros(batch: int, max_len: int, n_kv: int, head_dim: int,
              dtype=torch.float32, quantized: bool = False,
              device: torch.device | str | None = None) -> "KVCacheSlot":
        shape = (batch, max_len, n_kv, head_dim)
        if quantized:
            sshape = (batch, max_len, n_kv)
            return KVCacheSlot(torch.zeros(shape, dtype=torch.int8, device=device),
                               torch.zeros(shape, dtype=torch.int8, device=device),
                               torch.zeros(sshape, device=device),
                               torch.zeros(sshape, device=device))
        return KVCacheSlot(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))

    def _write(self, k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor) -> None:
        if self.k_scale is not None:
            (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
            self.k_scale.index_copy_(1, slots, ks.to(self.k_scale.dtype))
            self.v_scale.index_copy_(1, slots, vs.to(self.v_scale.dtype))
        self.k.index_copy_(1, slots, k.to(self.k.dtype))
        self.v.index_copy_(1, slots, v.to(self.v.dtype))

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               index: int | torch.Tensor) -> None:
        """Write one step's [B, 1, Nkv, Dh] at slot ``index`` (an int, or a
        [1] int64 tensor on the cache's device), in place."""
        self._write(k_new, v_new, step_index(index, self.k.device))

    def prefill_write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write the prompt block [B, T, Nkv, Dh] at slots 0..T-1, in place."""
        self._write(k, v, torch.arange(k.shape[1], device=self.k.device))

    def kv(self, dtype, length: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) of slots 0..length-1 (all by default), dequantized if int8."""
        k, v = self.k[:, :length], self.v[:, :length]
        if self.k_scale is None:
            return k, v
        k = k.to(dtype) * self.k_scale[:, :length].to(dtype)[..., None]
        v = v.to(dtype) * self.v_scale[:, :length].to(dtype)[..., None]
        return k, v


def _blocked_decode_attn(q: torch.Tensor, cache: KVCacheSlot, step: int | torch.Tensor,
                         block: int, int8_dot: bool = False,
                         n_blocks: int | None = None) -> torch.Tensor:
    """Decode-step GQA attention over the cache in ``block``-slot slices, up
    to slot ``step``: flash-style running max ``m``, denominator ``l`` and
    weighted sum ``acc`` in f32 (f64 in the reference mode). ``n_blocks``
    blocks are read whole, the count the step needs (``step // block + 1``,
    the default for an int ``step``); the last block's slots past ``step``
    are masked to -inf, as the JAX form masks them, so a step index held on
    the device gives every step of one block count the same shapes.

    ``int8_dot`` (int8 cache only): q is quantized per row and q·k is a
    product of integers; the v-scale-folded softmax numerators are
    quantized per row of the block for p·v. Each partial sum is an integer
    of magnitude at most 127² · K (K = 128 for q·k, the block for p·v),
    below 2²⁴ up to K = 1040, so f32 products with TF32 off give the JAX
    package's int32 sums exactly, in any order.

    q: [B, 1, Nq, Dh]. Returns [B, 1, Nq, Dh] in q.dtype."""
    b, _, nq, dh = q.shape
    max_t, nkv = cache.k.shape[1], cache.k.shape[2]
    groups = nq // nkv
    assert max_t % block == 0, (max_t, block)
    qg = _f32(q.reshape(b, nkv, groups, dh))
    int8_dot = bool(int8_dot) and cache.k_scale is not None
    if int8_dot:
        assert block <= 1024, f"int8-dot read needs block <= 1024 for exact f32 sums, got {block}"
        q_scale = torch.clamp(torch.amax(torch.abs(qg), dim=-1, keepdim=True) / 127.0, min=1e-30)
        q_int = torch.clamp(torch.round(qg / q_scale), -127, 127)
    if n_blocks is None:
        n_blocks = int(step) // block + 1
    step = step_index(step, q.device)
    m = torch.full((b, nkv, groups), -math.inf, dtype=qg.dtype, device=q.device)
    l = torch.zeros((b, nkv, groups), dtype=qg.dtype, device=q.device)
    acc = torch.zeros((b, nkv, groups, dh), dtype=qg.dtype, device=q.device)
    for j in range(n_blocks):
        start, end = j * block, (j + 1) * block
        kb = cache.k[:, start:end].to(qg.dtype)
        vb = cache.v[:, start:end].to(qg.dtype)
        if int8_dot:
            ks = cache.k_scale[:, start:end].transpose(1, 2)[:, :, None, :]
            vs = cache.v_scale[:, start:end].transpose(1, 2)[:, :, None, :]
            logits = torch.einsum("bkgd,bskd->bkgs", q_int, kb) * q_scale * ks
        else:
            if cache.k_scale is not None:
                kb = kb * cache.k_scale[:, start:end, :, None]
                vb = vb * cache.v_scale[:, start:end, :, None]
            logits = torch.einsum("bkgd,bskd->bkgs", qg, kb)
        if j == n_blocks - 1:
            live = torch.arange(start, end, device=q.device) <= step
            logits = torch.where(live, logits, -math.inf)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        if int8_dot:
            pv = p * vs
            pv_scale = torch.clamp(torch.amax(pv, dim=-1, keepdim=True) / 127.0, min=1e-30)
            pv_int = torch.clamp(torch.round(pv / pv_scale), 0, 127)
            acc = acc * corr[..., None] + torch.einsum("bkgs,bskd->bkgd", pv_int, vb) * pv_scale
        else:
            acc = acc * corr[..., None] + torch.einsum("bkgs,bskd->bkgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, nq, dh).to(q.dtype)


class Attention(nn.Module):
    """Self / cross attention with q/k/v/o DenseGenerals."""

    def __init__(self, q_dim: int, kv_dim: int, n_q: int, n_kv: int, head_dim: int,
                 out_dim: int, min_timescale: float = 1.0, max_timescale: float = 10000.0,
                 device: torch.device | None = None):
        super().__init__()
        self.q_proj = DenseGeneral((q_dim,), (n_q, head_dim), device)
        self.k_proj = DenseGeneral((kv_dim,), (n_kv, head_dim), device)
        self.v_proj = DenseGeneral((kv_dim,), (n_kv, head_dim), device)
        self.o_proj = DenseGeneral((n_q, head_dim), (out_dim,), device)
        self.register_buffer("timescale", torch.from_numpy(
            rope_timescale(head_dim, min_timescale, max_timescale)).to(device), persistent=False)

    @property
    def n_kv(self) -> int:
        """K/V heads this module computes (its rank's, under tp)."""
        return self.k_proj.out_features[0]

    def self_attn(self, x: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor | None,
                  cache: KVCacheSlot | None = None) -> torch.Tensor:
        """Self-attention over a block (encoder, decoder prefill); with a
        cache, its K/V are written to slots 0..T-1 as well."""
        q = apply_rope(self.q_proj(x), positions, self.timescale)
        k = apply_rope(self.k_proj(x), positions, self.timescale)
        v = self.v_proj(x)
        if cache is not None:
            cache.prefill_write(k, v)
        return self.o_proj(sdpa_gqa(q, k, v, mask))

    def step_attn(self, x: torch.Tensor, position: torch.Tensor, cache: KVCacheSlot,
                  index: int | torch.Tensor, kv_block: int = 0, kv_dot: bool = False,
                  n_blocks: int | None = None) -> torch.Tensor:
        """One decode step: x [B, 1, D], position [B, 1]. Writes slot
        ``index`` (an int or a [1] device tensor) of ``cache`` in place,
        then attends over slots 0..index, the causal window the decode loop
        masks to. On the CPU ``kv_block > 0`` reads ``n_blocks`` blocks
        (``_blocked_decode_attn``, optionally with ``kv_dot``) and 0 the
        whole buffer, masked; a float cache on CUDA goes through the
        decode-attention kernel, which reads the live slots
        (ops/kernels/decode_attn.py), and an int8 cache takes the plain
        reads on every device."""
        if kv_block and n_blocks is None:
            n_blocks = int(index) // kv_block + 1
        index = step_index(index, x.device)
        attend = decode_self_attn if cache.k_scale is None else decode_self_attn_plain
        out = attend(self.q_proj(x), self.k_proj(x), self.v_proj(x), cache, position, index,
                     self.timescale, block=kv_block, n_blocks=n_blocks, kv_dot=kv_dot)
        return self.o_proj(out)

    def cross_attn(self, x: torch.Tensor, positions: torch.Tensor, cache: KVCacheSlot,
                   mask: torch.Tensor | None) -> torch.Tensor:
        """x [B, T, D] against the cross cache under mask [B, T, S]; one
        position (a decode step) goes through the decode-attention kernel
        on CUDA."""
        attend = decode_cross_attn if x.shape[1] == 1 else decode_cross_attn_plain
        return self.o_proj(attend(self.q_proj(x), cache, mask, positions, self.timescale))

    def precompute_cross_cache(self, enc_out: torch.Tensor, enc_positions: torch.Tensor,
                               padding_mask: torch.Tensor | None) -> KVCacheSlot:
        """K/V of the encoder output, keys zeroed at padded positions."""
        k = apply_rope(self.k_proj(enc_out), enc_positions, self.timescale)
        v = self.v_proj(enc_out)
        if padding_mask is not None:
            k = torch.where(padding_mask[:, :, None, None], k, 0.0)
        return KVCacheSlot(k, v)
