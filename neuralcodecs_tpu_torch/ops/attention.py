"""Windowed local multi-head attention with rotary embeddings.

Counterpart of neuralcodecs_tpu.ops.attention (layer_norm, RoPE, local_mha),
in plain PyTorch: SNAC-24k has no attention; the 32/44 kHz presets do.
Activations enter and leave in torch's [B, C, T] layout; weights are in
torch Linear layout [out, in].
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoidal_freqs(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Rotary frequency table [seq_len, dim]: cat(t⊗inv_freq, t⊗inv_freq)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1] rotation over the last dim."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor,
               freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings on q, k of shape [..., S, Dh]; scale ≡ 1."""
    cos, sin = torch.cos(freqs).to(q.dtype), torch.sin(freqs).to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis, with the population variance."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over [N, S, H, Dh], written out (f32 softmax)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", weights, v)


def local_mha(x: torch.Tensor, *, norm_scale: torch.Tensor, norm_bias: torch.Tensor,
              qkv_weight: torch.Tensor, out_weight: torch.Tensor, window_size: int,
              num_heads: int, use_rope: bool = True) -> torch.Tensor:
    """Windowed multi-head self-attention with residual.

    x: [B, C, T] with T divisible by window_size (the SNAC pre-pad
    guarantees this). qkv_weight: [3C, C]; out_weight: [C, C], both bias-free.
    """
    b, c, t = x.shape
    h = x.transpose(1, 2)  # [B, T, C]
    residual = h
    h = layer_norm(h, norm_scale, norm_bias)
    q, k, v = torch.matmul(h, qkv_weight.t()).chunk(3, dim=-1)
    w, dh = t // window_size, c // num_heads

    def to_windows(a: torch.Tensor) -> torch.Tensor:
        # [B, T, C] -> [B·W, S, H, Dh]
        return a.reshape(b * w, window_size, num_heads, dh)

    q, k, v = to_windows(q), to_windows(k), to_windows(v)
    if use_rope:
        freqs = sinusoidal_freqs(window_size, dh, device=x.device)
        q, k = apply_rope(q, k, freqs[None, :, None, :])
    out = _attention(q, k, v).reshape(b, t, c)
    out = torch.matmul(out, out_weight.t()) + residual
    return out.transpose(1, 2)
