"""Resampling (counterpart of neuralcodecs_tpu.dsp.resample).

``linear_resample`` is the host-style linear interpolator SNAC uses;
``resample_poly`` is the windowed-sinc polyphase resampler Encodec uses,
as the JAX package writes it: zero-stuff by ``up``, filter with a
Kaiser-windowed sinc, keep every ``down``-th sample, as one strided conv1d.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def linear_resample(audio: torch.Tensor, src_rate: int, dst_rate: int) -> torch.Tensor:
    """Linear-interpolation resampling over the last axis; the tail holds
    the last sample."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if src_rate == dst_rate:
        return audio
    n_in = audio.shape[-1]
    n_out = int(n_in * dst_rate / src_rate)
    ratio = dst_rate / src_rate
    # positions = arange · f32(1 / f32(ratio)): the reference's XLA program
    # rounds its division by the constant ratio this way
    inv = 1.0 / torch.tensor(ratio, dtype=torch.float32, device=audio.device)
    pos = torch.arange(n_out, dtype=torch.float32, device=audio.device) * inv
    idx = torch.clamp(pos.to(torch.int32), 0, n_in - 1).long()
    frac = pos - idx.to(torch.float32)
    nxt = torch.clamp(idx + 1, 0, n_in - 1)
    frac = torch.where(idx >= n_in - 1, torch.zeros_like(frac), frac)
    return audio[..., idx] * (1.0 - frac) + audio[..., nxt] * frac


def _kaiser_sinc_filter(num_zeros: int, precision: int, rolloff: float) -> np.ndarray:
    """Windowed-sinc lowpass prototype for polyphase resampling."""
    taps = 2 * num_zeros * precision + 1
    t = (np.arange(taps) - (taps - 1) / 2) / precision
    window = np.kaiser(taps, beta=14.769656459379492)
    h = rolloff * np.sinc(rolloff * t) * window
    return h.astype(np.float32)


def resample_poly(audio: torch.Tensor, src_rate: int, dst_rate: int,
                  num_zeros: int = 24) -> torch.Tensor:
    """Polyphase resampling of [..., T] as a zero-stuffed strided conv1d."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if src_rate == dst_rate:
        return audio
    g = math.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    # the prototype is sampled at 1/up spacing: each phase already has unit
    # DC gain, so zero stuffing needs no gain compensation
    h = torch.from_numpy(_kaiser_sinc_filter(num_zeros, up, min(1.0, up / down) * 0.945))
    lead_shape, n = audio.shape[:-1], audio.shape[-1]
    x = audio.reshape(-1, 1, n)
    stuffed = x.new_zeros(x.shape[0], 1, (n - 1) * up + 1)
    stuffed[..., ::up] = x
    pad = h.shape[0] // 2
    # the extra `down` of right padding covers the final frame
    stuffed = F.pad(stuffed, (pad, pad + down))
    y = F.conv1d(stuffed, h.to(audio.device)[None, None, :], stride=down)[:, 0]
    n_out = int(n * up / down)
    return y[:, :n_out].reshape(*lead_shape, -1)
