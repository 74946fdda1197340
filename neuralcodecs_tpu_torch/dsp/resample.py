"""Resampling (counterpart of neuralcodecs_tpu.dsp.resample).

``linear_resample`` is the host-style linear interpolator SNAC uses;
``resample_poly`` is the windowed-sinc polyphase resampler of Encodec's
``process_audio`` and ``AudioSignal.resample``. The JAX package writes it as
zero-stuff by ``up``, filter with a Kaiser-windowed sinc, keep every
``down``-th sample; the port computes the same sums without the zeros (see
``_phase_filters``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.core.device import as_audio
from neuralcodecs_tpu_torch.dsp.constants import on_device


def linear_resample(audio: torch.Tensor, src_rate: int, dst_rate: int) -> torch.Tensor:
    """Linear-interpolation resampling over the last axis; the tail holds
    the last sample."""
    audio = as_audio(audio)
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


@lru_cache(maxsize=16)
def _phase_filters(up: int, down: int, num_zeros: int) -> tuple[np.ndarray, int]:
    """The resampler's prototype split into its ``up`` phases, as one bank of
    ``up`` filters over the unstuffed signal; and the bank's input offset.

    Output m of the JAX form sums h[k] · s[m·down + k] over the zero-stuffed
    signal s, padded by pad = taps // 2, whose non-zero samples are
    s[pad + i·up] = x[i]. Only the taps k ≡ pad − m·down (mod up) meet a
    non-zero sample, and up and down are coprime, so m = q·up + p gives
      y[q·up + p] = Σ_j h[o_p + j·up] · x[q·down + c_p + j],
    with c_p = ceil((p·down − pad) / up) and o_p = c_p·up − (p·down − pad).
    Row p of the bank holds phase p's taps at offset c_p − c_0, so one conv
    at stride ``down`` over x, left-padded by −c_0 = num_zeros zeros, gives
    every phase at once. Returns (bank [up, L] f32, c_0)."""
    h = _kaiser_sinc_filter(num_zeros, up, min(1.0, up / down) * 0.945)
    taps, pad = h.shape[0], h.shape[0] // 2
    c = [-((pad - p * down) // up) for p in range(up)]  # ceil((p·down − pad) / up)
    length = max(c[p] - c[0] + len(range(c[p] * up - (p * down - pad), taps, up))
                 for p in range(up))
    bank = np.zeros((up, length), np.float32)
    for p in range(up):
        phase = h[c[p] * up - (p * down - pad)::up]
        bank[p, c[p] - c[0]: c[p] - c[0] + len(phase)] = phase
    return bank, c[0]


def _phase_conv_weight(up: int, down: int, num_zeros: int) -> np.ndarray:
    return _phase_filters(up, down, num_zeros)[0][:, None, :]


def resample_poly(audio: torch.Tensor, src_rate: int, dst_rate: int,
                  num_zeros: int = 24) -> torch.Tensor:
    """Polyphase resampling of [..., T]: the JAX package's zero-stuffed
    strided conv, computed as one conv of the phase filters over the
    unstuffed signal (no buffer of zeros; about 49 taps an output)."""
    audio = as_audio(audio)
    if src_rate == dst_rate:
        return audio
    g = math.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    bank, c0 = _phase_filters(up, down, num_zeros)
    lead_shape, n = audio.shape[:-1], audio.shape[-1]
    # the JAX form keeps int(n·up/down) outputs, as far as its conv reaches
    n_out = min(int(n * up / down), ((n - 1) * up + down) // down + 1)
    q = max(1, -(-n_out // up))  # outputs per phase
    length = bank.shape[1]
    right = max(0, (q - 1) * down + length - (n - c0))
    x = F.pad(audio.reshape(-1, 1, n), (-c0, right))
    w = on_device(_phase_conv_weight, (up, down, num_zeros), audio.device)  # [up, 1, L]
    y = F.conv1d(x, w, stride=down)[..., :q]  # [B, up, q]: phase p in channel p
    y = y.transpose(1, 2).reshape(x.shape[0], q * up)  # interleave: m = q·up + p
    return y[:, :n_out].reshape(*lead_shape, -1)
