"""Audio effects (counterpart of neuralcodecs_tpu.dsp.effects): compressor,
delay, distortion, flanger, high/low pass, reverb, tremolo, chorus, phaser,
pitch shift.

Each takes [T], [C, T] or [B, C, T] and returns the same shape. The
compressor's envelope follower runs on the envelope kernel; the other
recursive elements are the plain loops of ``dsp/filters.py``, and the
phaser's per-sample coefficient sweep is a plain loop too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.device import as_audio
from neuralcodecs_tpu_torch.dsp.filters import (
    allpass_filter, comb_filter, fir_filter, one_pole_follower, variable_delay_line)
from neuralcodecs_tpu_torch.dsp.resample import linear_resample


def _as_bct(audio) -> tuple[torch.Tensor, tuple[int, ...]]:
    a = as_audio(audio)
    orig = tuple(a.shape)
    if a.dim() == 1:
        a = a[None, None, :]
    elif a.dim() == 2:
        a = a[None]
    return a, orig


def _restore(a: torch.Tensor, orig: tuple[int, ...]) -> torch.Tensor:
    return a.reshape(orig) if len(orig) < 3 else a


def _time(t: int, sample_rate: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.float32, device=device) / sample_rate


def apply_compressor(audio, sample_rate: int, threshold: float = -20.0, ratio: float = 4.0,
                     attack_time: float = 0.005, release_time: float = 0.050,
                     makeup_gain: float = 0.0) -> torch.Tensor:
    """Feed-forward compressor driven by an attack/release envelope follower."""
    a, orig = _as_bct(audio)
    threshold_lin = 10.0 ** (threshold / 20.0)
    attack_gain = 1.0 - math.exp(-1.0 / max(int(attack_time * sample_rate), 1))
    release_gain = 1.0 - math.exp(-1.0 / max(int(release_time * sample_rate), 1))
    envelope = one_pole_follower(a, attack_gain, release_gain)
    reduction = torch.where(envelope > threshold_lin,
                            (envelope / threshold_lin) ** (1.0 / ratio - 1.0), 1.0)
    makeup = 10.0 ** (makeup_gain / 20.0)
    return _restore(a * reduction * makeup, orig)


def apply_delay(audio, sample_rate: int, delay_time: float = 0.3, feedback: float = 0.3,
                wet_level: float = 0.3, dry_level: float = 0.7) -> torch.Tensor:
    """Feedback delay, as the finite geometric series of shifted copies that
    the delay-line recursion expands to."""
    a, orig = _as_bct(audio)
    d = max(int(delay_time * sample_rate), 1)
    t = a.shape[-1]
    wet = torch.zeros_like(a)
    gain, shift = 1.0, d
    while shift < t:
        wet[..., shift:] += gain * a[..., : t - shift]
        gain *= feedback
        shift += d
        if gain < 1e-6:
            break
    return _restore(dry_level * a + wet_level * wet, orig)


def apply_distortion(audio, amount: float = 0.5, wet_level: float = 1.0) -> torch.Tensor:
    """tanh waveshaper."""
    a, orig = _as_bct(audio)
    processed = torch.tanh(a * (1 + amount * 10))
    return _restore(processed * wet_level + a * (1 - wet_level), orig)


def apply_flanger(audio, sample_rate: int, rate: float = 0.5, depth: float = 0.002,
                  feedback: float = 0.7, wet_level: float = 0.7) -> torch.Tensor:
    """LFO-modulated fractional delay with feedback."""
    a, orig = _as_bct(audio)
    time = _time(a.shape[-1], sample_rate, a.device)
    max_delay = max(int(depth * sample_rate), 1)
    lfo = max_delay * 0.5 * (1 + torch.sin(2 * math.pi * rate * time))
    wet = variable_delay_line(a, lfo, max_delay, feedback)
    return _restore((1 - wet_level) * a + wet_level * wet, orig)


def _windowed_sinc(order: int, norm_cutoff: float, highpass: bool) -> np.ndarray:
    """Hamming-windowed sinc prototype, f32 (numpy)."""
    order = order + 1 if order % 2 == 0 else order
    n = np.arange(-(order // 2), order // 2 + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        sinc = np.where(n == 0, 2 * norm_cutoff,
                        np.sin(2 * np.pi * norm_cutoff * n) / (n * np.pi))
    if highpass:
        h = -sinc
        h[order // 2] += 1.0
    else:
        h = sinc
    window = 0.54 - 0.46 * np.cos(2 * np.pi * (n + order // 2) / order)
    h = h * window
    h = h / np.abs(h).sum() if highpass else h / h.sum()
    return h.astype(np.float32)


def apply_highpass(audio, sample_rate: int, cutoff_freq: float = 1000.0,
                   filter_order: int = 51) -> torch.Tensor:
    a, orig = _as_bct(audio)
    h = _windowed_sinc(filter_order, cutoff_freq / sample_rate, highpass=True)
    return _restore(fir_filter(a, h), orig)


def apply_lowpass(audio, sample_rate: int, cutoff_freq: float = 1000.0,
                  filter_order: int = 51) -> torch.Tensor:
    a, orig = _as_bct(audio)
    h = _windowed_sinc(filter_order, cutoff_freq / sample_rate, highpass=False)
    return _restore(fir_filter(a, h), orig)


_COMB_DELAYS = (1557, 1617, 1491, 1422, 1277, 1356, 1188, 1116)
_ALLPASS_DELAYS = (225, 556, 441, 341)


def apply_reverb(audio, room_size: float = 0.8, damping: float = 0.5,
                 wet_level: float = 0.3, dry_level: float = 0.7) -> torch.Tensor:
    """Schroeder reverberator: 8 damped combs in parallel, then 4 allpasses."""
    a, orig = _as_bct(audio)
    room_size = float(np.clip(room_size, 0, 1))
    damping = float(np.clip(damping, 0, 1))
    feedback = room_size * 0.84
    wet = torch.zeros_like(a)
    for delay in _COMB_DELAYS:
        wet = wet + comb_filter(a, delay, feedback, damping)
    for delay in _ALLPASS_DELAYS:
        wet = allpass_filter(wet, delay, 0.5)
    return _restore(dry_level * a + wet_level * wet, orig)


def apply_tremolo(audio, sample_rate: int, rate: float = 5.0, depth: float = 0.5) -> torch.Tensor:
    """Amplitude LFO."""
    a, orig = _as_bct(audio)
    time = _time(a.shape[-1], sample_rate, a.device)
    lfo = 1 - depth + depth * torch.sin(2 * math.pi * rate * time)
    return _restore(a * lfo, orig)


def apply_chorus(audio, sample_rate: int, rate: float = 1.5, depth: float = 0.007,
                 voices: int = 3, wet_level: float = 0.5) -> torch.Tensor:
    """Multi-voice modulated delay."""
    a, orig = _as_bct(audio)
    time = _time(a.shape[-1], sample_rate, a.device)
    max_delay = max(int(depth * sample_rate), 1)
    wet = torch.zeros_like(a)
    for v in range(voices):
        phase = 2 * math.pi * v / voices
        lfo = max_delay * 0.5 * (1 + torch.sin(2 * math.pi * rate * time + phase))
        wet = wet + variable_delay_line(a, lfo, max_delay, 0.0)
    wet = wet / voices
    return _restore((1 - wet_level) * a + wet_level * wet, orig)


def apply_phaser(audio, sample_rate: int, rate: float = 0.5, depth: float = 0.7,
                 stages: int = 4, wet_level: float = 0.5) -> torch.Tensor:
    """Cascaded first-order allpass sections, their corner swept by an LFO
    between 200 and 2000 Hz."""
    a, orig = _as_bct(audio)
    t = a.shape[-1]
    time = _time(t, sample_rate, a.device)
    freq = 200.0 * (10.0 ** (depth * (0.5 + 0.5 * torch.sin(2 * math.pi * rate * time))))
    tan = torch.tan(math.pi * freq / sample_rate)
    coeff = (tan - 1) / (tan + 1)
    y = a.reshape(-1, t).t()  # [T, N]
    for _ in range(stages):
        z = y.new_zeros(y.shape[1])
        out = torch.empty_like(y)
        for i in range(t):
            out[i] = coeff[i] * y[i] + z
            z = y[i] - coeff[i] * out[i]
        y = out
    wet = y.t().reshape(a.shape)
    return _restore((1 - wet_level) * a + wet_level * wet, orig)


def apply_pitch_shift(audio, sample_rate: int, semitones: float = 0.0) -> torch.Tensor:
    """Pitch shift by resampling: shift the rate, then resample back to the
    original length."""
    if abs(semitones) < 1e-9:
        return as_audio(audio)
    a, orig = _as_bct(audio)
    shifted_rate = max(int(sample_rate / (2.0 ** (semitones / 12.0))), 1)
    out = linear_resample(linear_resample(a, sample_rate, shifted_rate), shifted_rate,
                          sample_rate)
    t = a.shape[-1]
    if out.shape[-1] < t:
        out = torch.nn.functional.pad(out, (0, t - out.shape[-1]))
    return _restore(out[..., :t], orig)
