"""Mel filterbanks, mel spectrograms, MFCC (counterpart of
neuralcodecs_tpu.dsp.mel).

The filterbank and the DCT basis are numpy constants, copies of the JAX
package's (bit-equal, pinned by the tests); each is applied as one product
over the magnitude spectrogram, which runs in full f32 with TF32 off
(``ops/precision.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from neuralcodecs_tpu_torch.dsp.constants import on_device
from neuralcodecs_tpu_torch.dsp.stft import stft


def hz_to_mel(f) -> np.ndarray:
    """HTK mel scale: 2595·log10(1 + f/700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=64)
def mel_filterbank(sample_rate: int, n_mels: int, n_fft: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft // 2 + 1] with Slaney area
    normalisation, f32. Cached: do not write to the result."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    lower = hz_pts[:-2][:, None]
    center = hz_pts[1:-1][:, None]
    upper = hz_pts[2:][:, None]
    f = fft_freqs[None, :]
    up_slope = (f - lower) / np.maximum(center - lower, 1e-10)
    down_slope = (upper - f) / np.maximum(upper - center, 1e-10)
    fb = np.maximum(0.0, np.minimum(up_slope, down_slope))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    return (fb * enorm[:, None]).astype(np.float32)


def mel_spectrogram(audio: torch.Tensor, sample_rate: int, n_mels: int = 80,
                    n_fft: int = 2048, hop_length: int = 512, window_type: str = "hann",
                    f_min: float = 0.0, f_max: float | None = None, power: float = 1.0,
                    center: bool = True) -> torch.Tensor:
    """[..., T] -> mel spectrogram [..., n_mels, frames] of |stft|^power."""
    spec = stft(audio, n_fft=n_fft, hop_length=hop_length, window_type=window_type,
                center=center)
    mag = spec.abs()
    if power != 1.0:
        mag = mag ** power
    fb = on_device(mel_filterbank, (sample_rate, n_mels, n_fft, f_min, f_max), mag.device)
    return torch.einsum("mf,...ft->...mt", fb, mag)


@lru_cache(maxsize=16)
def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_mfcc, n_mels], f32. Cached: do not write
    to the result."""
    mel_idx = np.arange(n_mels)
    mfcc_idx = np.arange(n_mfcc)[:, None]
    m = np.cos(mfcc_idx * (2 * mel_idx + 1) * np.pi / (2 * n_mels))
    m *= np.sqrt(2.0 / n_mels)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def mfcc(audio: torch.Tensor, sample_rate: int, n_mfcc: int = 40, n_mels: int = 80,
         n_fft: int = 2048, hop_length: int = 512, log_offset: float = 1e-6) -> torch.Tensor:
    """[..., T] -> MFCC [..., n_mfcc, frames]: DCT of the log power mel."""
    mel = mel_spectrogram(audio, sample_rate, n_mels=n_mels, n_fft=n_fft,
                          hop_length=hop_length, power=2.0)
    dct = on_device(dct_matrix, (n_mfcc, n_mels), mel.device)
    return torch.einsum("cm,...mt->...ct", dct, torch.log(mel + log_offset))
