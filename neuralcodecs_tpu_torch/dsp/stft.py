"""STFT / ISTFT (counterpart of neuralcodecs_tpu.dsp.stft).

``stft`` is ``torch.stft`` with the semantics the JAX package pins: reflect
padding when centred, the periodic window, one-sided, not normalised,
layout [..., n_fft // 2 + 1, frames]. ``istft`` is the JAX package's own
windowed overlap-add, divided by max(Σ window², 1e-11), not
``torch.istft``, which raises where the window envelope breaks the NOLA
condition and trims its output differently.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.core.device import as_audio
from neuralcodecs_tpu_torch.dsp.constants import on_device


@dataclass(frozen=True)
class STFTParams:
    window_length: int = 2048
    hop_length: int = 512
    window_type: str = "hann"
    center: bool = True
    match_stride: bool = False
    padding_mode: str = "reflect"


def get_window(window_type: str, window_length: int) -> np.ndarray:
    """Periodic window of ``window_length`` samples, f32 (numpy)."""
    n = window_length
    t = np.arange(n)
    wt = window_type.lower()
    if wt == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * t / n)
    elif wt == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * t / n)
    elif wt == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * t / n)
             + 0.08 * np.cos(4 * np.pi * t / n))
    elif wt == "bartlett":
        w = 1.0 - np.abs(2.0 * t / n - 1.0)
    elif wt == "sqrt_hann":
        w = np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * t / n))
    elif wt == "average":
        w = np.full(n, 1.0 / n)
    elif wt == "ones":
        w = np.ones(n)
    else:
        raise ValueError(f"Unsupported window type: {window_type}")
    return w.astype(np.float32)


def _window(window_type: str, n_fft: int, device: torch.device) -> torch.Tensor:
    return on_device(get_window, (window_type, n_fft), device)


def stft(audio: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         window_type: str = "hann", center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """[..., T] -> complex [..., n_fft // 2 + 1, frames]."""
    audio = as_audio(audio)
    lead, t = audio.shape[:-1], audio.shape[-1]
    spec = torch.stft(audio.reshape(-1, t), n_fft, hop_length=hop_length, win_length=n_fft,
                      window=_window(window_type, n_fft, audio.device), center=center,
                      pad_mode=pad_mode, normalized=False, onesided=True,
                      return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[N, frames, K] -> [N, K + hop·(frames − 1)], frames summed at hop."""
    n, n_frames, k = frames.shape
    total = k + hop_length * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, k),
                 stride=(1, hop_length))
    return out.reshape(n, total)


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
          window_type: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add: complex [..., freq, frames] ->
    [..., T]."""
    window = _window(window_type, n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    out = _overlap_add(frames.reshape(-1, n_frames, n_fft), hop_length)
    norm = _overlap_add((window * window).expand(1, n_frames, n_fft), hop_length)[0]
    out = (out / torch.clamp(norm, min=1e-11)).reshape(*lead, -1)
    t_total = out.shape[-1]
    if center:
        out = out[..., n_fft // 2:]
        return out[..., :length] if length is not None else out[..., : t_total - n_fft]
    return out[..., :length] if length is not None else out


def compute_stft_padding(length: int, window_length: int, hop_length: int,
                         match_stride: bool) -> tuple[int, int]:
    """(right, left) padding so the frame count aligns to hop multiples
    when match_stride is set."""
    if match_stride:
        if hop_length != window_length // 4:
            raise ValueError("match_stride requires hop == window // 4")
        right_pad = -(-length // hop_length) * hop_length - length
        pad = (window_length - hop_length) // 2
        return right_pad + pad, pad
    return 0, 0
