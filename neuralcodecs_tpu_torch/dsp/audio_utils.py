"""Host-side audio utilities (counterpart of neuralcodecs_tpu.dsp.audio_utils):
PCM conversion, channel layout and dB helpers on numpy arrays, and
SpecAugment-style masking of spectrogram tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def pcm16_to_float(data: bytes | np.ndarray) -> np.ndarray:
    arr = np.frombuffer(data, np.int16) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.int16)
    return arr.astype(np.float32) / 32768.0


def float_to_pcm16(audio: np.ndarray) -> bytes:
    clipped = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype(np.int16).tobytes()


def pcm24_to_float(data: bytes) -> np.ndarray:
    b = np.frombuffer(data, np.uint8).reshape(-1, 3)
    ints = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16))
    ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
    return ints.astype(np.float32) / float(1 << 23)


def pcm32_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.int32).astype(np.float32) / 2147483648.0


def interleave(channels: np.ndarray) -> np.ndarray:
    """[C, T] -> interleaved [T*C]."""
    return np.asarray(channels).T.reshape(-1)


def deinterleave(data: np.ndarray, num_channels: int) -> np.ndarray:
    """interleaved [T*C] -> [C, T]."""
    return np.asarray(data).reshape(-1, num_channels).T


def to_mono(audio: np.ndarray) -> np.ndarray:
    """[C, T] -> [T] mean mixdown."""
    audio = np.asarray(audio)
    return audio.mean(axis=0) if audio.ndim > 1 else audio


def db_to_linear(db):
    return 10.0 ** (np.asarray(db) / 20.0)


def linear_to_db(linear, floor: float = 1e-12):
    return 20.0 * np.log10(np.maximum(np.asarray(linear), floor))


def _mask_stripes(spec: torch.Tensor, dim: int, generator: torch.Generator,
                  max_width: int, num_masks: int, value: float) -> torch.Tensor:
    n = spec.shape[dim]
    idx = torch.arange(n, device=spec.device)
    if dim == -2:
        idx = idx[:, None]
    for _ in range(num_masks):
        width = int(torch.randint(1, max(max_width, 2), (), generator=generator,
                                  device=generator.device))
        start = int(torch.randint(0, max(n - max_width, 1), (), generator=generator,
                                  device=generator.device))
        spec = torch.where((idx >= start) & (idx < start + width), value, spec)
    return spec


def mask_time(spec: torch.Tensor, generator: torch.Generator, max_width: int,
              num_masks: int = 1, value: float = 0.0) -> torch.Tensor:
    """Set ``num_masks`` random time stripes of a [..., F, T] spectrogram to
    ``value``: widths in [1, max_width), drawn from ``generator``."""
    return _mask_stripes(spec, -1, generator, max_width, num_masks, value)


def mask_frequency(spec: torch.Tensor, generator: torch.Generator, max_width: int,
                   num_masks: int = 1, value: float = 0.0) -> torch.Tensor:
    """Set ``num_masks`` random frequency stripes of a [..., F, T]
    spectrogram to ``value``."""
    return _mask_stripes(spec, -2, generator, max_width, num_masks, value)
