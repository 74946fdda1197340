"""ITU-R BS.1770-4 loudness (counterpart of neuralcodecs_tpu.dsp.loudness):
K-weighting by two biquads, then 400 ms blocks at 75% overlap with the
absolute (−70 LUFS) and relative (−10 dB) gates.

As in the JAX package, the 48 kHz K-weighting coefficients are applied at
every sample rate, and the channel weights allow at most 5 channels: a batch
of mono clips is [B, 1, T].
"""

from __future__ import annotations

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.device import as_audio
from neuralcodecs_tpu_torch.dsp.constants import on_device
from neuralcodecs_tpu_torch.dsp.filters import biquad

GAIN_FACTOR = 0.11512925464970229  # ln(10) / 20

# BS.1770 pre-filter coefficients at 48 kHz
_HIGH_SHELF_B = (1.53512485958697, -2.69169618940638, 1.19839281085285)
_HIGH_SHELF_A = (1.0, -1.69065929318241, 0.73248077421585)
_HIGH_PASS_B = (1.0, -2.0, 1.0)
_HIGH_PASS_A = (1.0, -1.99004745483398, 0.99007225036621)

#: per-channel weights: L, R, C, Ls, Rs
_K_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.41, 1.41], np.float32)


def _k_weights(channels: int) -> np.ndarray:
    return _K_WEIGHTS[:channels]


def _as_bct(audio) -> torch.Tensor:
    a = as_audio(audio)
    if a.dim() == 1:
        return a[None, None, :]
    return a[None] if a.dim() == 2 else a


def k_weighting(audio: torch.Tensor) -> torch.Tensor:
    """The K pre-filter chain (high shelf, then high pass) over [..., T]."""
    x = biquad(audio, _HIGH_SHELF_B, _HIGH_SHELF_A)
    return biquad(x, _HIGH_PASS_B, _HIGH_PASS_A)


def _lufs(power: torch.Tensor) -> torch.Tensor:
    return -0.691 + 10.0 * torch.log10(torch.clamp(power, min=1e-12))


def integrated_loudness(audio, sample_rate: int = 44100,
                        block_size: float = 0.400) -> torch.Tensor:
    """Gated integrated loudness in LUFS, [B], of [B, C, T] (or [C, T] / [T])."""
    a = _as_bct(audio)
    c, t = a.shape[1], a.shape[2]
    weights = on_device(_k_weights, (c,), a.device)
    filtered = k_weighting(a)
    kernel = int(block_size * sample_rate)
    stride = int(kernel * 0.25)  # 75% overlap
    if t < kernel:
        filtered = torch.nn.functional.pad(filtered, (0, kernel - t))
    blocks = filtered.unfold(-1, kernel, stride)          # [B, C, n_blocks, K] (a view)
    z = torch.sum(blocks * blocks, dim=-1) / kernel       # [B, C, n_blocks]
    l_blocks = _lufs(torch.sum(weights[None, :, None] * z, dim=1))  # [B, n_blocks]

    abs_mask = l_blocks > -70.0
    denom = torch.clamp(abs_mask.sum(-1), min=1)
    z_abs = torch.where(abs_mask[:, None, :], z, 0.0).sum(-1) / denom[:, None]
    gamma_r = _lufs(torch.sum(z_abs * weights[None, :], dim=-1)) - 10.0

    both = abs_mask & (l_blocks > gamma_r[:, None])
    denom = torch.clamp(both.sum(-1), min=1)
    z_gated = torch.nan_to_num(torch.where(both[:, None, :], z, 0.0).sum(-1) / denom[:, None])
    return _lufs(torch.sum(weights[None, :] * z_gated, dim=-1))


def normalize_loudness(audio, sample_rate: int, target_db: float = -24.0) -> torch.Tensor:
    """Gain each batch item of the audio to ``target_db`` LUFS."""
    a = as_audio(audio)
    gain = torch.exp((target_db - integrated_loudness(a, sample_rate)) * GAIN_FACTOR)
    if a.dim() == 1:
        return a * gain[0]
    return a * gain.reshape([-1] + [1] * (a.dim() - 1))
