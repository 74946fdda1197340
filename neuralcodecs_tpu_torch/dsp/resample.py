"""Resampling (counterpart of neuralcodecs_tpu.dsp.resample.linear_resample)."""

from __future__ import annotations

import torch


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
