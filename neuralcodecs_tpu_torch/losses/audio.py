"""Reconstruction losses on audio: L1, multi-scale mel / STFT, SI-SDR.

Counterpart of neuralcodecs_tpu.losses.audio, on the port's DSP: the STFT
is ``torch.stft`` (cuFFT on the card) and the mel filterbank a product by
its numpy constant (``dsp/mel.py``). Each loss is differentiable and runs
on the device of its inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from neuralcodecs_tpu_torch.dsp.mel import mel_spectrogram
from neuralcodecs_tpu_torch.dsp.stft import stft


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def _log_l1(x: torch.Tensor, y: torch.Tensor, clamp_eps: float, pow: float) -> torch.Tensor:
    return l1_loss(torch.log10(torch.clamp(x, min=clamp_eps) ** pow),
                   torch.log10(torch.clamp(y, min=clamp_eps) ** pow))


def mel_spectrogram_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    sample_rate: int,
    n_mels: Sequence[int] = (150, 80),
    window_lengths: Sequence[int] = (2048, 512),
    clamp_eps: float = 1e-5,
    mag_weight: float = 1.0,
    log_weight: float = 1.0,
    pow: float = 2.0,  # noqa: A002 — the reference's parameter name
    window_type: str = "hann",
) -> torch.Tensor:
    """Multi-scale mel L1 between estimate x and reference y ([..., T]): at
    each scale the L1 of the log mels (clamp, power, log10) and of the mels."""
    loss = x.new_zeros(())
    for nm, wl in zip(n_mels, window_lengths):
        x_mel = mel_spectrogram(x, sample_rate, n_mels=nm, n_fft=wl, hop_length=wl // 4,
                                window_type=window_type)
        y_mel = mel_spectrogram(y, sample_rate, n_mels=nm, n_fft=wl, hop_length=wl // 4,
                                window_type=window_type)
        loss = loss + log_weight * _log_l1(x_mel, y_mel, clamp_eps, pow)
        loss = loss + mag_weight * l1_loss(x_mel, y_mel)
    return loss


def multi_scale_stft_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    window_lengths: Sequence[int] = (2048, 512),
    clamp_eps: float = 1e-5,
    mag_weight: float = 1.0,
    log_weight: float = 1.0,
) -> torch.Tensor:
    """Multi-scale STFT magnitude loss (MultiScaleSTFTLossConfig defaults)."""
    loss = x.new_zeros(())
    for wl in window_lengths:
        x_mag = stft(x, n_fft=wl, hop_length=wl // 4).abs()
        y_mag = stft(y, n_fft=wl, hop_length=wl // 4).abs()
        loss = loss + log_weight * _log_l1(x_mag, y_mag, clamp_eps, 2.0)
        loss = loss + mag_weight * l1_loss(x_mag, y_mag)
    return loss


def sisdr_loss(
    estimates: torch.Tensor,
    references: torch.Tensor,
    scaling: bool = True,
    zero_mean: bool = True,
    clip_min: float | None = None,
    reduction: str = "mean",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Negative SI-SDR in dB of estimates against references, [..., T]."""
    est = estimates.reshape(-1, estimates.shape[-1]).to(torch.float32)
    ref = references.reshape(-1, references.shape[-1]).to(torch.float32)
    if zero_mean:
        est = est - torch.mean(est, dim=-1, keepdim=True)
        ref = ref - torch.mean(ref, dim=-1, keepdim=True)
    if scaling:
        scale = (torch.sum(est * ref, dim=-1, keepdim=True) + eps) / (
            torch.sum(ref * ref, dim=-1, keepdim=True) + eps)
    else:
        scale = torch.ones_like(ref[:, :1])
    target = scale * ref
    error = est - target
    t_pow = torch.sum(target * target, dim=-1)
    e_pow = torch.sum(error * error, dim=-1)
    loss = -10.0 * torch.log10(t_pow / (e_pow + eps) + eps)
    if clip_min is not None:
        loss = torch.clamp(loss, min=clip_min)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss
