"""Delay-pattern machinery for Dia's multi-channel code streams.

Counterpart of neuralcodecs_tpu.models.dia.audio_delay: channel c is shifted
right by delay[c] steps (BOS fills the head, PAD the tail); revert shifts
left. One ``torch.gather`` on clamped time indices, then the ``where``s.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _time_index(audio: torch.Tensor, delay_pattern: Sequence[int], sign: int) -> torch.Tensor:
    """[1, T, C] int64: t + sign·delay[c]."""
    t = audio.shape[1]
    delay = torch.tensor(list(delay_pattern), dtype=torch.int64, device=audio.device)
    return torch.arange(t, device=audio.device)[None, :, None] + sign * delay[None, None, :]


def apply_audio_delay(audio: torch.Tensor, pad_value: int, bos_value: int,
                      delay_pattern: Sequence[int]) -> torch.Tensor:
    """audio: [B, T, C] int -> delayed [B, T, C].

    out[b, t, c] = BOS                         if t < delay[c]
                 = audio[b, t - delay[c], c]   otherwise
    """
    b, t, c = audio.shape
    t_idx = _time_index(audio, delay_pattern, -1)
    gathered = torch.gather(audio, 1, t_idx.clamp(0, t - 1).expand(b, t, c))
    out = torch.where(t_idx < 0, bos_value, gathered)
    return torch.where(t_idx >= t, pad_value, out)


def revert_audio_delay(audio: torch.Tensor, pad_value: int,
                       delay_pattern: Sequence[int],
                       original_t: int | None = None) -> torch.Tensor:
    """Invert apply_audio_delay: out[b, t, c] = audio[b, t + delay[c], c],
    PAD from ``original_t`` (default T) on."""
    b, t, c = audio.shape
    t_cap = original_t if original_t is not None else t
    t_idx = _time_index(audio, delay_pattern, 1)
    gathered = torch.gather(audio, 1, t_idx.clamp(max=t - 1).expand(b, t, c))
    return torch.where(t_idx >= t_cap, pad_value, gathered)
