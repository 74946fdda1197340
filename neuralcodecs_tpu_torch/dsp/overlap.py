"""Windowed overlap-add recombination for chunked codecs.

Counterpart of neuralcodecs_tpu.dsp.overlap: triangular weights
w(t) = 0.5 - |t/(T+1) - 0.5| per frame, summed and renormalised. Frames may
differ in length (the final partial chunk takes the truncated full-frame
triangle).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _tri_weight(frame_length: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, frame_length + 2)[1:-1]
    return (0.5 - np.abs(t - 0.5)).astype(np.float32)


def linear_overlap_add(frames: Sequence[torch.Tensor], stride: int) -> torch.Tensor:
    """frames: [..., T_i] tensors; consecutive frames are offset by stride."""
    if not frames:
        raise ValueError("At least one frame is required")
    first = frames[0]
    total = stride * (len(frames) - 1) + frames[-1].shape[-1]
    out = first.new_zeros((*first.shape[:-1], total))
    sum_w = first.new_zeros(total)
    weight_full = torch.from_numpy(_tri_weight(first.shape[-1])).to(first.device, first.dtype)
    offset = 0
    for frame in frames:
        t = frame.shape[-1]
        w = weight_full[:t]
        out[..., offset:offset + t] += frame * w
        sum_w[offset:offset + t] += w
        offset += stride
    return out / torch.clamp_min(sum_w, 1e-10)
