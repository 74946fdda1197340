"""Device copies of the DSP library's numpy constants (windows, filterbanks,
filter banks, channel weights), made once per device."""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=64)
def on_device(make, args: tuple, device: torch.device) -> torch.Tensor:
    """make(*args), a numpy array, as a tensor on ``device``; cached, so the
    copy happens once. A fresh copy on every call would be a blocking
    host-to-device copy, which makes the host wait for the kernels already
    queued before it can queue the next ones. Do not write to the result."""
    return torch.tensor(make(*args), device=device)
