"""Snake activation: x + sin²(αx)/α with a learnable per-channel α.

Counterpart of neuralcodecs_tpu.ops.snake, in torch's [B, C, T] layout,
including the α == 0 guard (identity at α = 0, the limit of sin²(αx)/α).
"""

from __future__ import annotations

import torch


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x: [B, C, T]; alpha: [C] or [1, C, 1]."""
    alpha = alpha.reshape(1, -1, 1).to(x.dtype)
    s = torch.sin(alpha * x)
    safe_alpha = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    return torch.where(alpha == 0, x, x + (s * s) / safe_alpha)
