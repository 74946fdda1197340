"""Vector-quantization codebook search (counterpart of neuralcodecs_tpu.ops.vq).

Score = ‖e‖² − 2·x·e; the ‖x‖² row constant cannot change the argmin and is
dropped. Ties break to the lowest index. The search itself is the codebook
kernel (ops/kernels/codebook.py): CUDA on a CUDA tensor, its plain PyTorch
version on a CPU tensor. Codes are integers and carry no gradient, so the
searches run outside autograd; ``quantize_st`` passes the gradient around
the search (straight-through).
"""

from __future__ import annotations

import torch

from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin


@torch.no_grad()
def l2_argmin_codes(latents: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook-entry indices.

    latents: [..., D] float; codebook: [N, D] float. Returns int32 [...]."""
    shape = latents.shape[:-1]
    flat = latents.reshape(-1, latents.shape[-1]).to(torch.float32).contiguous()
    codes = codebook_argmin(flat, codebook.to(torch.float32).contiguous())
    return codes.reshape(shape)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization over the last axis: x / max(‖x‖, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(norm, eps)


@torch.no_grad()
def cosine_argmin_codes(latents: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest entry under the ViT-VQGAN normalized lookup (SNAC/DAC): both
    the encodings and the codebook rows are L2-normalized before the search.
    The codes then embed the raw, un-normalized codebook (``codebook_lookup``
    on the raw table), as upstream does (PARITY.md divergence #12)."""
    return l2_argmin_codes(l2_normalize(latents), l2_normalize(codebook))


def codebook_lookup(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Embed code indices: [...] int -> [..., D]."""
    return codebook[codes.long()]


def quantize_st(latents: torch.Tensor, codebook: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize with straight-through gradients: (quantized [..., D], whose
    gradient flows to ``latents`` unchanged, codes int32 [...])."""
    codes = l2_argmin_codes(latents, codebook)
    quantized = codebook_lookup(codes, codebook).to(latents.dtype)
    return latents + (quantized - latents).detach(), codes
