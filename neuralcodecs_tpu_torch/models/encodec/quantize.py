"""Encodec residual vector quantizer, inference half, PyTorch port.

Counterpart of neuralcodecs_tpu.models.encodec.quantize. The codebook
search is the plain L2 argmin of ``ops.vq.l2_argmin_codes`` (upstream
Encodec does not normalise), which runs the codebook kernel on a CUDA
device. The EMA update and kmeans belong to training and are not ported
yet (ROADMAP).

Layouts: latents are [B, D, T] inside the model; codes are [B, n_q, T].
"""

from __future__ import annotations

import math

import torch
from torch import nn

from neuralcodecs_tpu_torch.ops.vq import codebook_lookup, l2_argmin_codes


class EuclideanCodebook(nn.Module):
    """EMA codebook. ``embed`` [K, D] is what inference reads; ``embed_avg``,
    ``cluster_size`` and ``inited`` are the training state, kept as buffers
    so that the state dict matches the JAX parameters."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        bound = 1.0 / math.sqrt(codebook_size)
        embed = torch.empty(codebook_size, dim).uniform_(-bound, bound)
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("inited", torch.ones(1))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., D] -> int32 codes [...]."""
        return l2_argmin_codes(x, self.embed)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        return codebook_lookup(codes, self.embed)


class VectorQuantizer(nn.Module):
    """One RVQ stage: optional ``project_in`` / ``project_out`` (torch
    Linear) around the codebook when ``codebook_dim`` differs from ``dim``;
    the Encodec presets have none."""

    def __init__(self, dim: int, codebook_size: int, codebook_dim: int | None = None):
        super().__init__()
        codebook_dim = codebook_dim or dim
        self.requires_projection = codebook_dim != dim
        if self.requires_projection:
            self.project_in = nn.Linear(dim, codebook_dim)
            self.project_out = nn.Linear(codebook_dim, dim)
        self.codebook = EuclideanCodebook(codebook_dim, codebook_size)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] -> codes [B, T]."""
        if self.requires_projection:
            x = self.project_in(x)
        return self.codebook.quantize(x)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T] -> [B, T, D]."""
        q = self.codebook.dequantize(codes)
        return self.project_out(q) if self.requires_projection else q


class ResidualVectorQuantizer(nn.Module):
    """Multi-stage RVQ with the bandwidth → n_q selection."""

    def __init__(self, dim: int, num_quantizers: int, codebook_size: int, *,
                 codebook_dim: int | None = None):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.layers = nn.ModuleList(VectorQuantizer(dim, codebook_size, codebook_dim)
                                    for _ in range(num_quantizers))

    def bandwidth_per_quantizer(self, frame_rate: float) -> float:
        return math.log2(self.codebook_size) * frame_rate

    def num_quantizers_for_bandwidth(self, frame_rate: float, bandwidth: float | None) -> int:
        """Codebooks that fit ``bandwidth`` kbps, at least 1 and at most the
        stages that exist; all of them when no bandwidth is given."""
        bw_per_q = self.bandwidth_per_quantizer(frame_rate)
        if bandwidth is not None and bandwidth > 0:
            return min(self.num_quantizers,
                       max(1, int(math.floor(bandwidth * 1000 / bw_per_q))))
        return self.num_quantizers

    def encode(self, x: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
        """x [B, D, T] -> int32 codes [B, n_q, T]."""
        n_q = n_q or self.num_quantizers
        residual = x.to(torch.float32).transpose(1, 2)               # [B, T, D]
        all_codes = []
        for layer in self.layers[:n_q]:
            codes = layer.encode(residual)
            residual = residual - layer.decode(codes)
            all_codes.append(codes)
        return torch.stack(all_codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, n_q, T] -> [B, D, T]."""
        out = self.layers[0].decode(codes[:, 0])
        for i in range(1, codes.shape[1]):
            out = out + self.layers[i].decode(codes[:, i])
        return out.transpose(1, 2)
