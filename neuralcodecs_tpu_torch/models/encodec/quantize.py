"""Encodec residual vector quantizer with EMA codebooks, PyTorch port.

Counterpart of neuralcodecs_tpu.models.encodec.quantize. The codebook
search is the plain L2 argmin of ``ops.vq.l2_argmin_codes`` (upstream
Encodec does not normalise), which runs the codebook kernel on a CUDA
device, in inference, in the training forward and in kmeans.

Training: the EMA update (cluster-size EMA, embed-sum EMA, Laplace
smoothing) is a function of a ``CodebookState``, state in, state out, as in
JAX; under data parallelism the batch statistics are summed over the dp
group (``dp_group``, one all-reduce) before the EMA, where JAX takes a psum
over ``dp_axis``. Random draws come from an explicit ``torch.Generator``,
each in one small function (``draw_sample_indices``, ``draw_kmeans_init``),
which cannot give ``jax.random``'s numbers: the tests replace them by the
JAX side's draws.

Layouts: latents are [B, D, T] inside the model and at the RVQ's methods,
[B, T, D] at a ``VectorQuantizer``'s; codes are [B, n_q, T].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from neuralcodecs_tpu_torch.ops.vq import codebook_lookup, l2_argmin_codes


class QuantizedResult(NamedTuple):
    """``quantize_with_bandwidth``'s output."""

    quantized: torch.Tensor   # [B, D, T]
    codes: torch.Tensor       # [B, n_q, T]
    bandwidth: torch.Tensor   # [B] kbps actually used
    penalty: torch.Tensor     # mean commitment loss


class CodebookState(NamedTuple):
    """EMA codebook training state (embed is what inference reads)."""

    embed: torch.Tensor         # [K, D]
    embed_avg: torch.Tensor     # [K, D]
    cluster_size: torch.Tensor  # [K]
    inited: torch.Tensor        # [1] float {0, 1}


def draw_sample_indices(generator: torch.Generator | None, n: int, num: int) -> torch.Tensor:
    """``num`` row indices in [0, n), with replacement."""
    device = generator.device if generator is not None else None
    return torch.randint(0, n, (num,), generator=generator, device=device)


def draw_kmeans_init(generator: torch.Generator | None, n: int, num_clusters: int
                     ) -> torch.Tensor:
    """The first ``num_clusters`` of a random permutation of n rows."""
    device = generator.device if generator is not None else None
    return torch.randperm(n, generator=generator, device=device)[:num_clusters]


def _bin_sums(samples: torch.Tensor, codes: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows a code, sum of its rows) as JAX forms them: one-hot [N, K],
    its column sums, and its product with the samples."""
    onehot = torch.nn.functional.one_hot(codes.long(), k).to(samples.dtype)
    return onehot.sum(dim=0), onehot.t() @ samples


class EuclideanCodebook(nn.Module):
    """EMA codebook. ``embed`` [K, D] is what inference reads; ``embed_avg``,
    ``cluster_size`` and ``inited`` are the training state, kept as buffers
    so that the state dict matches the JAX parameters."""

    def __init__(self, dim: int, codebook_size: int, *, decay: float = 0.99,
                 epsilon: float = 1e-5, threshold_ema_dead_code: int = 2):
        super().__init__()
        self.codebook_size = codebook_size
        self.decay = decay
        self.epsilon = epsilon
        self.threshold = threshold_ema_dead_code
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

    # -- training ------------------------------------------------------------

    @torch.no_grad()
    def ema_update(self, state: CodebookState, flat_x: torch.Tensor, codes: torch.Tensor,
                   dp_group=None) -> CodebookState:
        """One EMA step. flat_x [N, D], codes [N]. With ``dp_group`` the
        batch statistics are summed over the group first (one all-reduce),
        so every rank's state takes the global batch's step."""
        batch_size, embed_sum = _bin_sums(flat_x, codes, self.codebook_size)
        if dp_group is not None:
            from neuralcodecs_tpu_torch.parallel.collectives import all_reduce_sum

            both = all_reduce_sum(torch.cat([batch_size[:, None], embed_sum], dim=1), dp_group)
            batch_size, embed_sum = both[:, 0], both[:, 1:]
        cluster_size = state.cluster_size * self.decay + batch_size * (1 - self.decay)
        embed_avg = state.embed_avg * self.decay + embed_sum * (1 - self.decay)
        n = torch.sum(cluster_size)
        smoothed = ((cluster_size + self.epsilon)
                    / (n + self.codebook_size * self.epsilon) * n)
        embed = embed_avg / smoothed[:, None]
        return CodebookState(embed=embed, embed_avg=embed_avg, cluster_size=cluster_size,
                             inited=state.inited)

    @torch.no_grad()
    def expire_codes(self, generator: torch.Generator | None, state: CodebookState,
                     batch_samples: torch.Tensor) -> CodebookState:
        """Replace dead codes (EMA cluster size < threshold) with random
        rows of ``batch_samples`` [..., D]. Under dp, hand every rank the
        same samples and generator seed, so that the replicas stay equal."""
        if self.threshold == 0:
            return state
        flat = batch_samples.reshape(-1, batch_samples.shape[-1])
        replacements = sample_vectors(generator, flat, self.codebook_size)
        expired = state.cluster_size < self.threshold
        return state._replace(embed=torch.where(expired[:, None], replacements, state.embed))

    def state_from_params(self) -> CodebookState:
        return CodebookState(embed=self.embed, embed_avg=self.embed_avg,
                             cluster_size=self.cluster_size, inited=self.inited)

    @torch.no_grad()
    def state_to_params(self, state: CodebookState) -> None:
        """Write ``state`` into the module's buffers, in place."""
        for name, value in state._asdict().items():
            getattr(self, name).copy_(value)


def uniform_init(generator: torch.Generator | None, shape: tuple[int, ...],
                 scale: float | None = None) -> torch.Tensor:
    """U(-b, b) with b = ``scale`` or 1/sqrt(shape[0]), the codebook init."""
    bound = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    device = generator.device if generator is not None else None
    return (2.0 * torch.rand(shape, generator=generator, device=device) - 1.0) * bound


def sample_vectors(generator: torch.Generator | None, samples: torch.Tensor, num: int
                   ) -> torch.Tensor:
    """``num`` rows of ``samples`` [N, D], with replacement."""
    return samples[draw_sample_indices(generator, samples.shape[0], num).to(samples.device)]


@torch.no_grad()
def kmeans(generator: torch.Generator | None, samples: torch.Tensor, num_clusters: int,
           num_iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """K-means codebook init. samples [N, D] -> (means [K, D], bins [K]).
    Starts from ``num_clusters`` distinct rows; each iteration assigns every
    row by ``l2_argmin_codes`` (the codebook kernel on a card) and moves
    each non-empty cluster to its rows' mean."""
    idx = draw_kmeans_init(generator, samples.shape[0], num_clusters).to(samples.device)
    means = samples[idx]
    for _ in range(num_iters):
        bins, sums = _bin_sums(samples, l2_argmin_codes(samples, means), num_clusters)
        new_means = sums / torch.clamp(bins, min=1.0)[:, None]
        means = torch.where(bins[:, None] > 0, new_means, means)
    bins, _ = _bin_sums(samples, l2_argmin_codes(samples, means), num_clusters)
    return means, bins


class VectorQuantizer(nn.Module):
    """One RVQ stage: optional ``project_in`` / ``project_out`` (torch
    Linear) around the codebook when ``codebook_dim`` differs from ``dim``;
    the Encodec presets have none."""

    def __init__(self, dim: int, codebook_size: int, codebook_dim: int | None = None, *,
                 decay: float = 0.99, commitment_weight: float = 1.0):
        super().__init__()
        codebook_dim = codebook_dim or dim
        self.requires_projection = codebook_dim != dim
        self.commitment_weight = commitment_weight
        if self.requires_projection:
            self.project_in = nn.Linear(dim, codebook_dim)
            self.project_out = nn.Linear(codebook_dim, dim)
        self.codebook = EuclideanCodebook(codebook_dim, codebook_size, decay=decay)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] -> codes [B, T]."""
        if self.requires_projection:
            x = self.project_in(x)
        return self.codebook.quantize(x)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T] -> [B, T, D]."""
        q = self.codebook.dequantize(codes)
        return self.project_out(q) if self.requires_projection else q

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, T, D] -> (quantized [B, T, D], straight through; codes [B, T];
        the weighted commitment loss). The straight-through output and the
        commitment loss are taken in codebook space, then projected back."""
        if self.requires_projection:
            x = self.project_in(x)
        codes = self.codebook.quantize(x)
        quantized = self.codebook.dequantize(codes).to(x.dtype)
        commit = torch.mean((quantized.detach() - x) ** 2)
        quantized = x + (quantized - x).detach()
        if self.requires_projection:
            quantized = self.project_out(quantized)
        return quantized, codes, commit * self.commitment_weight


class ResidualVectorQuantizer(nn.Module):
    """Multi-stage RVQ with the bandwidth → n_q selection."""

    def __init__(self, dim: int, num_quantizers: int, codebook_size: int, *,
                 codebook_dim: int | None = None, decay: float = 0.99):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.layers = nn.ModuleList(VectorQuantizer(dim, codebook_size, codebook_dim,
                                                    decay=decay)
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

    def forward(self, x: torch.Tensor, n_q: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The training forward: x [B, D, T] -> (quantized [B, D, T], codes
        [B, n_q, T], each stage's commitment loss [n_q]). Each stage
        quantizes the residual the earlier stages' detached outputs leave."""
        n_q = n_q or self.num_quantizers
        residual = x.to(torch.float32).transpose(1, 2)               # [B, T, D]
        quantized_out = torch.zeros_like(residual)
        all_codes, all_losses = [], []
        for layer in self.layers[:n_q]:
            quantized, codes, loss = layer(residual)
            residual = residual - quantized.detach()
            quantized_out = quantized_out + quantized
            all_codes.append(codes)
            all_losses.append(loss)
        return (quantized_out.transpose(1, 2), torch.stack(all_codes, dim=1),
                torch.stack(all_losses))

    def quantize_with_bandwidth(self, x: torch.Tensor, frame_rate: float,
                                bandwidth: float | None = None) -> QuantizedResult:
        """The training forward at the stages ``bandwidth`` kbps allows."""
        n_q = self.num_quantizers_for_bandwidth(frame_rate, bandwidth)
        quantized, codes, losses = self(x, n_q)
        bw_per_q = self.bandwidth_per_quantizer(frame_rate) / 1000.0
        bw = torch.full((x.shape[0],), n_q * bw_per_q, dtype=torch.float32, device=x.device)
        return QuantizedResult(quantized=quantized, codes=codes, bandwidth=bw,
                               penalty=torch.mean(losses))
