"""Shared layer building blocks for the conv codec families (SNAC, then DAC).

Counterpart of neuralcodecs_tpu.models.layers as torch ``nn.Module``s. The
parameter names are the folded checkpoint names (``<prefix>.weight``,
``<prefix>.alpha``, ``block.<i>`` children), so a weight-norm-folded
hubertsiuzdak/snac state dict loads with ``load_state_dict(strict=True)``.
Activations are [B, C, T].

Modules that draw decoder noise take a ``torch.Generator`` (or None for the
noise-free path); ``Sequential`` hands it to the children that take one.

Each module computes in its input's dtype, as in the JAX package: convs
cast their weight to it and add their f32 bias after (ops/conv.py), Snake
casts α, NoiseBlock draws its noise in it. ``ResidualUnit`` hands its input
to the fused kernel, which takes f32 only (ops/kernels/resunit.py).
"""

from __future__ import annotations

import torch
from torch import nn

from neuralcodecs_tpu_torch.ops.attention import local_mha
from neuralcodecs_tpu_torch.ops.conv import conv1d, conv_transpose1d
from neuralcodecs_tpu_torch.ops.kernels.resunit import KERNEL, fused_residual_unit
from neuralcodecs_tpu_torch.ops.snake import snake


class WNConv1d(nn.Conv1d):
    """Weight-norm conv with the norm folded into the plain ``weight``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, stride=self.stride[0],
                      padding=self.padding[0], dilation=self.dilation[0],
                      groups=self.groups)


class WNConvTranspose1d(nn.ConvTranspose1d):
    """Folded weight-norm transposed conv; weight [Cin, Cout/g, K]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d(x, self.weight, self.bias, stride=self.stride[0],
                                padding=self.padding[0],
                                output_padding=self.output_padding[0],
                                dilation=self.dilation[0], groups=self.groups)


class Snake1d(nn.Module):
    """Learnable periodic activation; ``alpha`` is stored [1, C, 1]."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha)


class Tanh(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x)


def run_layers(layers, x: torch.Tensor, generator: torch.Generator | None = None
               ) -> torch.Tensor:
    """Run ``layers`` in order, passing the noise generator to those that
    take one (``takes_generator``). The codecs' chunked stages run index
    ranges of their containers through it."""
    for layer in layers:
        x = layer(x, generator) if getattr(layer, "takes_generator", False) else layer(x)
    return x


class Sequential(nn.Sequential):
    """nn.Sequential that passes the noise generator to the children that
    take one (``takes_generator``)."""

    takes_generator = True

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return run_layers(self, x, generator)


class ResidualUnit(nn.Module):
    """Snake → dilated conv k7 → Snake → 1×1 conv, plus the residual.

    On CUDA both forms run a fused residual-unit kernel: the depthwise one
    (groups = C, every SNAC preset) or the dense one (groups = 1, DAC)."""

    def __init__(self, dim: int, *, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.dilation = dilation
        pad = (KERNEL - 1) * dilation // 2
        self.block = nn.Sequential(
            Snake1d(dim),
            WNConv1d(dim, dim, KERNEL, padding=pad, dilation=dilation, groups=groups),
            Snake1d(dim),
            WNConv1d(dim, dim, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s1, c1, s2, c2 = self.block
        return fused_residual_unit(x, s1.alpha, c1.weight, c1.bias, s2.alpha, c2.weight,
                                   c2.bias, dilation=self.dilation)


class NoiseBlock(nn.Module):
    """x + randn·(1×1 conv)(x) decoder noise injection. With no generator it
    is the identity (noise-free eval, E[noise] = 0)."""

    takes_generator = True

    def __init__(self, dim: int):
        super().__init__()
        self.linear = WNConv1d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if generator is None:
            return x
        b, _, t = x.shape
        noise = torch.randn((b, 1, t), generator=generator, device=x.device, dtype=x.dtype)
        return x + noise * self.linear(x)


class LocalMHA(nn.Module):
    """Windowed attention block: LayerNorm, bias-free qkv/out projections."""

    def __init__(self, dim: int, *, window_size: int = 32, dim_head: int = 64,
                 use_rope: bool = True):
        super().__init__()
        self.window_size = window_size
        self.num_heads = dim // dim_head
        self.use_rope = use_rope
        self.norm = nn.LayerNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return local_mha(x, norm_scale=self.norm.weight, norm_bias=self.norm.bias,
                         qkv_weight=self.to_qkv.weight, out_weight=self.to_out.weight,
                         window_size=self.window_size, num_heads=self.num_heads,
                         use_rope=self.use_rope)
