"""1-D convolutions with torch semantics and torch weight layouts.

Counterpart of neuralcodecs_tpu.ops.conv. Activations are [B, C, T];
Conv1d weights [Cout, Cin/g, K]; ConvTranspose1d weights [Cin, Cout/g, K].
The JAX package's TPU formulations of the transposed conv (zero stuffing,
polyphase regrouping) are not ported: cuDNN runs the transposed conv as is.
Weight norm is folded at import (core/weights.fold_weight_norm).

Precision follows the input, as in the JAX package: the weight is cast to
``x.dtype`` and the conv runs in that dtype. A bias of another dtype (the
f32 parameter under a bf16 input) is added after the conv, so the output
promotes as ``out + bias`` does in jnp: bf16 + f32 gives f32, and the layers
after the first biased conv of a bf16 stage run in f32. Where the bias has
the input's dtype it goes into the conv call, as before.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           *, stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """[B, Cin, T] -> [B, Cout, T']; symmetric zero padding of ``padding``."""
    weight = weight.to(x.dtype)
    if bias is None or bias.dtype == x.dtype:
        return F.conv1d(x, weight, bias, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)
    return F.conv1d(x, weight, None, stride=stride, padding=padding, dilation=dilation,
                    groups=groups) + bias[:, None]


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, *, stride: int = 1,
                     padding: int = 0, output_padding: int = 0, dilation: int = 1,
                     groups: int = 1) -> torch.Tensor:
    """[B, Cin, T] -> [B, Cout, T'] with
    T' = (T-1)·stride − 2·padding + dilation·(K−1) + output_padding + 1."""
    weight = weight.to(x.dtype)
    kw = dict(stride=stride, padding=padding, output_padding=output_padding, groups=groups,
              dilation=dilation)
    if bias is None or bias.dtype == x.dtype:
        return F.conv_transpose1d(x, weight, bias, **kw)
    return F.conv_transpose1d(x, weight, None, **kw) + bias[:, None]


# ---------------------------------------------------------------------------
# Initializers of torch's Conv1d defaults (kaiming uniform, a = sqrt(5)), as
# the JAX package draws them; torch's own nn.Conv1d init draws from the same
# distributions, which is what the port's models use
# ---------------------------------------------------------------------------


def _uniform(generator: torch.Generator | None, shape: tuple[int, ...], bound: float,
             dtype: torch.dtype) -> torch.Tensor:
    device = generator.device if generator is not None else None
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return (2.0 * u - 1.0) * bound


def kaiming_uniform_conv_init(generator: torch.Generator | None, k: int, cin_g: int,
                              cout: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A Conv1d weight [cout, cin_g, k] from U(-b, b), b = gain · sqrt(3 /
    fan_in), gain = sqrt(2 / (1 + 5)), fan_in = cin_g · k."""
    fan_in = cin_g * k
    bound = math.sqrt(2.0 / (1.0 + 5.0)) * math.sqrt(3.0 / fan_in)
    return _uniform(generator, (cout, cin_g, k), bound, dtype)


def conv_bias_init(generator: torch.Generator | None, fan_in: int, cout: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A bias [cout] from U(-1/sqrt(fan_in), 1/sqrt(fan_in)); zeros at fan_in 0."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(generator, (cout,), bound, dtype)
