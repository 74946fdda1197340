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
