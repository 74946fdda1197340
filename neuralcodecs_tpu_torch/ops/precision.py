"""Float32 and bfloat16 precision policy of the port.

cuDNN runs float32 convolutions in TF32 by default (about three decimal
digits), which flips near-tie RVQ codes. The JAX package's f32 path runs its
contractions at Precision.HIGH, which measured bit-identical codes against
HIGHEST (neuralcodecs_tpu/ops/conv.py). The port's f32 path therefore runs
with TF32 off, for convolutions and matrix products alike.

cuBLAS may also reduce bfloat16 products in reduced precision (split-K
partial sums kept in bf16), which torch allows by default. The JAX
package's bf16 products accumulate in f32, so the port turns that off too:
a bf16 product is rounded once, at its output.
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32_disabled() -> bool:
    return (not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32)


def disable_bf16_reduced_reduction() -> None:
    """Make cuBLAS reduce bfloat16 products in f32."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def bf16_reduced_reduction_disabled() -> bool:
    return not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
