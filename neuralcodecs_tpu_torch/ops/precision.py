"""Float32 precision policy of the port.

cuDNN runs float32 convolutions in TF32 by default (about three decimal
digits), which flips near-tie RVQ codes. The JAX package's f32 path runs its
contractions at Precision.HIGH, which measured bit-identical codes against
HIGHEST (neuralcodecs_tpu/ops/conv.py). The port's f32 path therefore runs
with TF32 off, for convolutions and matrix products alike.
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
