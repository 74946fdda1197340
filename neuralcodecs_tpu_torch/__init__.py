"""neuralcodecs_tpu_torch — the PyTorch/CUDA port of neuralcodecs_tpu.

A second package beside the JAX one, mirroring its layout module by module.
It imports ``torch`` and never ``jax``. The codebook search and the
residual unit run as hand-written CUDA kernels on a CUDA device
(``ops/kernels``); on the CPU the same wrappers run their plain PyTorch
versions.

First slice: the SNAC codec round trip (pad → encoder → multi-scale RVQ →
decoder → trim).
"""

from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

__all__ = ["SNAC", "SNACConfig"]
