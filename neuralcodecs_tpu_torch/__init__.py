"""neuralcodecs_tpu_torch — the PyTorch/CUDA port of neuralcodecs_tpu.

A second package beside the JAX one, mirroring its layout module by module.
It imports ``torch`` and never ``jax``. The codebook search, the residual
unit and the LSTM recurrence run as hand-written CUDA kernels on a CUDA
device (``ops/kernels``); on the CPU the same wrappers run their plain
PyTorch versions.

Ported so far: the SNAC round trip (pad → encoder → multi-scale RVQ →
decoder → trim) and the Encodec round trip (chunking, SEANet with SLSTM,
RVQ, overlap-add) with the raw .ecdc container.
"""

from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

__all__ = ["Encodec", "EncodecConfig", "SNAC", "SNACConfig"]
