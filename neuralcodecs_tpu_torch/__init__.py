"""neuralcodecs_tpu_torch — the PyTorch/CUDA port of neuralcodecs_tpu.

A second package beside the JAX one, mirroring its layout module by module.
It imports ``torch`` and never ``jax``. The codebook search, the residual
unit, the LSTM recurrence, the envelope follower and the biquad run as
hand-written CUDA kernels on a CUDA device (``ops/kernels``); on the CPU the
same wrappers run their plain PyTorch versions.

Ported so far: the SNAC round trip (pad → encoder → multi-scale RVQ →
decoder → trim), the Encodec round trip (chunking, SEANet with SLSTM,
RVQ, overlap-add) with the raw .ecdc container, and the AudioTools DSP
library (``dsp``: resampling, STFT and mel, BS.1770 loudness, effects,
AudioSignal).
"""

from neuralcodecs_tpu_torch.dsp import AudioSignal
from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

__all__ = ["AudioSignal", "Encodec", "EncodecConfig", "SNAC", "SNACConfig"]
