"""neuralcodecs_tpu_torch — the PyTorch/CUDA port of neuralcodecs_tpu.

A second package beside the JAX one, mirroring its layout module by module.
It imports ``torch`` and never ``jax``. The codebook search, the residual
unit, the LSTM recurrence, the envelope follower and the biquad run as
hand-written CUDA kernels on a CUDA device (``ops/kernels``); on the CPU the
same wrappers run their plain PyTorch versions. Models and AudioSignal
arrays go to "cuda" unless the caller names a device (``device="cpu"``).

Ported so far: the SNAC round trip (pad → encoder → multi-scale RVQ →
decoder → trim), the Encodec round trip (chunking, SEANet with SLSTM,
RVQ, overlap-add) with the raw .ecdc container, the AudioTools DSP
library (``dsp``: resampling, STFT and mel, BS.1770 loudness, effects,
AudioSignal), and the DAC round trip with the .dac container.
"""

from neuralcodecs_tpu_torch.dsp import AudioSignal
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

__all__ = ["AudioSignal", "DAC", "DACConfig", "Encodec", "EncodecConfig", "SNAC",
           "SNACConfig"]
