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

Importing the package turns TF32 off for cuDNN and cuBLAS (both flags of
``ops.precision``): one TF32 pass keeps about three digits and flips
near-tie RVQ codes, where the JAX package's f32 path runs its contractions
at ``Precision.HIGH``.
"""

from neuralcodecs_tpu_torch.ops.precision import disable_tf32

disable_tf32()

from neuralcodecs_tpu_torch.dsp import AudioSignal  # noqa: E402
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

__all__ = ["AudioSignal", "DAC", "DACConfig", "Encodec", "EncodecConfig", "SNAC",
           "SNACConfig"]
