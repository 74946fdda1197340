"""neuralcodecs_tpu_torch — the PyTorch/CUDA port of neuralcodecs_tpu.

A second package beside the JAX one, mirroring its layout module by module.
It imports ``torch`` and never ``jax``. The codebook search, the residual
unit, the LSTM recurrence, the envelope follower and the biquad run as
hand-written CUDA kernels on a CUDA device (``ops/kernels``); on the CPU the
same wrappers run their plain PyTorch versions. Models and AudioSignal
arrays go to "cuda" unless the caller names a device (``device="cpu"``).

Ported so far: the SNAC round trip (pad → encoder → multi-scale RVQ →
decoder → trim), the Encodec round trip (chunking, SEANet with SLSTM,
RVQ, overlap-add) with the raw and LM-coded .ecdc container (the Encodec
language model and a C++ range coder built with g++) and streaming
sessions, the AudioTools DSP
library (``dsp``: resampling, STFT and mel, BS.1770 loudness, effects,
AudioSignal), the DAC round trip with the .dac container, and Dia 1.6B
text-to-speech (the CFG decode loop with its int8 KV cache and blocked
read, streaming generation, and the DAC vocoder bridge), and the loader:

    import neuralcodecs_tpu_torch as nc
    model = nc.load_snac("hubertsiuzdak/snac_24khz")   # or a local path
    nc.save_pretrained(model, "snac_export")           # the JAX package's format
    audio_hat = model.process_audio(audio, sample_rate=24000)

Importing the package turns TF32 off for cuDNN and cuBLAS (both flags of
``ops.precision``): one TF32 pass keeps about three digits and flips
near-tie RVQ codes, where the JAX package's f32 path runs its contractions
at ``Precision.HIGH``.
"""

from neuralcodecs_tpu_torch.ops.precision import disable_tf32

disable_tf32()

from neuralcodecs_tpu_torch.core.export import load_pretrained, save_pretrained  # noqa: E402
from neuralcodecs_tpu_torch.core.loader import (  # noqa: E402
    ModelLoader,
    load_dac,
    load_dia,
    load_encodec,
    load_model,
    load_snac,
)
from neuralcodecs_tpu_torch.core.registry import ModelRegistry, registry  # noqa: E402
from neuralcodecs_tpu_torch.core.zoo import load_zoo_model, zoo_models  # noqa: E402
from neuralcodecs_tpu_torch.dsp import AudioSignal  # noqa: E402
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig  # noqa: E402
from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig  # noqa: E402
from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig  # noqa: E402
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig  # noqa: E402

__all__ = [
    "ModelRegistry",
    "registry",
    "ModelLoader",
    "load_model",
    "load_snac",
    "load_dac",
    "load_encodec",
    "load_dia",
    "SNAC",
    "SNACConfig",
    "DAC",
    "DACConfig",
    "Encodec",
    "EncodecConfig",
    "Dia",
    "DiaConfig",
    "load_pretrained",
    "save_pretrained",
    "load_zoo_model",
    "zoo_models",
    "AudioSignal",
]
