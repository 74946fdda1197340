"""The AudioTools DSP layer (counterpart of neuralcodecs_tpu.dsp): STFT, mel
and MFCC, resampling, BS.1770 loudness, filters and effects, PCM helpers
and the AudioSignal container, over torch tensors on any device.
"""

from neuralcodecs_tpu_torch.dsp.signal import AudioInfo, AudioSignal

__all__ = ["AudioInfo", "AudioSignal"]
