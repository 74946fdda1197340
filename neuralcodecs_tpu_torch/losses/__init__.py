"""Audio training losses: multi-scale mel, SI-SDR, L1, GAN (counterpart of
neuralcodecs_tpu.losses)."""

from neuralcodecs_tpu_torch.losses.audio import (
    l1_loss,
    mel_spectrogram_loss,
    multi_scale_stft_loss,
    sisdr_loss,
)
from neuralcodecs_tpu_torch.losses.gan import (
    discriminator_loss,
    feature_matching_loss,
    generator_loss,
)

__all__ = [
    "l1_loss",
    "mel_spectrogram_loss",
    "multi_scale_stft_loss",
    "sisdr_loss",
    "discriminator_loss",
    "generator_loss",
    "feature_matching_loss",
]
