"""DAC configuration + presets.

Copy of neuralcodecs_tpu.models.dac.config.DACConfig. Field names and their
order are the JAX package's, so ``to_dict`` (and the .dac container built
on it) writes the same JSON.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce

from neuralcodecs_tpu_torch.core.config import ModelConfig


@dataclass
class DACConfig(ModelConfig):
    model_bitrate: str = "8kbps"
    model_type: str = "44khz"
    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: list[int] = field(default_factory=lambda: [2, 4, 8, 8])
    decoder_dim: int = 1536
    decoder_rates: list[int] = field(default_factory=lambda: [8, 8, 4, 2])
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    quantizer_dropout: float = 0.0
    latent_dim: int | None = None
    commitment_loss_weight: float = 0.25
    codebook_loss_weight: float = 1.0
    chunk_seconds: int = 10

    def __post_init__(self) -> None:
        self.architecture = self.architecture or "dac"

    @property
    def resolved_latent_dim(self) -> int:
        return self.latent_dim or self.encoder_dim * (1 << len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        return reduce(lambda a, b: a * b, self.encoder_rates)

    @classmethod
    def dac_44khz(cls) -> "DACConfig":
        return cls()

    @classmethod
    def dac_44khz_16kbps(cls) -> "DACConfig":
        return cls(model_bitrate="16kbps", n_codebooks=18, latent_dim=128)

    @classmethod
    def dac_24khz(cls) -> "DACConfig":
        return cls(model_type="24khz", sample_rate=24000, n_codebooks=32,
                   encoder_rates=[2, 4, 5, 8], decoder_rates=[8, 5, 4, 2])

    @classmethod
    def dac_16khz(cls) -> "DACConfig":
        return cls(model_type="16khz", sample_rate=16000, n_codebooks=12,
                   encoder_rates=[2, 4, 5, 8], decoder_rates=[8, 5, 4, 2])
