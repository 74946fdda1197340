"""SNAC configuration + the three published presets.

Copy of neuralcodecs_tpu.models.snac.config.SNACConfig. Field names match
the upstream config.json keys.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import reduce

from neuralcodecs_tpu_torch.core.config import ModelConfig


@dataclass
class SNACConfig(ModelConfig):
    sampling_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: list[int] = field(default_factory=lambda: [2, 3, 8, 8])
    latent_dim: int | None = None
    decoder_dim: int = 1536
    decoder_rates: list[int] = field(default_factory=lambda: [8, 8, 3, 2])
    attn_window_size: int | None = 32
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: list[int] = field(default_factory=lambda: [8, 4, 2, 1])
    noise: bool = True
    depthwise: bool = True

    def __post_init__(self) -> None:
        self.architecture = self.architecture or "snac"

    @property
    def sample_rate(self) -> int:
        return self.sampling_rate

    @property
    def resolved_latent_dim(self) -> int:
        return self.latent_dim or self.encoder_dim * (1 << len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        return reduce(lambda a, b: a * b, self.encoder_rates)

    @property
    def pad_to(self) -> int:
        # hop * lcm(vq_strides[0], attn_window or 1)
        lcm = math.lcm(self.vq_strides[0], self.attn_window_size or 1)
        return self.hop_length * lcm

    @classmethod
    def snac_44khz(cls) -> "SNACConfig":
        return cls()

    @classmethod
    def snac_32khz(cls) -> "SNACConfig":
        return cls(sampling_rate=32000)

    @classmethod
    def snac_24khz(cls) -> "SNACConfig":
        return cls(
            sampling_rate=24000,
            encoder_dim=48,
            encoder_rates=[2, 4, 8, 8],
            decoder_dim=1024,
            decoder_rates=[8, 8, 4, 2],
            attn_window_size=None,
            vq_strides=[4, 2, 1],
        )
