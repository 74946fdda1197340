"""Encodec configuration + the 24 kHz / 48 kHz presets.

Copy of neuralcodecs_tpu.models.encodec.config.EncodecConfig (the JAX
package cannot be imported without JAX). Field names follow the HF
transformers config.json keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce

from neuralcodecs_tpu_torch.core.config import ModelConfig


@dataclass
class EncodecConfig(ModelConfig):
    sampling_rate: int = 24000
    channels: int = 1
    bandwidth: float | None = 6.0
    target_bandwidths: list[float] = field(
        default_factory=lambda: [1.5, 3.0, 6.0, 12.0, 24.0])
    chunk_length_s: float | None = None
    overlap: float | None = None
    codebook_size: int = 1024
    codebook_dim: int = 128
    hidden_size: int = 128
    compress: int = 2
    dilation_growth_rate: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    num_filters: int = 32
    num_lstm_layers: int = 2
    num_residual_layers: int = 1
    norm_type: str = "weight_norm"
    normalize: bool = False
    pad_mode: str = "reflect"
    trim_right_ratio: float = 1.0
    upsampling_ratios: list[int] = field(default_factory=lambda: [8, 5, 4, 2])
    use_causal_conv: bool = True
    model_type: str = "encodec"

    def __post_init__(self) -> None:
        self.architecture = self.architecture or "encodec"

    @property
    def sample_rate(self) -> int:
        return self.sampling_rate

    @property
    def hop_length(self) -> int:
        return reduce(lambda a, b: a * b, self.upsampling_ratios)

    @property
    def frame_rate(self) -> float:
        return self.sampling_rate / self.hop_length

    @property
    def chunk_length(self) -> int | None:
        if self.chunk_length_s is None:
            return None
        return int(self.chunk_length_s * self.sampling_rate)

    @property
    def chunk_stride(self) -> int | None:
        if self.chunk_length is None:
            return None
        return max(1, int((1.0 - (self.overlap or 0.0)) * self.chunk_length))

    @classmethod
    def encodec_24khz(cls) -> "EncodecConfig":
        return cls()

    @classmethod
    def encodec_48khz(cls) -> "EncodecConfig":
        return cls(
            sampling_rate=48000,
            channels=2,
            chunk_length_s=1.0,
            overlap=0.01,
            norm_type="time_group_norm",
            normalize=True,
            target_bandwidths=[3.0, 6.0, 12.0, 24.0],
            use_causal_conv=False,
        )
