"""Dia TTS configuration tree.

Copy of neuralcodecs_tpu.models.dia.config: DiaDataConfig (delay pattern,
pad/bos/eos tokens, 9 audio channels), DiaEncoderConfig / DiaDecoderConfig
(widths, GQA heads) and the generation and slowdown parameters, with
``from_dict`` reading upstream's nested ``model`` section.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from neuralcodecs_tpu_torch.core.config import ModelConfig


@dataclass
class DiaDataConfig:
    text_length: int = 1024
    audio_length: int = 3072
    channels: int = 9
    text_pad_value: int = 0
    audio_eos_value: int = 1024
    audio_pad_value: int = 1025
    audio_bos_value: int = 1026
    delay_pattern: list[int] = field(
        default_factory=lambda: [0, 8, 9, 10, 11, 12, 13, 14, 15])


@dataclass
class DiaEncoderConfig:
    n_layer: int = 12
    n_embd: int = 1024
    n_hidden: int = 4096
    n_head: int = 16
    head_dim: int = 128


@dataclass
class DiaDecoderConfig:
    n_layer: int = 18
    n_embd: int = 2048
    n_hidden: int = 8192
    gqa_query_heads: int = 16
    kv_heads: int = 4
    gqa_head_dim: int = 128
    cross_query_heads: int = 16
    cross_head_dim: int = 128


@dataclass
class DiaConfig(ModelConfig):
    vocab_size: int = 256          # byte-level text vocab
    tgt_vocab_size: int = 1028     # audio codes + eos/pad/bos
    dropout: float = 0.0
    normalization_layer_epsilon: float = 1e-5
    rope_min_timescale: int = 1
    rope_max_timescale: int = 10000
    data: DiaDataConfig = field(default_factory=DiaDataConfig)
    encoder: DiaEncoderConfig = field(default_factory=DiaEncoderConfig)
    decoder: DiaDecoderConfig = field(default_factory=DiaDecoderConfig)
    # generation defaults
    cfg_scale: float = 3.0
    temperature: float = 1.2
    top_p: float = 0.95
    top_k: int = 45
    sample_rate: int = 44100
    # audio speed correction
    slowdown_mode: str = "dynamic"          # "dynamic" | "static"
    static_slowdown_factor: float = 0.95
    dynamic_slowdown_start_length: float = 400.0
    dynamic_slowdown_max_length: float = 750.0
    dynamic_slowdown_max_percent: float = 0.20

    def __post_init__(self) -> None:
        self.architecture = self.architecture or "dia"
        if isinstance(self.data, dict):
            self.data = DiaDataConfig(**self.data)
        if isinstance(self.encoder, dict):
            self.encoder = DiaEncoderConfig(**self.encoder)
        if isinstance(self.decoder, dict):
            self.decoder = DiaDecoderConfig(**self.decoder)

    @classmethod
    def from_dict(cls, data: dict) -> "DiaConfig":
        # Dia's upstream config.json nests model/data sections
        if "model" in data and isinstance(data["model"], dict):
            model = data["model"]
            merged = {**data, **{k: v for k, v in model.items()
                                 if k in ("encoder", "decoder", "dropout")}}
            merged.pop("model", None)
            data = merged
        return super().from_dict(data)
