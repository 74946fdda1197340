"""Model configuration base (counterpart of neuralcodecs_tpu.core.config).

Only what the ported configs use: the ``architecture`` tag.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Base class for model configurations (plain dataclasses)."""

    architecture: str = ""
