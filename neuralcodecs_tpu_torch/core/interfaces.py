"""Public codec protocol (counterpart of neuralcodecs_tpu.core.interfaces).

Every codec of the port is an ``nn.Module`` with a config, torch's
``state_dict`` / ``load_state_dict`` and an audio round trip. The JAX
protocol's ``params`` dict has no counterpart: the module holds its
weights.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class NeuralCodec(Protocol):
    """Structural type every codec model implements."""

    config: Any

    def state_dict(self, *args: Any, **kwargs: Any) -> dict[str, Any]:
        """The module's tensors by name."""
        ...

    def load_state_dict(self, state_dict: dict[str, Any], *args: Any, **kwargs: Any) -> Any:
        """Load tensors by name into the module."""
        ...

    def process_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Resample-if-needed encode+decode round trip."""
        ...
