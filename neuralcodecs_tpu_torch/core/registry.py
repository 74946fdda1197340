"""Model registry: architecture name -> (model factory, config class)
(copy of neuralcodecs_tpu.core.registry).

A plain dict keyed by architecture string; each model module registers
itself at import. A factory takes ``(config, *, device=None, seed=0)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from neuralcodecs_tpu_torch.core.exceptions import ConfigurationError


@dataclass(frozen=True)
class RegistryEntry:
    architecture: str
    factory: Callable[..., Any]  # factory(config, *, device=None, seed=0) -> model
    config_cls: type


class ModelRegistry:
    """Maps architecture identifiers to model factories and config classes."""

    def __init__(self) -> None:
        self._entries: dict[str, RegistryEntry] = {}

    def register(
        self,
        architecture: str,
        factory: Callable[..., Any],
        config_cls: type,
    ) -> None:
        self._entries[architecture.lower()] = RegistryEntry(
            architecture.lower(), factory, config_cls
        )

    def get(self, architecture: str) -> RegistryEntry:
        entry = self._entries.get(architecture.lower())
        if entry is None:
            raise ConfigurationError(
                f"No model registered for architecture '{architecture}'. "
                f"Known: {sorted(self._entries)}"
            )
        return entry

    def create(self, architecture: str, config: Any, **kwargs: Any) -> Any:
        return self.get(architecture).factory(config, **kwargs)

    def architectures(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, architecture: str) -> bool:
        return architecture.lower() in self._entries


#: Global registry instance. Models register themselves on import.
registry = ModelRegistry()
