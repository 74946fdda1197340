"""Model configuration base (copy of neuralcodecs_tpu.core.config).

JSON (de)serialization is case-insensitive on key names and tolerant of
unknown keys, so upstream HF ``config.json`` files load unchanged; the .dac
container serialises a config through ``to_dict``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, TypeVar

from neuralcodecs_tpu_torch.core.exceptions import ConfigurationError

T = TypeVar("T", bound="ModelConfig")


def _normalize_key(key: str) -> str:
    return key.replace("-", "_").lower()


@dataclass
class ModelConfig:
    """Base class for model configurations.

    Subclasses are plain dataclasses whose field names match the snake_case
    JSON property names used by upstream config.json files.
    """

    architecture: str = field(default="", metadata={"json_ignore": True})
    version: str = field(default="", metadata={"json_ignore": True})
    metadata: dict[str, str] = field(default_factory=dict, metadata={"json_ignore": True})

    @classmethod
    def from_dict(cls: type[T], data: dict[str, Any]) -> T:
        """Build a config from a dict, case-insensitively, ignoring unknowns."""
        known = {_normalize_key(f.name): f.name for f in fields(cls) if f.init}
        kwargs: dict[str, Any] = {}
        for key, value in data.items():
            name = known.get(_normalize_key(key))
            if name is not None:
                kwargs[name] = value
        return cls(**kwargs)

    @classmethod
    def from_json(cls: type[T], path: str | Path) -> T:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ConfigurationError(f"Config file {path} is not a JSON object")
        return cls.from_dict(data)

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for f in fields(self):
            if f.metadata.get("json_ignore"):
                continue
            out[f.name] = getattr(self, f.name)
        return out

    def to_json(self, path: str | Path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)

    def replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)


def _json_default(obj: Any):
    if isinstance(obj, (tuple, set)):
        return list(obj)
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    raise TypeError(f"Cannot serialize {type(obj)!r}")
