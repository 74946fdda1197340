"""Progress / error callback plumbing (copy of neuralcodecs_tpu.core.events).

The loader's events as plain callback lists: load progress by stage and
load errors, fatal or not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class LoadProgress:
    source: str
    stage: str           # "download" | "cache" | "weights" | "validate"
    fraction: float      # 0..1, may be nan when size unknown
    message: str = ""


@dataclass(frozen=True)
class LoadErrorEvent:
    source: str
    error: Exception
    fatal: bool


class EventEmitter:
    """Minimal multi-listener callback hub used by the loader and repos."""

    def __init__(self) -> None:
        self._progress: list[Callable[[LoadProgress], None]] = []
        self._errors: list[Callable[[LoadErrorEvent], None]] = []

    def on_progress(self, cb: Callable[[LoadProgress], None]) -> None:
        self._progress.append(cb)

    def on_error(self, cb: Callable[[LoadErrorEvent], None]) -> None:
        self._errors.append(cb)

    def emit_progress(self, event: LoadProgress) -> None:
        for cb in self._progress:
            cb(event)

    def emit_error(self, event: LoadErrorEvent) -> None:
        for cb in self._errors:
            cb(event)
