"""Live structured diagnostics events (ETW analog).

Copy of neuralcodecs_tpu.diagnostics.eventsource, which imports no JAX but
sits in a package that does. The reference's CodecEventSource.cs raises
three ETW event kinds (ModuleExecution, TensorStats, AnomalyDetected) as
they happen; ETW is Windows-only, so these are emitted as JSON lines to any
number of sinks (callables and/or an append-only .jsonl file) the moment
they occur: consumable by `tail -f`, a log shipper, or an in-process
subscriber.

Disabled by default (zero work per event when no sink is attached).
"""

from __future__ import annotations

import io
import json
import threading
import time
from pathlib import Path
from typing import Callable

Event = dict


class CodecEventSource:
    """Singleton-style live event hub (CodecEventSource.cs:8-24)."""

    def __init__(self) -> None:
        self._sinks: list[Callable[[Event], None]] = []
        self._file: io.TextIOBase | None = None
        self._lock = threading.Lock()

    # -- sink management -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self._sinks) or self._file is not None

    def subscribe(self, sink: Callable[[Event], None]) -> None:
        self._sinks.append(sink)

    def unsubscribe(self, sink: Callable[[Event], None]) -> None:
        self._sinks = [s for s in self._sinks if s is not sink]

    def open_jsonl(self, path: str | Path) -> None:
        """Append events to a JSON-lines file."""
        self.close()
        self._file = open(path, "a", encoding="utf-8")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def _emit(self, event: Event) -> None:
        event["ts"] = time.time()
        for sink in self._sinks:
            sink(event)
        if self._file is not None:
            with self._lock:
                self._file.write(json.dumps(event) + "\n")
                self._file.flush()

    # -- the three ETW event kinds (CodecEventSource.cs:12-22) -----------------

    def module_execution(self, module_name: str, execution_time_ms: float,
                         memory_bytes: int = 0) -> None:
        if not self.enabled:
            return
        self._emit({"event": "ModuleExecution", "module": module_name,
                    "ms": execution_time_ms, "memory_bytes": memory_bytes})

    def tensor_stats(self, module_name: str, tensor_name: str,
                     min_value: float, max_value: float, shape: str) -> None:
        if not self.enabled:
            return
        self._emit({"event": "TensorStats", "module": module_name,
                    "tensor": tensor_name, "min": min_value,
                    "max": max_value, "shape": shape})

    def anomaly_detected(self, module_name: str, description: str) -> None:
        if not self.enabled:
            return
        self._emit({"event": "AnomalyDetected", "module": module_name,
                    "description": description})


#: process-wide instance, mirroring CodecEventSource.Log
log = CodecEventSource()
