"""Device time by op from a Chrome trace of ``diagnostics.profiler.trace``.

Counterpart of neuralcodecs_tpu.diagnostics.xplane, which reads the XSpace
protobufs of ``jax.profiler``. ``torch.profiler`` writes Chrome traces
(JSON: ``traceEvents``, complete events with a category, a name and a
duration in µs), so the reader here is the standard library's ``json``:
it sums each op's event durations over the categories asked for, by
default the device's (kernels, memcpys, memsets, as CUPTI records them,
the nodes of a replayed CUDA graph included). Enough for the question that
drives kernel work: which op takes the device's time.

Usage:
    from neuralcodecs_tpu_torch.diagnostics.profiler import trace
    from neuralcodecs_tpu_torch.diagnostics.xplane import summarize_trace
    with trace("prof"):
        model(audio)
    for name, ms in summarize_trace("prof")[:20]:
        print(f"{ms:8.3f} ms  {name}")
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

# the categories of the device's events in torch.profiler's Chrome traces
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_trace(path: str | Path, categories=DEVICE_CATEGORIES) -> dict[str, int]:
    """Total duration (ns) by event name of a Chrome trace's complete
    events whose category is one of ``categories`` (case-insensitive)."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    wanted = {c.lower() for c in categories}
    totals: collections.Counter = collections.Counter()
    for event in events:
        if event.get("ph") != "X" or str(event.get("cat", "")).lower() not in wanted:
            continue
        totals[event.get("name", "?")] += int(round(float(event.get("dur", 0)) * 1e3))
    return dict(totals)


def newest_trace(log_dir: str | Path) -> Path:
    """The newest ``*.json`` trace under ``log_dir``."""
    traces = sorted(Path(log_dir).rglob("*.json"), key=lambda p: p.stat().st_mtime)
    if not traces:
        raise FileNotFoundError(f"No .json trace under {log_dir}")
    return traces[-1]


def summarize_trace(log_dir: str | Path,
                    categories=DEVICE_CATEGORIES) -> list[tuple[str, float]]:
    """[(op, total ms)] of the newest trace under ``log_dir``, longest
    first."""
    totals = parse_trace(newest_trace(log_dir), categories)
    return sorted(((name, ns / 1e6) for name, ns in totals.items()), key=lambda kv: -kv[1])
