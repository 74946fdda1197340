"""Opt-in diagnostics context: per-module tensor stats, timing, dumps.

Counterpart of neuralcodecs_tpu.diagnostics.context (the reference's
DiagnosticsContext.cs): min/max/mean/NaN/Inf stats per module, wall-clock
execution scopes, z-score anomaly detection (:347), binary tensor dumps +
cross-implementation comparison (TensorComparison.cs:34-82), and a
null-object default so the hot path pays nothing when disabled.

A logged tensor (torch on any device, or numpy) is copied to the host as
f32 and its stats computed there with numpy, so they equal the JAX
package's on the same values. A timing scope ends on a synchronisation of
the CUDA device when one is in use: eager CUDA returns at enqueue, and the
scope's time is to cover the device work begun inside it, as a host read
inside a scope does in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np
import torch

from neuralcodecs_tpu_torch.diagnostics.eventsource import log as event_log


def _host(tensor) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array, dtype kept
    (bf16, which numpy lacks, widened to f32)."""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().cpu()
        return (tensor.float() if tensor.dtype == torch.bfloat16 else tensor).numpy()
    return np.asarray(tensor)


@dataclass
class TensorStats:
    name: str
    shape: tuple[int, ...]
    min: float
    max: float
    mean: float
    std: float
    nan_count: int
    inf_count: int

    @property
    def has_anomaly(self) -> bool:
        return self.nan_count > 0 or self.inf_count > 0


@dataclass
class ModuleStats:
    """Execution telemetry per module (ModuleStats.cs:7-16)."""

    name: str
    calls: int = 0
    total_seconds: float = 0.0
    tensor_stats: list[TensorStats] = field(default_factory=list)


class DiagnosticsContext:
    """Collects stats/timings; explicit calls, no global hooks."""

    def __init__(self, dump_dir: str | Path | None = None,
                 anomaly_z_threshold: float = 6.0):
        self.modules: dict[str, ModuleStats] = {}
        self.anomalies: list[str] = []
        self.dump_dir = Path(dump_dir) if dump_dir else None
        self.anomaly_z_threshold = anomaly_z_threshold
        self.enabled = True

    # ----------------------------------------------------------------- stats

    def log_tensor(self, module: str, name: str, tensor) -> TensorStats | None:
        if not self.enabled:
            return None
        arr = _host(tensor).astype(np.float32, copy=False)
        stats = TensorStats(
            name=name,
            shape=tuple(arr.shape),
            min=float(np.nanmin(arr)) if arr.size else 0.0,
            max=float(np.nanmax(arr)) if arr.size else 0.0,
            mean=float(np.nanmean(arr)) if arr.size else 0.0,
            std=float(np.nanstd(arr)) if arr.size else 0.0,
            nan_count=int(np.isnan(arr).sum()),
            inf_count=int(np.isinf(arr).sum()),
        )
        entry = self.modules.setdefault(module, ModuleStats(module))
        entry.tensor_stats.append(stats)
        event_log.tensor_stats(module, name, stats.min, stats.max,
                               str(stats.shape))
        if stats.has_anomaly:
            desc = f"{module}.{name}: {stats.nan_count} NaN / {stats.inf_count} Inf"
            self.anomalies.append(desc)
            event_log.anomaly_detected(module, desc)
        elif stats.std > 0:
            z = max(abs(stats.max - stats.mean), abs(stats.min - stats.mean)) / stats.std
            if z > self.anomaly_z_threshold:
                desc = (f"{module}.{name}: outlier z={z:.1f} (range "
                        f"[{stats.min:.3g}, {stats.max:.3g}])")
                self.anomalies.append(desc)
                event_log.anomaly_detected(module, desc)
        if self.dump_dir is not None:
            self.dump_tensor(f"{module}.{name}", arr)
        return stats

    @contextlib.contextmanager
    def track_scope(self, module: str):
        """Wall-clock scope (DiagnosticsContext.TrackScope :270-298)."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            entry = self.modules.setdefault(module, ModuleStats(module))
            entry.calls += 1
            entry.total_seconds += elapsed
            event_log.module_execution(module, elapsed * 1e3)

    # ----------------------------------------------------------------- dumps

    def dump_tensor(self, name: str, tensor) -> Path:
        assert self.dump_dir is not None, "dump_dir not configured"
        self.dump_dir.mkdir(parents=True, exist_ok=True)
        path = self.dump_dir / f"{name.replace('/', '_')}.npy"
        np.save(path, _host(tensor))
        return path

    def generate_comparison_script(self, path: str | Path) -> Path:
        """Write a STANDALONE numpy-only script that compares this
        context's .npy dump directory against another implementation's
        dumps (counterpart of DiagnosticsContext.GenerateComparisonScript,
        the reference's DiagnosticsContext.cs:265
        + TensorLogger.cs:214 — there it emits Python that parses the C#
        binary tensor format; here both sides are .npy, so the generated
        script diffs two dump directories by matching file names)."""
        assert self.dump_dir is not None, "dump_dir not configured"
        path = Path(path)
        dump = str(self.dump_dir.resolve())
        script = f'''#!/usr/bin/env python
"""Auto-generated by neuralcodecs_tpu_torch DiagnosticsContext.

Compare the tensor dumps of this run against another implementation's:

    python {path.name} <other_dump_dir> [--rtol 1e-5] [--atol 1e-6]

Matches files by name ("<name>.npy" in both directories), prints per-
tensor stats, max/mean absolute difference and correlation, and exits
nonzero if any matched tensor exceeds tolerance.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

REFERENCE_DUMP_DIR = {dump!r}


def stats(x):
    x = np.asarray(x, np.float64)
    return f"min={{x.min():.6g}} max={{x.max():.6g}} mean={{x.mean():.6g}}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="dump dir of the other implementation")
    ap.add_argument("--mine", default=REFERENCE_DUMP_DIR)
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--atol", type=float, default=1e-6)
    args = ap.parse_args()
    mine, other = Path(args.mine), Path(args.other)
    names = sorted(p.name for p in mine.glob("*.npy"))
    if not names:
        print(f"no .npy dumps in {{mine}}", file=sys.stderr)
        return 2
    failures = 0
    for name in names:
        peer = other / name
        if not peer.exists():
            print(f"{{name}}: MISSING in {{other}}")
            failures += 1
            continue
        a, b = np.load(mine / name), np.load(peer)
        if a.shape != b.shape:
            print(f"{{name}}: shape {{a.shape}} vs {{b.shape}} MISMATCH")
            failures += 1
            continue
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        tol = args.atol + args.rtol * np.abs(b).astype(np.float64)
        bad = int((diff > tol).sum())
        corr = 1.0
        if a.size > 1 and a.std() > 0 and b.std() > 0:
            corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        verdict = "ok" if bad == 0 else f"FAIL ({{bad}}/{{a.size}} beyond tol)"
        print(f"{{name}}: {{verdict}} max_diff={{diff.max():.6g}} "
              f"mean_diff={{diff.mean():.6g}} corr={{corr:.6f}}")
        print(f"  mine:  {{stats(a)}}")
        print(f"  other: {{stats(b)}}")
        failures += bad > 0
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
'''
        path.write_text(script)
        return path

    # --------------------------------------------------------------- summary

    def summary(self) -> str:
        """Human-readable report (DiagnosticsContext summary :423-455)."""
        lines = ["=== Diagnostics summary ==="]
        for name, mod in sorted(self.modules.items()):
            avg = mod.total_seconds / mod.calls if mod.calls else 0.0
            lines.append(
                f"{name}: calls={mod.calls} total={mod.total_seconds * 1e3:.2f}ms "
                f"avg={avg * 1e3:.3f}ms tensors={len(mod.tensor_stats)}")
        if self.anomalies:
            lines.append("--- anomalies ---")
            lines.extend(self.anomalies)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {name: asdict(mod) for name, mod in self.modules.items()}, indent=2)


class NullDiagnosticsContext(DiagnosticsContext):
    """Disabled-by-default null object (NullDiagnosticsContext.cs:20)."""

    def __init__(self):
        super().__init__()
        self.enabled = False

    def log_tensor(self, module, name, tensor):  # noqa: D102
        return None

    @contextlib.contextmanager
    def track_scope(self, module):  # noqa: D102
        yield


def compare_tensors(a, b, name: str = "") -> dict:
    """Cross-implementation diff: mean/max error + correlation
    (TensorComparison.CompareTensors :34-82)."""
    a = _host(a).astype(np.float64).reshape(-1)
    b = _host(b).astype(np.float64).reshape(-1)
    if a.shape != b.shape:
        return {"name": name, "match": False, "error": "shape mismatch",
                "shape_a": a.shape, "shape_b": b.shape}
    err = np.abs(a - b)
    denom = np.std(a) * np.std(b)
    corr = float(np.mean((a - a.mean()) * (b - b.mean())) / denom) if denom > 0 else 1.0
    return {
        "name": name,
        "match": bool(np.allclose(a, b, rtol=1e-4, atol=1e-5)),
        "mean_error": float(err.mean()),
        "max_error": float(err.max()),
        "correlation": corr,
    }


_CURRENT: DiagnosticsContext = NullDiagnosticsContext()


def get_diagnostics() -> DiagnosticsContext:
    return _CURRENT


def set_diagnostics(ctx: DiagnosticsContext) -> None:
    global _CURRENT
    _CURRENT = ctx
