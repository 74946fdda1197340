"""Profiling + numeric-sanitizer helpers.

Counterpart of neuralcodecs_tpu.diagnostics.profiler. The reference's
tracing is wall-clock scopes + ETW counters (DiagnosticsContext.cs:270-298,
CodecEventSource.cs); here a device trace is ``torch.profiler`` written as a
Chrome trace (viewable in Perfetto or chrome://tracing), a named region is
``torch.profiler.record_function``, and the NaN/Inf guard is forward hooks
over a module's submodules, the counterpart of ``checkify``'s failure site.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Capture a host and device trace around a block and write it as a
    Chrome trace ``<log_dir>/<pid>_<ns>.pt.trace.json`` (``log_dir``
    defaults to ``nc_profile`` in the temporary directory):

        with trace("prof") as prof:
            model.forward(audio)
        prof.trace_path   # the written file

    The yielded profiler also answers ``key_averages()``."""
    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "nc_profile"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        log_dir.mkdir(parents=True, exist_ok=True)
        prof.trace_path = log_dir / f"{os.getpid()}_{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(prof.trace_path))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def _non_finite(out) -> bool:
    """Does a module output (a tensor, or tensors nested in tuples, lists and
    dicts) hold a NaN or an Inf in a floating tensor?"""
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return any(_non_finite(o) for o in out)
    if isinstance(out, dict):
        return any(_non_finite(o) for o in out.values())
    return False


def nan_guard(fn, module: torch.nn.Module | None = None):
    """Wrap ``fn`` so that a NaN or Inf raises ValueError naming where it
    first appeared, the counterpart of the JAX package's checkify guard
    (the reference's NaN anomaly detection, DiagnosticsContext.cs:347-421).

    ``fn`` is an ``nn.Module`` or a callable that runs ``module``. While the
    wrapper runs, a forward hook on every submodule checks its output, so
    the error names the first module to finish with a non-finite output
    (the innermost one that made it); a non-finite final output of a
    callable with no module is reported against the callable. Each check
    reads the device, so the guard is for debugging, not serving."""
    root = fn if isinstance(fn, torch.nn.Module) else module
    label = getattr(fn, "__qualname__", type(fn).__name__)

    def wrapper(*args, **kwargs):
        handles = []

        def hook_for(name: str):
            def hook(mod, _inputs, out):
                if _non_finite(out):
                    raise ValueError(f"non-finite output (NaN/Inf) in module "
                                     f"'{name or '<root>'}' ({type(mod).__name__})")
            return hook

        if root is not None:
            handles = [m.register_forward_hook(hook_for(name))
                       for name, m in root.named_modules()]
        try:
            out = fn(*args, **kwargs)
        finally:
            for h in handles:
                h.remove()
        if _non_finite(out):
            raise ValueError(f"non-finite output (NaN/Inf) from {label}")
        return out

    return wrapper
