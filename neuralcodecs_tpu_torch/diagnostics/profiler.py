"""Profiling, the port's span recorder and the numeric-sanitizer helpers.

Counterpart of neuralcodecs_tpu.diagnostics.profiler. The reference's
tracing is wall-clock scopes + ETW counters (DiagnosticsContext.cs:270-298,
CodecEventSource.cs); here a device trace is ``torch.profiler`` written as a
Chrome trace (viewable in Perfetto or chrome://tracing), and the NaN/Inf
guard is forward hooks over a module's submodules, the counterpart of
``checkify``'s failure site.

Spans. ``span(name)`` marks a region of the program at a layer boundary
(Dia's encoder, prefill and decode loop; DAC's upload and stages). It
records only while a ``torch.profiler`` session records (its active steps)
or inside a ``recording()`` block; otherwise it returns one shared object
that does nothing, for the cost of one flag check. A recorded span is a
``record_function`` named ``nc.<name>`` in the profiler's timeline and a
``Span`` in this module's list (``recorded_spans()``): its parent, its
request (every span under one root span), its host interval on the
``time.time_ns()`` clock, which is the clock of the profiler's events, so
spans can be placed against the device's intervals; its counts, and, where
asked, the card's time between CUDA events at its two ends. No span opens
inside a function that a CUDA graph captures.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import tempfile
import threading
import time
from pathlib import Path

import torch

# records kept at most; the cap counts later ones in ``SpanList.dropped``
SPAN_CAP = 1 << 20

_profiler_enabled = torch._C._autograd._profiler_enabled
_open: contextvars.ContextVar[tuple] = contextvars.ContextVar("nc_open_spans", default=())
_ids = itertools.count(1)
_records: list["Span"] = []
_dropped = 0
_forced = 0
_forced_lock = threading.Lock()


class _NullSpan:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class Span:
    """One recorded span. ``start_ns`` / ``end_ns``: host times on the
    ``time.time_ns()`` clock; ``parent``: the enclosing span's ``id`` (None
    for a root); ``request``: the root's ``id``; ``attrs``: its counts;
    ``device_ms``: the card's time between the span's CUDA events (None
    where it took none)."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "attrs",
                 "device_ms", "_device", "_events", "_rf", "_token")

    def __init__(self, name: str, device):
        self.name, self._device, self.attrs = name, device, {}
        self.device_ms = self._events = None

    def __enter__(self) -> "Span":
        stack = _open.get()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.request = self.id if parent is None else parent.request
        self._token = _open.set(stack + (self,))
        # the profiler's own event, where one records (not in a bare recording())
        self._rf = torch.profiler.record_function("nc." + self.name) \
            if _profiler_enabled() else contextlib.nullcontext()
        self._rf.__enter__()
        stream = _timing_stream(self._device)
        if stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)
        # read inside the record_function, so the record lies inside its event
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        self._rf.__exit__(*exc)
        _open.reset(self._token)
        self._rf = self._token = None
        if len(_records) < SPAN_CAP:
            _records.append(self)
        else:
            _dropped += 1

    def set(self, **attrs) -> None:
        """Add counts to the span."""
        self.attrs.update(attrs)

    def _resolve(self) -> "Span":
        if self._events is not None:
            start, end, _ = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None
        return self

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, {(self.end_ns - self.start_ns) / 1e6:.3f} ms, "
                f"{self.attrs})")


class SpanList(list):
    """``recorded_spans()``'s spans in the order they closed; ``dropped``:
    how many the cap turned away."""

    dropped = 0


def _timing_stream(device):
    """The stream a span's CUDA events go on: ``device``'s current one; None
    where nothing is timed (no device, a CPU one, or a graph capturing)."""
    if device is None or torch.device(device).type != "cuda" \
            or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream(torch.device(device))


def span(name: str, *, device=None):
    """A context manager around one region of the program; entering yields
    its ``Span`` while spans record, else a shared object whose ``set``
    does nothing.

    ``device``: time the region on that device too, by CUDA events on its
    current stream (a CPU device takes none)."""
    if not (_forced or _profiler_enabled()):
        return _NULL
    return Span(name, device)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, on every thread, with or without a
    profiler."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


def recorded_spans() -> SpanList:
    """The spans recorded since the last ``clear_spans()``, their device
    times resolved (which waits for their events)."""
    out = SpanList(s._resolve() for s in list(_records))
    out.dropped = _dropped
    return out


def clear_spans() -> None:
    """Forget the recorded spans and the count of those dropped."""
    global _dropped
    _records.clear()
    _dropped = 0


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Capture a host and device trace around a block and write it as a
    Chrome trace ``<log_dir>/<pid>_<ns>.pt.trace.json`` (``log_dir``
    defaults to ``nc_profile`` in the temporary directory):

        with trace("prof") as prof:
            model.forward(audio)
        prof.trace_path   # the written file
        prof.spans        # the program's spans in the block

    The yielded profiler also answers ``key_averages()``. The span recorder
    is cleared on entry, so ``prof.spans`` and the trace are one session's."""
    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "nc_profile"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.spans = recorded_spans()
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
