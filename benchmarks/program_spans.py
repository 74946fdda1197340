"""The program's own spans inside a traced window, for the metric readers.

The port records its spans (``neuralcodecs_tpu_torch.diagnostics.profiler``:
``span``, ``recorded_spans``) while the profiler records, that is in the
traced calls, with host times on the clock of the profiler's events. A
program without the recorder gives None, and its readers find nothing to
read.
"""

import numpy as np


def in_window(trace) -> list | None:
    """The recorded spans that lie inside ``trace.window``, or None where the
    program records none."""
    try:
        from neuralcodecs_tpu_torch.diagnostics.profiler import recorded_spans
    except ImportError:
        return None
    lo, hi = trace.window
    return [s for s in recorded_spans() if lo <= s.start_ns and s.end_ns <= hi]


def idle_share(trace, spans) -> float | None:
    """% of the traced window in which the card ran nothing while one of
    ``spans`` (host intervals that do not overlap) was open; None where
    there are none or the trace has no device."""
    if not spans or not trace.device or not trace.window_s:
        return None
    lo, hi = np.array([(s.start_ns, s.end_ns) for s in spans], dtype=np.float64).T
    idle = float((hi - lo).sum()) / 1e9 - float(trace.busy_between(lo, hi).sum())
    return 100.0 * idle / trace.window_s


def stage_idle_share(trace, name: str) -> float | None:
    """``idle_share`` over the program's spans named ``name``."""
    return idle_share(trace, [s for s in in_window(trace) or () if s.name == name])
