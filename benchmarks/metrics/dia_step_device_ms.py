"""dia_step_device_ms: device ms per decode-loop step inside Dia's codes.

The card's busy time (the union of its operations) inside the benchmark's
"generate_codes" spans over the calls' decode steps (as ``dia_step_ms``):
the device's part of ``dia_step_ms``, which the host's pauses do not move.
"""

import numpy as np


def read(trace, ctx):
    spans = [(s, e) for n, s, e in trace.spans if n == "bench.generate_codes"]
    if not spans or not trace.device or not ctx.get("steps"):
        return None
    lo, hi = np.array(spans, dtype=np.float64).T
    return 1e3 * float(trace.busy_between(lo, hi).sum()) / ctx["steps"]
