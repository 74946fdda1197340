"""dia_loop_idle_share: the share of Dia's decode loop in which the card ran
nothing, in %.

1 - the card's busy time (the union of its operations in the trace) inside
the program's "dia.loop" spans over their wall: the gaps inside and
between the step graphs while the host steps the loop. Under the profiler
each replay of the step graphs blocks the host for milliseconds, so the
reading holds the profiler's gaps too.
"""

import numpy as np

from benchmarks.program_spans import in_window


def read(trace, ctx):
    spans = in_window(trace)
    loops = [(s.start_ns, s.end_ns) for s in spans or () if s.name == "dia.loop"]
    if not loops or not trace.device:
        return None
    lo, hi = np.array(loops, dtype=np.float64).T
    wall = float((hi - lo).sum()) / 1e9
    if not wall:
        return None
    return 100.0 * (1.0 - float(trace.busy_between(lo, hi).sum()) / wall)
