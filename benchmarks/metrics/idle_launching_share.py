"""idle_launching_share: the share of the traced window in which the card
was idle while the host was inside the program's DAC path, in %.

The idle inside the program's root spans ("dac.forward"): the host was
in the program (the upload, the stages' launches, the RVQ's host path)
while the card had no work. The DAC path never blocks the host on the card
(no copy to the host, no synchronisation), so that idle is the launch
path's; idle outside the program (the benchmark's copy of the results to
the host, its own bookkeeping) does not count, so the share is at most
``idle_share``. Dia's calls block in their stop tests, and under the
profiler each replay of its step graphs blocks the host too, so the same
reading there would be the profiler's: it is not registered in Dia's cell.
"""

from benchmarks.program_spans import idle_share, in_window


def read(trace, ctx):
    return idle_share(trace, [s for s in in_window(trace) or () if s.parent is None])
