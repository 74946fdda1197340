"""idle_share: the share of the traced window with no device operation, in %.

1 - (the union of the device's kernel, copy and fill intervals) / the
window's wall, from torch.profiler's device events.
"""


def read(trace, ctx):
    if not trace.device or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
