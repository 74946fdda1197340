"""vocode_share: the vocoder's share of the traced window's wall, in %.

The benchmark's "vocode" spans around the vocoder's ``from_codes`` (which
synchronise while traced, so they hold its device time) over the window.
"""


def read(trace, ctx):
    seconds = trace.span_s("vocode")
    if not seconds or not trace.window_s:
        return None
    return 100.0 * seconds / trace.window_s
