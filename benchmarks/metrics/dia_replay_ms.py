"""dia_replay_ms: device ms a decode step of Dia's loop.

The card's time between the CUDA events at the ends of the program's
"dia.loop" spans over the steps the loops took (their ``replays`` of the
step graphs and ``eager_steps``): the decode step alone, without the
encoder, the prefill or the codes' copy to the host. Gaps on the card
between the steps' kernels are inside it (``dia_loop_idle_share``); under
the profiler, whose replays block the host, they are wider.
"""

from benchmarks.program_spans import in_window


def read(trace, ctx):
    spans = in_window(trace)
    loops = [s for s in spans or () if s.name == "dia.loop" and s.device_ms is not None]
    steps = sum(s.attrs.get("replays", 0) + s.attrs.get("eager_steps", 0) for s in loops)
    if not steps:
        return None
    return sum(s.device_ms for s in loops) / steps
