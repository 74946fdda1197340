"""dia_attn_kernel_share: the share of Dia's decode steps whose attention ran
the port's decode-attention kernel, in %.

The program's "dia.loop" spans count, besides their ``replays`` of the step
graphs and ``eager_steps``, the ``attn_kernel_steps`` among them: replays
of graphs captured with the kernel's self and cross launches, and eager
steps that launched both. Their sum over the window's loops, over the sum
of the steps, x 100. A program whose loops do not count it gives None.
"""

from benchmarks.program_spans import in_window


def read(trace, ctx):
    loops = [s for s in in_window(trace) or () if s.name == "dia.loop"
             and "attn_kernel_steps" in s.attrs]
    steps = sum(s.attrs.get("replays", 0) + s.attrs.get("eager_steps", 0) for s in loops)
    if not steps:
        return None
    return 100.0 * sum(s.attrs["attn_kernel_steps"] for s in loops) / steps
