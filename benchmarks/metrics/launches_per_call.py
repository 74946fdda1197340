"""launches_per_call: the host's kernel and graph launches per traced call.

Counted from the profiler's CUDA runtime events (``cudaLaunchKernel*``,
``cuLaunchKernel*``, ``cudaLaunchCooperativeKernel``, ``cudaGraphLaunch``),
over the calls traced. A codec cell's call is one request. Every launch,
the port's kernels' and cuDNN's, cuBLAS's and torch's alike, costs the host
its enqueue; what a per-call optimisation (graphing, fusing) removes shows
here first.
"""


def read(trace, ctx):
    if not trace.launches or not ctx.get("calls"):
        return None
    return trace.launches / ctx["calls"]
