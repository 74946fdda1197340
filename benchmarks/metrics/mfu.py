"""mfu: the whole model's share of the card's peak over the traced window, in %.

The model's FLOPs for the work the traced calls completed, from the
configuration's shapes (``arith/``), over the window's wall times the peak
of the dtype its products run in (``peak_flops``: TF32 for DAC, whose
residual units run 3xTF32 on the tensor cores; bf16 for Dia in bf16).
"""


def read(trace, ctx):
    if not ctx.get("flops") or not trace.window_s:
        return None
    return 100.0 * ctx["flops"] / (trace.window_s * ctx["peak_flops"])
