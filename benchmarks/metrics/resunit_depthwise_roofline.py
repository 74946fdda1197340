"""resunit_depthwise_roofline: kernel 2a's share of its roofline, in %.

The least time of the depthwise residual units the traced calls ran
(``arith/snac.units_bound_s`` at their shapes: the pointwise products in
3xTF32 at the TF32 peak, or the unit's bytes at the HBM bandwidth,
whichever is larger, unit by unit) over the device time of kernel 2a's
launches in the trace: its depthwise launch (``depthwise_rows``) and its
pointwise GEMM (``resunit_gemm<...>``). Registered where no dense unit runs:
kernel 2b launches the same GEMM.
"""

KERNELS = ("depthwise_rows", "resunit_gemm")


def read(trace, ctx):
    seconds = trace.device_s(lambda name: any(k in name for k in KERNELS))
    if not seconds or not ctx.get("depthwise_bound_s"):
        return None
    return 100.0 * ctx["depthwise_bound_s"] / seconds
