"""resunit_dense_roofline: kernel 2b's share of its roofline, in %.

The least time of the dense residual units the traced calls ran
(``arith/dac.units_bound_s`` at their shapes: 3xTF32 operations at the TF32
peak, or their bytes at the HBM bandwidth, whichever is larger, unit by
unit) over the device time of kernel 2b's launches in the trace: its snake
launch (``snake_rows``) and its two GEMM launches (``resunit_gemm<...>``).
"""

KERNELS = ("snake_rows", "resunit_gemm")


def read(trace, ctx):
    seconds = trace.device_s(lambda name: any(k in name for k in KERNELS))
    if not seconds or not ctx.get("resunit_bound_s"):
        return None
    return 100.0 * ctx["resunit_bound_s"] / seconds
