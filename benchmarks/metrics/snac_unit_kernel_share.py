"""snac_unit_kernel_share: the share of SNAC's residual units that ran kernel
2a, in %.

The program's SNAC root spans ("snac.forward", "snac.encode",
"snac.decode") count the residual units a call ran (``units``) and those
whose wrapper launched kernel 2a (``unit_kernel_units``). Their sums over
the window's roots, the second over the first, x 100. A program whose
roots do not count them gives None.
"""

from benchmarks.program_spans import in_window


def read(trace, ctx):
    roots = [s for s in in_window(trace) or () if s.parent is None
             and s.name.startswith("snac.") and "units" in s.attrs]
    units = sum(s.attrs["units"] for s in roots)
    if not units:
        return None
    return 100.0 * sum(s.attrs["unit_kernel_units"] for s in roots) / units
