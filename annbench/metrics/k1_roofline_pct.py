"""K1's share of its roofline: the least time of a call's K1 work
(``roofline.k1_least_s`` at the call's B, N, D and lsub) over K1's
device time a call, the profiler's time for the kernels named
``packed_scan_kernel`` over the traced calls."""

from annbench import roofline

KERNEL = "packed_scan_kernel"


def read(ctx):
    shape = ctx["layers"].get("k1")
    if not shape or not ctx["calls"]:
        return None
    t = sum(b - a for n, a, b in ctx["device"] if KERNEL in n)
    return roofline.share_pct(roofline.k1_least_s(**shape), t / ctx["calls"])
