"""K4's share of its roofline: the least time of one call's walk
(``roofline.k4_least_s``, its rows expanded and neighbours scored
counted by ``walkcount`` on that call's own inputs) over K4's device
time a call, the profiler's time for the kernels named
``walk_kernel`` over the traced calls."""

from annbench import roofline

KERNEL = "walk_kernel"


def read(ctx):
    work = ctx["layers"].get("k4")
    if not work or not ctx["calls"]:
        return None
    t = sum(b - a for n, a, b in ctx["device"] if KERNEL in n)
    return roofline.share_pct(roofline.k4_least_s(**work), t / ctx["calls"])
