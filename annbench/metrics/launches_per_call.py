"""Kernel launches a call: the device trace's kernels (copies and fills
left out) in the traced window, over its calls."""

from annbench.trace import is_launch


def read(ctx):
    if not ctx["calls"] or not ctx["device"]:
        return None
    return sum(1 for n, _, _ in ctx["device"] if is_launch(n)) / ctx["calls"]
