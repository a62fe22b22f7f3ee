"""Device trace of the traced window, by ``torch.profiler``.

The harness wraps each call of the window in a span of its own
(``annbench.call``) and its wait for the device in another
(``annbench.sync``).  The traced window runs from the start of the first
call's span to the end of the last one.  From the profiler's events
this module keeps what the per-layer readers and the ``breakdown`` read:
every device operation inside the window (name, start, end), the host's
operations beside them, the union of the device's busy time, and the
idle gaps, each named by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import collections
import re

import torch
from torch.autograd import DeviceType

CALL, SYNC = "annbench.call", "annbench.sync"


def profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def is_launch(name: str) -> bool:
    """A kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def short(name: str, width: int = 96) -> str:
    """A device operation's name without its return type and
    parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, end = 0, len(name)
    for j, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            end = j
            break
    return name[:end][:width]


def reduce(events) -> dict:
    """Everything the readers use, from ``prof.events()``: ``window_s``,
    ``busy_s``, ``device`` [(name, start_s, end_s)] inside the window,
    ``device_ops`` and ``idle_gaps`` [[name, seconds]] (top 10 each)."""
    calls, host, device = [], [], []
    for e in events:
        t0, t1 = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CPU:
            if e.name == CALL:
                calls.append((t0, t1))
            else:
                host.append((t0, t1, e.name))
        elif not getattr(e, "is_user_annotation", False) \
                and e.name not in (CALL, SYNC):
            device.append((e.name, t0, t1))
    if not calls:
        return {"window_s": 0.0, "busy_s": 0.0, "device": [],
                "device_ops": [], "idle_gaps": []}
    w0 = min(c[0] for c in calls)
    w1 = max(c[1] for c in calls)
    device = sorted((n, max(a, w0), min(b, w1)) for n, a, b in device
                    if b > w0 and a < w1)
    busy = _union(sorted((a, b) for _, a, b in device))
    by_op = collections.Counter()
    for n, a, b in device:
        by_op[short(n)] += b - a
    gaps = _gaps(busy, w0, w1)
    return {
        "window_s": w1 - w0,
        "busy_s": sum(b - a for a, b in busy),
        "device": device,
        "device_ops": [[n, s] for n, s in by_op.most_common(10)],
        "idle_gaps": _name_gaps(gaps, host),
    }


def _union(spans):
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(busy, w0, w1):
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def _name_gaps(gaps, host):
    """[[what the host did, seconds]]: each gap goes to the host
    operation that covers most of it ("python" where none does), summed
    by name, the ten largest."""
    host = sorted(host)
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    total = collections.Counter()
    for a, b in gaps:
        best, name = 0.0, "python"
        j = bisect.bisect_left(starts, a - longest)
        while j < len(host) and host[j][0] < b:
            s, e, n = host[j]
            over = min(e, b) - max(s, a)
            if over > best:
                best, name = over, n
            j += 1
        total[name] += b - a
    return [[n, s] for n, s in total.most_common(10)]
