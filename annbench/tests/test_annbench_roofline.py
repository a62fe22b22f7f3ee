"""The roofline arithmetic and the readers, on known shapes."""

import types

import pytest

from annbench import roofline, trace
from annbench.spec import Bench


def test_k1_bound_at_the_scan_batch():
    # PERF.md §6: the ScanIndex batch's bound, 1.0765 ms (operations)
    t = roofline.k1_least_s(b=8192, n=1_015_808, d=128, lsub=64)
    assert t == pytest.approx(2 * 8192 * 1_015_808 * 128 / 1979e12)
    assert round(t * 1e3, 4) == 1.0765
    # bytes bound where operations are few: one query
    t = roofline.k1_least_s(b=1, n=1_000_000, d=128, lsub=64)
    assert t == pytest.approx((128 + 4e6 + 128e6 + 4 * 15625) / 3.35e12)


def test_k4_bound_at_the_packed_call():
    # PERF.md §6: E 432,446, V = E * K, 1.1268 ms (bytes)
    e = 432_446
    t = roofline.k4_least_s(expanded=e, scored=e * 64, k=64, d=128, b=8192,
                            ef=50)
    assert round(t * 1e3, 4) == 1.1268


def test_share_is_none_without_device_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0


def _ctx(**kw):
    base = {"calls": 2, "window_s": 1.0, "busy_s": 0.75, "device": [],
            "layers": {}, "counters": {}}
    base.update(kw)
    return base


def test_readers_on_a_known_trace():
    bench = Bench()
    dev = [("void (anonymous namespace)::packed_scan_kernel<0>(x)", 0.0,
            0.002), ("packed_scan_kernel<0>", 0.003, 0.005),
           ("Memset (Device)", 0.005, 0.006), ("at::topk(y)", 0.006, 0.007)]
    shape = dict(b=8192, n=1_000_000, d=128, lsub=64)
    ctx = _ctx(device=dev, layers={"k1": shape})
    want = 100 * roofline.k1_least_s(**shape) / 0.002
    assert bench.reader("k1_roofline_pct").read(ctx) == pytest.approx(want)
    assert bench.reader("launches_per_call").read(ctx) == 1.5
    assert bench.reader("device_idle_pct").read(ctx) == pytest.approx(25.0)
    assert bench.reader("k4_roofline_pct").read(ctx) is None
    assert bench.reader("build_s").read(ctx) is None
    assert bench.reader("build_s").read(_ctx(counters={"build_s": 3.5})) \
        == 3.5
    # nothing to read: no value, never 0
    empty = _ctx(device=[], window_s=0.0, layers={"k1": shape})
    for name in ("k1_roofline_pct", "launches_per_call", "device_idle_pct"):
        assert bench.reader(name).read(empty) is None


def _event(name, t0, t1, cpu=True, annotation=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=t0, end=t1),
        device_type=DeviceType.CPU if cpu else DeviceType.CUDA,
        is_user_annotation=annotation)


def test_trace_reduce_busy_idle_and_gaps():
    ev = [
        _event(trace.CALL, 0, 100), _event(trace.CALL, 100, 200),
        _event(trace.CALL, 0, 100, cpu=False, annotation=True),
        _event("aten::topk", 10, 40), _event(trace.SYNC, 60, 100),
        _event("kernA", 20, 50, cpu=False), _event("kernB", 40, 90,
                                                     cpu=False),
        _event("kernA", 150, 190, cpu=False),
        _event("kernC", 250, 260, cpu=False),   # outside the window
    ]
    out = trace.reduce(ev)
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx(110e-6)
    assert [n for n, _, _ in out["device"]] == ["kernA", "kernA", "kernB"]
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::topk"] == pytest.approx(20e-6)      # 0-20
    assert gaps[trace.SYNC] == pytest.approx(60e-6)        # 90-150
    assert gaps["python"] == pytest.approx(10e-6)          # 190-200
    assert dict(out["device_ops"])["kernA"] == pytest.approx(70e-6)
    assert trace.short("void (anonymous namespace)::walk_kernel(float*)") \
        == "walk_kernel"


def test_trace_reduce_without_calls():
    assert trace.reduce([])["window_s"] == 0.0
