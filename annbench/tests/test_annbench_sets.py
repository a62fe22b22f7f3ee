"""The spreads that bounds are set from, and the control's readings
taken on a card only."""

import statistics

import pytest
import torch

from annbench import readings, sets


def test_spread_is_the_interquartile_range_over_the_median():
    v = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q = statistics.quantiles(v, n=4)
    assert sets.spread(v) == pytest.approx((q[2] - q[0]) / 100.25)
    # the run farthest from the median goes, and only it
    assert sets.trimmed_spread(v + [130.0]) == pytest.approx(sets.spread(v))


def test_readings_refuse_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert readings.main(["--workload", "sift1m.scan.b8192",
                          "--seeds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
