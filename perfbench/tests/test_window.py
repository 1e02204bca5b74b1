"""The window arithmetic on synthetic records."""

import math

import pytest

from perfbench.lib import window as w


def rec(i, due, done=None, ok=True, res=1024, sent=None, given_up=None):
    return w.Record(i, f"r{i}", res, due, due if sent is None else sent,
                    done=done, ok=ok, given_up=given_up)


def test_nearest_rank_has_ten_beyond_p90_of_100():
    vals = list(range(1, 101))
    assert w.nearest_rank(vals, 0.9) == 90
    assert w.nearest_rank(vals, 0.5) == 50
    assert w.nearest_rank([3.0], 0.9) == 3.0


def test_open_loop_counts_only_requests_due_in_window():
    rs = [rec(0, 9.0, 10.0), rec(1, 10.0, 12.0), rec(2, 15.0, 16.0),
          rec(3, 20.0, 21.0)]
    m = w.open_loop(rs, 10.0, 20.0, "sdxl", 5)
    assert m["attempted"] == 2 and m["failed"] == 0
    assert m["p50_latency_s"] == pytest.approx(1.0)
    assert m["p90_latency_s"] == pytest.approx(2.0)
    assert m["slo_attainment"] == 1.0


def test_failures_are_latest_and_missed():
    rs = [rec(i, 10.0 + i, 11.0 + i) for i in range(9)]
    rs.append(rec(9, 10.0, done=10.5, ok=False, given_up=80.0))
    m = w.open_loop(rs, 10.0, 20.0, "sdxl", 5)
    assert m["failed"] == 1
    assert m["p90_latency_s"] == pytest.approx(1.0)
    assert max(r.latency() for r in rs) == pytest.approx(70.001)
    assert m["slo_attainment"] == pytest.approx(0.9)


def test_deadline_misses_lower_attainment():
    ddl = w.slo_deadline_s("sdxl", 1024, 5)
    assert ddl == pytest.approx(19.31)
    rs = [rec(0, 10.0, 10.0 + ddl + 0.1), rec(1, 11.0, 12.0)]
    assert w.open_loop(rs, 10.0, 20.0, "sdxl", 5)["slo_attainment"] == 0.5
    assert w.slo_deadline_s("sdxl", 1024, 3) == pytest.approx(19.31 * 0.6)
    assert w.slo_deadline_s("sd15", 1024, 5) == pytest.approx(12.0 * 16 / 9)


def test_closed_loop_rate_runs_over_the_window():
    rs = [rec(0, 0.0, 5.0, res=512, sent=0.0),
          rec(1, 5.0, 12.0, res=512, sent=5.0),
          rec(2, 12.0, 30.0, res=512, sent=12.0),
          rec(3, 19.0, 25.0, ok=False, res=512, sent=19.0)]
    m = w.closed_loop(rs, 10.0, 20.0)
    assert m["mpix_per_s"] == pytest.approx(512 * 512 / 1e6 / 10.0)
    assert m["attempted"] == 2 and m["failed"] == 1


def test_empty_window_raises():
    with pytest.raises(ValueError):
        w.open_loop([rec(0, 1.0, 2.0)], 10.0, 20.0, "sdxl", 5)
    assert not math.isnan(w.slo_deadline_s("sd3", 768))
