"""Tails are taken over all requests and rates over the whole window."""

import statistics
import types

import pytest

from h100bench.benchlib import stats
from h100bench.tests.tiny import driver


def test_percentile_is_numpy_linear_over_all_values():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_quartile_spread_uses_statistics_quantiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.quartile_spread(xs) == pytest.approx((q3 - q1) / med)


def _rec(t_sub, deliveries, done_at=None, budget=None, greedy=False):
    out = [1] * sum(n for _, n in deliveries)
    req = types.SimpleNamespace(t_submitted=t_sub, output=out, done=done_at is not None,
                                t_finished=done_at or 0.0, prompt=[1, 2])
    return types.SimpleNamespace(request=req, deliveries=deliveries, greedy=greedy,
                                 budget=budget if budget is not None else len(out))


def test_window_summary_counts_every_request_and_the_whole_window():
    chat = driver("chat")
    records = [
        _rec(0.0, [(1.0, 16), (2.0, 16)], done_at=2.0),       # first token before the window
        _rec(1.5, [(3.0, 1), (4.0, 16), (5.0, 16)]),          # in flight at the close
        _rec(2.5, [(3.0, 4)], done_at=3.0),                    # all tokens in one fetch
        _rec(4.5, [(6.0, 1)]),                                 # first token after the close
        _rec(2.0, [(4.0, 3)], done_at=4.0, budget=5),          # finished short: failed
    ]
    w = chat.summarize(records, 1.5, 5.0, vocab=10)
    assert w["tokens"] == 16 + 33 + 4 + 3
    assert sorted(w["ttft_ms"]) == pytest.approx([500.0, 1500.0, 2000.0])
    # Two or more tokens in the window, finished or not; one fetch reads 0.
    assert sorted(w["tpot_ms"]) == pytest.approx([0.0, 0.0, 0.0, 2000.0 / 32])
    assert len(w["finished"]) == 3 and w["failed"] == 1
    assert w["attempted"] == 5
