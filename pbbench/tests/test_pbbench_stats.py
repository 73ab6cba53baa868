"""Percentiles and the TTFT / TPOT / token arithmetic."""
import numpy as np
import pytest

from pbb import stats
from pbb.stats import Stamps


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy_linear(q):
    xs = list(np.random.default_rng(3).lognormal(0, 1, 37))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_tail_mean_averages_the_slowest_share():
    xs = [float(i) for i in range(1, 101)]          # 1..100
    assert stats.tail_mean(xs, 0.05) == pytest.approx(98.0)
    assert stats.tail_mean(xs[:10], 0.05) == 10.0   # at least one value


def test_ttft_counts_requests_still_waiting_at_the_close():
    reqs = [Stamps(0.5, [1.0, 1.1]),       # served: 0.5
            Stamps(2.0, []),               # still waiting at 10: 8.0
            Stamps(9.0, [9.75]),           # 0.75
            Stamps(10.5, [])]              # due after the close: left out
    assert stats.ttft_s(reqs, 10.0) == pytest.approx([0.5, 8.0, 0.75])


def test_tpot_over_tokens_after_the_first_in_the_window():
    reqs = [Stamps(0.0, [1.0, 1.2, 1.4, 1.6]),   # 3 gaps over 0.6 s
            Stamps(0.0, [2.0]),                  # one token: left out
            Stamps(0.0, [])]
    assert stats.tpot_s(reqs) == pytest.approx([0.2])
    assert stats.tokens_in_window(reqs) == 5


def test_tpot_mean_weighs_every_token_after_the_first():
    reqs = [Stamps(0.0, [1.0, 1.1, 1.2, 1.3]),   # 3 gaps, 0.3 s
            Stamps(0.0, [2.0, 3.0]),             # 1 gap, 1.0 s (a stall)
            Stamps(0.0, [5.0])]
    assert stats.tpot_mean_s(reqs) == pytest.approx(1.3 / 4)
    assert stats.tpot_mean_s([Stamps(0.0, [1.0])]) is None
