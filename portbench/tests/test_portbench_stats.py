"""Percentiles over all samples, spreads, and unions of intervals."""
import statistics

import numpy as np
import pytest

from portbench.harness import stats


@pytest.mark.parametrize("q", [0, 50, 90, 95, 100])
def test_percentile_matches_numpy(q):
    x = list(np.random.default_rng(1).lognormal(size=101))
    assert stats.percentile(x, q) == pytest.approx(float(np.percentile(x, q)))
    assert stats.percentile([], q) is None


def test_spread_is_quartile_distance_over_median():
    x = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(x, n=4)
    assert stats.spread(x) == pytest.approx((q3 - q1) / q2)


def test_union_counts_overlaps_once():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union(iv) == [(0, 3), (5, 6)]
    assert stats.covered(iv, 0, 10) == pytest.approx(4.0)
    assert stats.covered(iv, 2, 5.5) == pytest.approx(1.5)
    assert stats.gaps(iv, -1, 7) == [(-1, 0), (3, 5), (6, 7)]
