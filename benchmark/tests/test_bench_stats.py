"""The yardstick's arithmetic: the frame time follows every frame, a
stall included, where a median of chunks would not."""
import statistics

import numpy as np
import pytest

from benchmark import stats


def test_frame_ms_moves_with_one_stall_and_chunk_medians_do_not():
    steady = [600.0] * 60
    stalled = list(steady)
    stalled[30] = 600.0 + 3000.0
    base = stats.frame_ms(sum(steady) / 1e3, 60)
    hit = stats.frame_ms(sum(stalled) / 1e3, 60)
    assert hit == pytest.approx(base + 50.0)

    def chunk_median(x):
        return statistics.median(np.mean(c) for c in np.array_split(x, 6))

    assert chunk_median(stalled) == chunk_median(steady)
    # the tail counts every frame
    one_in_ten = list(steady)
    for i in range(0, 60, 8):
        one_in_ten[i] = 900.0
    assert stats.percentile(one_in_ten, stats.P90) > 600.0


def test_percentile_is_numpy_linear():
    x = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(x, 90) == pytest.approx(4.6)
    assert stats.percentile(x, 90) == np.percentile(x, 90)


def test_spread_is_statistics_quartiles_over_median():
    x = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(x, n=4)
    assert stats.spread(x) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert stats.union_s(iv) == 12 + 10 + 1
    assert stats.gaps(iv, 2) == [(12, 8), (30, 10)][::-1]
    assert stats.union_s([]) == 0.0


def test_frame_ms_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.frame_ms(1.0, 0)
