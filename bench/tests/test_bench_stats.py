"""The rate over a window and the mean, against cases worked by hand."""

import pytest

from bench.lib import stats


def test_rate_is_the_work_over_the_window():
    assert stats.rate(300, 60.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_mean_of_nothing_is_none():
    assert stats.mean([]) is None
    assert stats.mean([1.0, 2.0]) == 1.5
