"""The harness's arithmetic: the union of device intervals, the rate over
whole batches, the check's sample and its bad rows."""

import numpy as np
import pytest

from kdbench import check, harness
from kdbench.trace import union


def test_union_of_overlapping_intervals():
    s = np.array([5, 0, 2, 20, 21, 30], np.int64)
    e = np.array([8, 3, 4, 25, 22, 31], np.int64)
    length, g0, g1 = union(s, e)
    # [0, 4) and [5, 8) and [20, 25) and [30, 31)
    assert length == 4 + 3 + 5 + 1
    assert list(zip(g0, g1)) == [(4, 5), (8, 20), (25, 30)]


def test_union_counts_nested_and_equal_intervals_once():
    length, g0, _ = union(np.array([0, 0, 1, 2]), np.array([10, 10, 3, 9]))
    assert length == 10 and g0.size == 0
    assert union(np.array([], np.int64), np.array([], np.int64))[0] == 0.0


def test_rate_is_all_queries_over_the_whole_window():
    b = [harness.Batch(10.0, 12.0, 100, None), harness.Batch(12.5, 14.0, 300, None)]
    # (100 + 300) / (14 - 10), not a mean of per-batch rates (50 and 200)
    assert harness.rate(b) == pytest.approx(100.0)
    assert harness.rate(b[:1]) == pytest.approx(50.0)


def test_sample_rows_is_the_seeds_and_spans_every_batch():
    a = check.sample_rows(2 ** 33 + 5, [100, 50, 200], 120)
    assert [len(x) for x in a] and sum(len(x) for x in a) == 120
    assert all((x >= 0).all() and (x < m).all() for x, m in zip(a, [100, 50, 200]))
    b = check.sample_rows(2 ** 33 + 5, [100, 50, 200], 120)
    assert all((x == y).all() for x, y in zip(a, b))
    assert sum(len(x) for x in check.sample_rows(1, [10], 99)) == 10


def test_bad_rows_catches_each_fault():
    d = np.array([[1, 2, 3]] * 6, np.float32)
    i = np.array([[0, 1, 2]] * 6, np.int64)
    i[1, 2] = 9                       # outside a catalogue of 5
    i[2, 1] = 0                       # repeated
    d[3, 0] = np.inf                  # not finite
    d[4] = [2, 1, 3]                  # not ascending
    i[5, 0] = -1                      # no neighbour
    assert check.bad_rows(5, d, i).tolist() == [False, True, True, True, True, True]
