"""The plain reference against a naive NumPy kNN at tiny sizes, and the
control's TF32 rounding."""

import numpy as np
import pytest
import torch

from kdbench.reference import _tf32, knn_fp64, knn_tf32, sq_dists_of


def _naive(points, queries, k):
    d2 = ((queries[:, None, :].astype(np.float64) - points[None].astype(np.float64)) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, order, 1), order


@pytest.mark.parametrize("n,m,d,k", [(300, 17, 10, 10), (1000, 5, 3, 1), (64, 9, 2, 64)])
def test_fp64_matches_naive_up_to_ties(n, m, d, k, monkeypatch):
    import kdbench.reference as ref

    monkeypatch.setattr(ref, "_BLOCK_ELEMS", 7 * m)   # several blocks of points
    rng = np.random.default_rng(n)
    p = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    nd, ni = _naive(p, q, k)
    rd, ri = knn_fp64(torch.from_numpy(p), torch.from_numpy(q), k)
    np.testing.assert_allclose(rd.numpy(), nd, rtol=1e-9, atol=1e-12)
    # an id that differs is a tie: its own distance is the rank's
    np.testing.assert_allclose(sq_dists_of(torch.from_numpy(p), torch.from_numpy(q), ri).numpy(),
                               nd, rtol=1e-9, atol=1e-12)


def test_fp64_ties_keep_every_tied_point_once():
    p = np.array([[0.0, 1.0], [1.0, 0.0], [0.0, -1.0], [-1.0, 0.0], [5.0, 5.0]], np.float32)
    d2, ids = knn_fp64(torch.from_numpy(p), torch.zeros((1, 2)), 4)
    assert sorted(ids[0].tolist()) == [0, 1, 2, 3]
    np.testing.assert_array_equal(d2.numpy(), np.ones((1, 4)))


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 1.0 + 2 ** -12, 3.0])
    np.testing.assert_array_equal(_tf32(x).numpy(),
                                  np.array([1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, 3.0], np.float32))


def test_control_differs_from_the_reference_where_fp32_would_not():
    rng = np.random.default_rng(0)
    p = (rng.standard_normal((4000, 10)) * 0.05 + 3.0).astype(np.float32)
    q = (rng.standard_normal((50, 10)) * 0.05 + 3.0).astype(np.float32)
    _, ri = knn_fp64(torch.from_numpy(p), torch.from_numpy(q), 10)
    _, ci = knn_tf32(torch.from_numpy(p), torch.from_numpy(q), 10)
    assert (np.sort(ri.numpy(), 1) != np.sort(ci.numpy(), 1)).any()
