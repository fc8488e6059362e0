"""The fp32 path's exactness: the fault of the reference and the port's repair.

``repro`` selects each query's k candidates by the decomposed distance
||q||^2 - 2 q.x + ||x||^2 in fp32 and re-ranks only those k exactly, so a
true neighbour within that form's rounding of the k-th can be lost.  Far
from the origin (+300 on every coordinate) the rounding is large enough to
swap neighbours on most queries: ``repro.api.KNNIndex`` then misses true
neighbours against its own ``repro.core.knn_brute``.  The port's fp32
engines select ``FP32_OVERFETCH`` extra candidates, prove each row
(``certify`` with eps = 0) and search the unproven rows again (``chunked``:
the refining pass, then brute force; ``jit``: brute force), so on the same
data they return brute force's answers (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core import knn_brute as jax_knn_brute
from repro_torch.api import IndexSpec, KNNIndex, knn_brute
from repro_torch.core.lazysearch import FP32_OVERFETCH, BufferKDTree, certify

CPUS = (torch.device("cpu"),)
TOL = dict(rtol=1e-5, atol=1e-6)


def _far_data(d, offset=300.0, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(3000, d)) + offset).astype(np.float32)
    q = (rng.normal(size=(200, d)) + offset).astype(np.float32)
    return pts, q


@pytest.mark.parametrize("engine", ["chunked", "jit"])
@pytest.mark.parametrize("d", [3, 8])
def test_reference_misses_and_the_port_is_exact(engine, d):
    """``repro.api.KNNIndex`` (the same engine) misses a true neighbour on
    points offset by +300; the port's fp32 index returns
    ``repro.core.knn_brute``'s answers on every row."""
    pts, q = _far_data(d)
    bd, bi = (np.asarray(a) for a in jax_knn_brute(q, pts, 10))
    ref = jax_api.KNNIndex.build(pts, spec=jax_api.IndexSpec(engine=engine, height=4)).query(q, 10)
    missed = ~np.isclose(ref.dists, bd, rtol=1e-5, atol=1e-6).all(axis=1)
    assert missed.any(), "the reference no longer misses here"
    index = KNNIndex.build(pts, IndexSpec(engine=engine, height=4, devices=CPUS))
    assert index.plan.precision == "fp32"
    res = index.query(q, 10)
    np.testing.assert_array_equal(res.idx, bi)
    np.testing.assert_allclose(res.dists, bd, **TOL)
    # the rows the certificate could not prove were searched again
    assert res.stats.exact_rows > 0
    if engine == "chunked":
        assert res.stats.refined_rows > 0


def test_streaming_rows_are_exact_far_from_the_origin():
    """``query_stream`` delivers each row once, with the proven or
    re-searched answer."""
    pts, q = _far_data(4)
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    index = KNNIndex.build(pts, IndexSpec(engine="streaming", height=4, devices=CPUS))
    seen = np.zeros(len(q), int)
    got = np.zeros((len(q), 10), np.int64)

    def on_complete(rows, dists, idx):
        seen[rows] += 1
        got[rows] = idx

    res = index.query_stream(q, 10, on_complete=on_complete)
    assert (seen == 1).all()
    np.testing.assert_array_equal(got, bi)
    np.testing.assert_array_equal(res.idx, bi)


def test_near_the_origin_every_row_is_proven_by_the_first_pass():
    """Where the rounding is small against the gaps between neighbours, the
    overfetched candidates prove every row: one engine pass, as before."""
    pts, q = _far_data(6, offset=0.0, seed=3)
    index = BufferKDTree(pts, height=4, device=torch.device("cpu"))
    dists, idx = index.query(q, 10)
    assert (index.stats.refined_rows, index.stats.exact_rows) == (0, 0)
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    np.testing.assert_array_equal(idx, bi)
    assert index._engine_k(10) == 10 + FP32_OVERFETCH


def test_certificate_at_eps_zero():
    """``certify`` with eps = 0 (fp32): a row is proven when the k_eff-th
    engine distance, less the rounding bound, is no nearer than the exact
    k-th; a k_eff-th inside that bound leaves the row unproven."""
    q = np.zeros((2, 3), np.float32)
    dists = np.full((2, 10), 1.0, np.float32)
    d2 = np.zeros((2, 14), np.float32)
    d2[0, -1] = 1.01
    d2[1, -1] = 1.0 + 1e-9
    ok = certify(q, d2, dists, 10, 14, eps=0.0, x_norm_max=10.0)
    np.testing.assert_array_equal(ok, [True, False])
    # the bound grows with the norms: far from the origin, 1.01 is too close
    ok = certify(q + 300.0, d2, dists, 10, 14, eps=0.0, x_norm_max=600.0)
    np.testing.assert_array_equal(ok, [False, False])
