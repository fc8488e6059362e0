"""repro_torch's streaming engine vs the batch contract and the JAX reference.

Mirrors ``tests/test_streaming.py`` on the port, on the CPU: the
``streaming`` engine delivers every query row exactly once through
``query_stream``'s callback, with the values the batch path returns and
brute force confirms, also when rows retire out of order; engines that do
not declare ``caps.streaming`` refuse with the typed
``StreamingUnsupported``.  Each test names the ``repro`` function it holds
the port against.  Distances at rtol 1e-5 (the reference's own tests use
1e-4), indices up to ties.
"""

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro_torch.api import (
    IndexSpec,
    KNNIndex,
    StreamingUnsupported,
    available_engines,
    knn_brute,
)
from repro_torch.core.lazysearch import FP32_OVERFETCH

CPUS = (torch.device("cpu"),)
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _collect(index, q, k):
    """Drive query_stream, recording every emission."""
    emitted = {}
    order = []

    def on_complete(rows, dists, idx):
        assert rows.ndim == 1 and dists.shape == (rows.size, k) == idx.shape
        for j, r in enumerate(rows):
            assert int(r) not in emitted, f"row {r} emitted twice"
            emitted[int(r)] = (dists[j].copy(), idx[j].copy())
        order.append(rows.copy())

    res = index.query_stream(q, k, on_complete=on_complete)
    return res, emitted, order


def test_each_row_emitted_exactly_once_and_exact():
    """``repro.api.KNNIndex.query_stream``'s contract: each row once, equal
    to brute force and to the returned batch."""
    pts, q = _data(4000, 300, 8, seed=7)
    index = KNNIndex.build(
        pts, spec=IndexSpec(engine="streaming", height=4, k_hint=10, devices=CPUS))
    res, emitted, _ = _collect(index, q, k=10)
    assert sorted(emitted) == list(range(q.shape[0]))
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    for r, (d, i) in emitted.items():
        np.testing.assert_allclose(d, bd[r], **TOL)
        np.testing.assert_array_equal(d, res.dists[r])
        np.testing.assert_array_equal(i, res.idx[r])
    np.testing.assert_allclose(res.dists, bd, **TOL)
    assert (res.idx == bi).mean() > 0.999
    assert res.engine == index.engine_name == "streaming"
    batch = index.query(q, 10)
    np.testing.assert_array_equal(batch.dists, res.dists)
    np.testing.assert_array_equal(batch.idx, res.idx)


def test_multi_emission_out_of_order_as_the_reference():
    """Rows retire across many rounds, out of submission order, in the
    emissions of ``repro.api.KNNIndex.query_stream`` on the same index (up
    to a row whose pruning radius sits within an ulp of a split: the two
    packages sum distances in different orders)."""
    pts, q = _data(20_000, 512, 8, seed=11)
    kw = dict(engine="streaming", height=7, n_chunks=2, k_hint=10)
    index = KNNIndex.build(pts, spec=IndexSpec(devices=CPUS, **kw))
    res, emitted, order = _collect(index, q, k=10)
    assert sorted(emitted) == list(range(q.shape[0]))
    assert len(order) > 1, "stream degenerated into one final dump"
    assert res.stats.early_retired > 0
    flat = np.concatenate(order)
    assert not np.array_equal(flat, np.sort(flat))
    # the port's fp32 engine selects FP32_OVERFETCH candidates beyond k
    # (ROADMAP Queue 3): the reference streams at that width, and every
    # row is proven by the port's first pass here
    assert (res.stats.refined_rows, res.stats.exact_rows) == (0, 0)
    ref = jax_api.KNNIndex.build(pts, spec=jax_api.IndexSpec(**kw))
    ref_res, ref_emitted, ref_order = _collect(ref, q, k=10 + FP32_OVERFETCH)

    def emission_of(groups):
        at = np.empty(q.shape[0], np.int64)
        for e, rows in enumerate(groups):
            at[rows] = e
        return at

    assert (emission_of(order) == emission_of(ref_order)).mean() > 0.99
    assert abs(len(order) - len(ref_order)) <= 2
    assert res.stats.early_retired == ref_res.stats.early_retired
    np.testing.assert_allclose(res.dists, ref_res.dists[:, :10], **TOL)
    assert (res.idx == ref_res.idx[:, :10]).mean() > 0.999


def test_streaming_caps_declared():
    """The registry declares one streaming engine, as ``repro.api``'s does."""
    caps = available_engines()
    assert caps["streaming"].streaming and caps["streaming"].exact
    assert [n for n, c in caps.items() if c.streaming] == ["streaming"]
    ref = jax_api.available_engines()
    assert (caps["streaming"].out_of_core, caps["streaming"].stateful_query) == (
        ref["streaming"].out_of_core, ref["streaming"].stateful_query)


def test_non_streaming_engine_raises_typed_error():
    pts, q = _data(600, 8, 6, seed=3)
    index = KNNIndex.build(pts, spec=IndexSpec(engine="chunked", height=2, devices=CPUS))
    with pytest.raises(StreamingUnsupported, match="streaming"):
        index.query_stream(q, 3, on_complete=lambda *a: None)
    assert issubclass(StreamingUnsupported, TypeError)


def test_stream_stats_match_batch_contract():
    """Stats of a stream against ``repro.api.KNNIndex.query_stream``'s: the
    same rounds and units, and the facade exposes the last stream's stats."""
    pts, q = _data(3000, 100, 5, seed=5)
    kw = dict(engine="streaming", height=3, k_hint=7)
    index = KNNIndex.build(pts, spec=IndexSpec(devices=CPUS, **kw))
    res, _, _ = _collect(index, q, k=7)
    st = res.stats
    assert st.iterations > 0 and st.units_scanned > 0
    assert index.stats is st
    # the reference at the port's fp32 engine width (k + FP32_OVERFETCH);
    # every row is proven by the port's first pass here
    assert (st.refined_rows, st.exact_rows) == (0, 0)
    ref_res, _, _ = _collect(jax_api.KNNIndex.build(pts, spec=jax_api.IndexSpec(**kw)),
                             q, k=7 + FP32_OVERFETCH)
    for f in ("iterations", "chunk_rounds", "compactions", "early_retired"):
        assert getattr(st, f) == getattr(ref_res.stats, f), f
    batch = index.query(q, 7)
    assert batch.stats.iterations == st.iterations
    assert batch.stats.early_retired == 0


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_streaming_quantized_rows_bit_exact(precision):
    """``tests/test_quantized.py::test_streaming_rows_bit_exact`` on the
    port: every emitted row's indices equal brute force."""
    pts, q = _data(5000, 32, 7, seed=13)
    index = KNNIndex.build(pts, spec=IndexSpec(engine="streaming", precision=precision,
                                               devices=CPUS))
    res, emitted, _ = _collect(index, q, k=8)
    bd, bi = knn_brute(q, pts, 8, device="cpu")
    assert sorted(emitted) == list(range(len(q)))
    np.testing.assert_array_equal(res.idx, bi)
    for r, (d, i) in emitted.items():
        np.testing.assert_array_equal(i, bi[r])
        np.testing.assert_allclose(d, bd[r], **TOL)


def test_emit_exception_aborts_and_leaves_the_index_exact():
    """The abort contract of ``repro.core.streaming.stream_query``: an
    exception from the callback propagates, and the next query is exact."""
    pts, q = _data(4000, 200, 6, seed=17)
    index = KNNIndex.build(pts, spec=IndexSpec(engine="streaming", height=5, devices=CPUS))

    def boom(rows, dists, idx):
        raise RuntimeError("consumer failed")

    with pytest.raises(RuntimeError, match="consumer failed"):
        index.query_stream(q, 5, on_complete=boom)
    res, emitted, _ = _collect(index, q, k=5)
    bd, _ = knn_brute(q, pts, 5, device="cpu")
    assert sorted(emitted) == list(range(len(q)))
    np.testing.assert_allclose(res.dists, bd, **TOL)
