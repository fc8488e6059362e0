"""repro_torch's host loop (``engine="host"``), ``kdtree`` baseline and
work plans vs the JAX reference, on the CPU.

The same numpy points and queries go through ``repro`` and the port.  Ids
must be equal up to ties (a tie may permute two equidistant neighbours)
and distances agree within rtol 1e-5 / atol 1e-6; each test names the
``repro`` function it holds the port against.  Also here: the rows with no
finite neighbour (a NaN or a 1e20 coordinate) on every ported engine.
"""

import functools

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core import buffers as jax_buffers
from repro.core.hostkdtree import knn_host_kdtree as jax_knn_host_kdtree
from repro.core.lazysearch import BufferKDTree as JaxBufferKDTree
from repro.core.toptree import build_top_tree as jax_build_top_tree
from repro_torch.api import IndexSpec, KNNIndex, knn_brute, plan
from repro_torch.core import buffers, dualtree
from repro_torch.core.hostkdtree import knn_host_kdtree
from repro_torch.core.lazysearch import PLAN_LADDER, BufferKDTree
from repro_torch.core.toptree import build_top_tree

CPU = torch.device("cpu")
CPUS = (CPU,)
TOL = dict(rtol=1e-5, atol=1e-6)

# (n, m, d, k, height): tests/test_api.py PARITY_SHAPES
PARITY_SHAPES = [
    pytest.param(4000, 300, 8, 10, 4, id="baseline"),
    pytest.param(700, 64, 4, 12, 6, id="k_gt_leaf"),
    pytest.param(2500, 128, 5, 7, 3, id="d_odd"),
    pytest.param(3000, 17, 8, 5, 4, id="m_lt_tile"),
]


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference(engine, n, m, d, k, height, n_chunks, precision):
    pts, q = _data(n, m, d, seed=n + m)
    spec = jax_api.IndexSpec(engine=engine, height=height, k_hint=k, tile_q=64,
                             n_chunks=n_chunks, precision=precision)
    res = jax_api.KNNIndex.build(pts, spec=spec).query(q, k=k)
    return res.dists, res.idx


def _assert_matches(res, ref_d, ref_i, pts, q, k):
    """The port exact against knn_brute; its ids equal the reference's up to
    ties where the reference is exact (its quantized overfetch can miss,
    ROADMAP Queue 3)."""
    bd, _ = knn_brute(q, pts, k, device="cpu")
    np.testing.assert_allclose(res.dists, bd, **TOL)
    d_of_idx = np.sqrt(np.sum((q[:, None, :] - pts[res.idx]) ** 2, -1))
    np.testing.assert_allclose(d_of_idx, bd, **TOL)
    ref_exact = np.isclose(ref_d, bd, **TOL).all(1)
    assert ref_exact.mean() > 0.99
    np.testing.assert_allclose(res.dists[ref_exact], ref_d[ref_exact], **TOL)
    assert (res.idx[ref_exact] == ref_i[ref_exact]).mean() > 0.999
    assert res.idx.dtype == np.int64


# ---------------------------------------------------------------------------
# core/buffers.py against repro.core.buffers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tq", [1, 7, 64, 128])
def test_work_plan_matches_reference(tq):
    """``repro.core.buffers.build_work_plan`` on the same (leaf, query)
    pairs: the plans are equal."""
    rng = np.random.default_rng(tq)
    leaf = rng.integers(0, 40, size=3000).astype(np.int32)
    query = rng.permutation(3000).astype(np.int32)
    port = buffers.build_work_plan(leaf, query, tq)
    ref = jax_buffers.build_work_plan(leaf, query, tq)
    np.testing.assert_array_equal(port.unit_leaf, ref.unit_leaf)
    np.testing.assert_array_equal(port.unit_query, ref.unit_query)
    assert port.n_units == ref.n_units
    empty = buffers.build_work_plan(leaf[:0], query[:0], tq)
    assert empty.n_units == 0 and empty.unit_query.shape == (0, tq)
    with pytest.raises(ValueError):
        buffers.build_work_plan(leaf, query[:5], tq)


def test_queues_and_buffers_match_reference():
    """``repro.core.buffers.QueryQueues`` / ``LeafBuffers``: the same
    fetch order (reinsert first), fill counts and B/2 flush decisions."""
    pq, rq = buffers.QueryQueues(50), jax_buffers.QueryQueues(50)
    pb, rb = buffers.LeafBuffers(8, 6), jax_buffers.LeafBuffers(8, 6)
    rng = np.random.default_rng(3)
    for step in range(12):
        a, b = pq.fetch(7), rq.fetch(7)
        np.testing.assert_array_equal(a, b)
        leaf = rng.integers(0, 8, size=a.size).astype(np.int32)
        pb.insert(leaf, a)
        rb.insert(leaf, b)
        assert (pb.total, pb.max_fill) == (rb.total, rb.max_fill)
        force = step % 4 == 3
        assert pb.should_flush(force) == rb.should_flush(force)
        if pb.should_flush(force):
            pl, pqs = pb.drain()
            rl, rqs = rb.drain()
            np.testing.assert_array_equal(pl, rl)
            np.testing.assert_array_equal(pqs, rqs)
            pq.push_reinsert(pqs[::2])
            rq.push_reinsert(rqs[::2])
        assert len(pq) == len(rq) and pq.empty == rq.empty


# ---------------------------------------------------------------------------
# core/hostkdtree.py and the kdtree engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_host_kdtree_matches_reference(n, m, d, k, height):
    """``repro.core.hostkdtree.knn_host_kdtree`` on the same tree."""
    pts, q = _data(n, m, d, seed=n + m)
    pd, pi = knn_host_kdtree(q, build_top_tree(pts, height), k)
    rd, ri = jax_knn_host_kdtree(q, jax_build_top_tree(pts, height), k)
    np.testing.assert_allclose(pd, rd, **TOL)
    np.testing.assert_array_equal(pi, ri)


@pytest.mark.parametrize("precision", ["fp32", "int8", "fp16"])
@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_kdtree_engine_matches_reference(n, m, d, k, height, n_chunks, precision):
    """``repro.api.KNNIndex(engine="kdtree")``: the paper's CPU baseline,
    host numpy with nothing on a device, so a precision or chunk count
    asked for changes nothing (the planner keeps fp32, as the
    reference's)."""
    pts, q = _data(n, m, d, seed=n + m)
    ref_d, ref_i = _reference("kdtree", n, m, d, k, height, n_chunks, precision)
    index = KNNIndex.build(pts, IndexSpec(engine="kdtree", height=height, k_hint=k,
                                          tile_q=64, n_chunks=n_chunks,
                                          precision=precision, devices=CPUS))
    res = index.query(q, k)
    _assert_matches(res, ref_d, ref_i, pts, q, k)
    assert index.resident_bytes() == 0 and res.engine == "kdtree"
    assert index.plan.precision == "fp32"


# ---------------------------------------------------------------------------
# the host loop and the host engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "int8", "fp16"])
@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_host_engine_matches_reference(n, m, d, k, height, n_chunks, precision):
    """``repro.api.KNNIndex(engine="host")`` at each precision, resident
    (N = 1) and streamed in N = 3 chunks."""
    pts, q = _data(n, m, d, seed=n + m)
    ref_d, ref_i = _reference("host", n, m, d, k, height, n_chunks, precision)
    index = KNNIndex.build(pts, IndexSpec(engine="host", height=height, k_hint=k,
                                          tile_q=64, n_chunks=n_chunks,
                                          precision=precision, devices=CPUS))
    res = index.query(q, k)
    _assert_matches(res, ref_d, ref_i, pts, q, k)
    st = res.stats
    assert index.plan.engine == "host" and index.plan.precision == precision
    assert st.iterations > 0 and st.flushes > 0 and st.units_scanned > 0
    assert st.chunk_rounds >= st.flushes and st.plan_shapes >= 1
    assert (st.chunk_copies > 0) == (n_chunks > 1)


@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_host_loop_counters_match_reference(n, m, d, k, height, n_chunks):
    """At the reference's k (fp32 runs at k there), the loop takes the
    reference's steps: ``repro.core.lazysearch.BufferKDTree(engine="host")``
    iterations, flushes, units, chunk rounds, queries advanced and plan
    shapes equal, and the same candidates after the exact re-rank."""
    pts, q = _data(n, m, d, seed=n + m)
    ref = JaxBufferKDTree(pts, height=height, engine="host", tile_q=64, n_chunks=n_chunks)
    ref_d, ref_i = ref.query(q, k)
    port = BufferKDTree(pts, height=height, engine="host", tile_q=64, n_chunks=n_chunks,
                        device=CPU)
    d2, gi, info = port._engine.run(torch.from_numpy(q), k, 64, port.buffer_size)
    rs = ref.stats
    assert (info["iterations"], info["flushes"], info["units"], info["chunk_rounds"],
            info["queries_advanced"], info["plan_shapes"]) == (
        rs.iterations, rs.flushes, rs.units_scanned, rs.chunk_rounds,
        rs.queries_advanced, rs.plan_shapes)
    from repro_torch.core.lazysearch import finalize_candidates

    dists, idx = finalize_candidates(port.tree, q, gi)
    np.testing.assert_allclose(dists, ref_d, **TOL)
    assert (idx == ref_i).mean() > 0.999


def test_host_out_of_core_under_a_budget():
    """A ``memory_budget`` streams the host tier in N = 3 chunks, as the
    reference plans it (rule 5), and the answers stay exact."""
    pts, q = _data(20000, 200, 8, seed=5)
    slab = plan(20000, 8, engine="host", height=6, devices=CPUS).slab_bytes
    spec = IndexSpec(engine="host", height=6, precision="fp32", memory_budget=slab * 3 // 4,
                     devices=CPUS)
    index = KNNIndex.build(pts, spec)
    ref = jax_api.plan(20000, 8, engine="host", height=6, precision="fp32",
                       memory_budget=slab * 3 // 4)
    assert index.plan.n_chunks == ref.n_chunks == 3
    res = index.query(q, 10)
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    np.testing.assert_allclose(res.dists, bd, **TOL)
    np.testing.assert_array_equal(res.idx, bi)
    assert res.stats.chunk_copies > 0 and res.stats.chunk_rounds > res.stats.flushes


@pytest.mark.parametrize("kw", [
    dict(n=200_000, d=8, memory_budget=4 << 20),
    dict(n=200_000, d=8, memory_budget=4 << 20, precision="fp32"),
    dict(n=200_000, d=16, memory_budget=1 << 20, precision="fp16"),
    dict(n=50_000, d=8),
])
@pytest.mark.parametrize("engine", ["host", "kdtree"])
def test_planner_takes_pinned_host_and_kdtree_as_the_reference(engine, kw):
    """``repro.api.plan`` for a pinned ``host`` (precision rule 4, chunk
    rule 5) and ``kdtree`` (fp32 arrays, no chunks); neither is ever picked
    automatically."""
    import jax

    port = plan(devices=CPUS, engine=engine, **kw)
    ref = jax_api.plan(devices=jax.devices()[:1], engine=engine, **kw)
    for f in ("engine", "height", "buffer_size", "fetch_m", "n_chunks", "precision",
              "over_budget"):
        assert getattr(port, f) == getattr(ref, f), f
    auto = {k: v for k, v in kw.items()}
    assert plan(devices=CPUS, **auto).engine not in ("host", "kdtree")


def test_host_dual_ops_against_the_oracles():
    """The host engine's radius, kde and pair_count (``BufferKDTree.
    dualtree``) against the port's all-pairs oracles, on clustered data."""
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(3000, 3)) * 0.3 + rng.integers(0, 3, size=(3000, 1))
           ).astype(np.float32)
    q = pts[rng.integers(0, 3000, 150)] + np.float32(0.01)
    index = KNNIndex.build(pts, IndexSpec(engine="host", op="radius", height=5, devices=CPUS))
    ip, ix, dd = index.radius(q, 0.2)
    bi, bj, bd = dualtree.radius_brute(q, pts, 0.2, device="cpu")
    np.testing.assert_array_equal(ip, bi)
    for i in range(q.shape[0]):
        assert set(ix[ip[i]:ip[i + 1]].tolist()) == set(bj[bi[i]:bi[i + 1]].tolist())
    np.testing.assert_array_equal(dd, bd)
    dens, err = index.kde(q, 0.3, rtol=1e-2)
    exact = dualtree.kde_brute(q, pts, 0.3, device="cpu").astype(np.float64)
    assert np.all(np.abs(dens - exact) <= 1e-2 * exact + 1e-9 + 1e-5 * np.maximum(exact, 1))
    top, _ = index.kde(q, 0.25, kernel="tophat")
    np.testing.assert_array_equal(
        top, dualtree.kde_brute(q, pts, 0.25, kernel="tophat", device="cpu"))
    edges = np.array([0.0, 0.05, 0.1, 0.3, 1.0])
    hist, _ = index.pair_count(edges)
    np.testing.assert_array_equal(hist, dualtree.pair_count_brute(pts, edges, device="cpu"))


def test_plan_ladder_is_the_reference():
    from repro.core.lazysearch import PLAN_LADDER as JAX_PLAN_LADDER

    assert PLAN_LADDER == JAX_PLAN_LADDER


# ---------------------------------------------------------------------------
# repair: rows with no finite neighbour keep id -1 on every engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["brute", "kdtree", "host", "chunked", "streaming", "jit"])
def test_rows_without_a_finite_neighbour_get_minus_one(engine):
    """A query with a NaN coordinate, or one whose distances overflow fp32
    (a coordinate of 1e20), has no finite neighbour: ``repro.api.KNNIndex
    (engine="brute")`` answers id -1 at +inf, and so does every ported
    engine (the rows fall to brute force after the certificate; the port
    no longer maps brute force's -1 through ``orig_idx``).  The other rows
    keep their exact answers."""
    pts, q = _data(3576, 40, 4, seed=11)
    q[3, 2] = np.nan
    q[7, 0] = 1e20
    q[9] = [1e20, -1e20, 1e20, 0.0]
    ref = jax_api.KNNIndex.build(pts, jax_api.IndexSpec(engine="brute")).query(q, 3)
    index = KNNIndex.build(pts, IndexSpec(engine=engine, height=3, devices=CPUS))
    res = index.query(q, 3)
    bad = [3, 7, 9]
    assert (ref.idx[bad] == -1).all() and np.isinf(ref.dists[bad]).all()
    np.testing.assert_array_equal(res.idx[bad], ref.idx[bad])
    np.testing.assert_array_equal(res.dists[bad], ref.dists[bad])
    good = np.setdiff1d(np.arange(40), bad)
    np.testing.assert_allclose(res.dists[good], ref.dists[good], **TOL)
    np.testing.assert_array_equal(res.idx[good], ref.idx[good])


@pytest.mark.parametrize("engine", ["brute", "kdtree", "host", "chunked", "streaming", "jit"])
def test_immutable_engines_refuse_mutation(engine):
    """``insert`` / ``delete`` on an engine without ``caps.mutable`` raise
    the reference's ``MutabilityError`` (a ``TypeError``), as
    ``repro.api.KNNIndex`` does, and change nothing."""
    from repro_torch.api import MutabilityError

    pts = np.random.default_rng(3).normal(size=(300, 3)).astype(np.float32)
    index = KNNIndex.build(pts, IndexSpec(engine=engine, height=2, devices=CPUS))
    ref = jax_api.KNNIndex.build(pts, jax_api.IndexSpec(engine=engine, height=2))
    for idx, err in ((index, MutabilityError), (ref, jax_api.MutabilityError)):
        with pytest.raises(err, match="immutable"):
            idx.insert(np.zeros((2, 3), np.float32))
        with pytest.raises(err, match="immutable"):
            idx.delete([0])
    assert index.n == 300 and issubclass(MutabilityError, TypeError)
