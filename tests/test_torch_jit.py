"""repro_torch's device-resident fixed point (``core/jitsearch.py``) and the
``jit`` engine vs the JAX reference, on the CPU.

Mirrors ``tests/test_jitsearch_chunked.py``'s ``lazy_knn_jit`` cases: the
same numpy points and queries go through ``repro.core.jitsearch.lazy_knn_jit``
and the port's, and the rounds, the answers and the partial states after
``max_rounds`` are held against each other.  Indices equal up to ties
(at most one in a thousand positions may differ, each at an equal
distance); distances at rtol 1e-5 / atol 1e-6 (the reference pads features
to a multiple of 8 and sums the rescoring in another order).  On the CPU
the round runs eagerly; the captured CUDA graph is held against the eager
round in ``tests/test_torch_cuda.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core.jitsearch import lazy_knn_jit as jax_lazy_knn_jit
from repro.core.jitsearch import tree_arrays_from as jax_tree_arrays_from
from repro.core.toptree import build_top_tree as jax_build_top_tree
from repro_torch.api import IndexSpec, KNNIndex, available_engines, get_engine, knn_brute, plan
from repro_torch.core.jitsearch import (
    CACHED_SHAPES, JitRounds, RoundsCache, lazy_knn_jit, tree_arrays_from,
)
from repro_torch.core.lazysearch import FP32_OVERFETCH
from repro_torch.core.toptree import build_top_tree

CPU = torch.device("cpu")
CPUS = (CPU,)
TOL = dict(rtol=1e-5, atol=1e-6)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference(n, m, d, height, k, tq, max_rounds, seed, leaf_pad_multiple=8):
    pts, q = _data(n, m, d, seed)
    tree = jax_build_top_tree(pts, height, leaf_pad_multiple=leaf_pad_multiple)
    ta = jax_tree_arrays_from(tree)
    qpad = np.zeros((m, ta.slabs.shape[-1]), np.float32)
    qpad[:, :d] = q
    d2, oi, rounds = jax_lazy_knn_jit(
        jnp.asarray(qpad), ta, k=k, tq=tq, first_leaf_heap=tree.first_leaf_heap,
        max_rounds=max_rounds,
    )
    return np.asarray(d2), np.asarray(oi), int(rounds)


def _port(n, m, d, height, k, tq, max_rounds, seed, **kw):
    pts, q = _data(n, m, d, seed)
    tree = build_top_tree(pts, height)
    ta = tree_arrays_from(tree, CPU)
    d2, oi, rounds = lazy_knn_jit(
        torch.from_numpy(q), ta, k=k, tq=tq, first_leaf_heap=tree.first_leaf_heap,
        max_rounds=max_rounds, **kw,
    )
    return d2.numpy(), oi.numpy(), rounds


def _same_up_to_ties(d2, oi, ref_d2, ref_oi):
    np.testing.assert_allclose(d2, ref_d2, **TOL)
    assert oi.dtype == np.int64
    assert (oi == ref_oi).mean() > 0.999


# (n, m, d, height, k, tq): the reference test's shapes, then an odd width
# with a long list, and a query batch narrower than one tile
SHAPES = [
    pytest.param(8192, 512, 8, 5, 10, 64, id="exact_vs_brute"),
    pytest.param(4096, 128, 6, 4, 5, 32, id="max_rounds_shape"),
    pytest.param(3000, 200, 5, 6, 30, 16, id="k30"),
    pytest.param(2000, 9, 3, 3, 4, 16, id="m_lt_tile"),
]


@pytest.mark.parametrize("n,m,d,height,k,tq", SHAPES)
def test_fixed_point_matches_reference(n, m, d, height, k, tq):
    """``repro.core.jitsearch.lazy_knn_jit`` run to its fixed point: the
    same rounds, the same answers; and exact against brute force."""
    ref_d2, ref_oi, ref_rounds = _reference(n, m, d, height, k, tq, 0, n)
    d2, oi, rounds = _port(n, m, d, height, k, tq, 0, n)
    assert rounds == ref_rounds and rounds > 1
    _same_up_to_ties(d2, oi, ref_d2, ref_oi)
    pts, q = _data(n, m, d, n)
    bd, bi = knn_brute(q, pts, k, device="cpu")
    np.testing.assert_allclose(np.sqrt(np.maximum(d2, 0)), bd, rtol=1e-4, atol=1e-4)
    assert (oi == bi).mean() > 0.999


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_max_rounds_partial_states_match_reference(max_rounds):
    """``tests/test_jitsearch_chunked.py::test_max_rounds_partial`` on the
    port, held against the reference's partial state after each count."""
    args = (4096, 128, 6, 4, 5, 32, max_rounds, 2)
    ref_d2, ref_oi, ref_rounds = _reference(*args)
    d2, oi, rounds = _port(*args)
    assert rounds == ref_rounds == max_rounds
    _same_up_to_ties(d2, oi, ref_d2, ref_oi)
    if max_rounds == 1:
        # after one round every query has visited exactly its home leaf:
        # candidates are valid but maybe not optimal
        assert (oi[:, 0] >= 0).all()


def test_rounds_past_the_fixed_point_change_nothing():
    """A round on a state where every query has finished leaves it as it
    is (``advance``, the empty plan, the merge's dump row, ``exit_leaf``),
    and ``rounds`` counts only rounds with a live query: replays in blocks
    give the reference's count."""
    pts, q = _data(3000, 100, 4, seed=5)
    tree = build_top_tree(pts, 4)
    ta = tree_arrays_from(tree, CPU)
    r = JitRounds(ta, 100, 6, tq=16, first_leaf_heap=tree.first_leaf_heap)
    r.run(torch.from_numpy(q))
    before = [t.clone() for t in (r.node, r.fromc, r.knn_d[:100], r.knn_i[:100], r.rounds)]
    assert not bool(r.live) and (r.node == 0).all()
    for _ in range(3):
        r.round()
    after = (r.node, r.fromc, r.knn_d[:100], r.knn_i[:100], r.rounds)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    blocks = JitRounds(ta, 100, 6, tq=16, first_leaf_heap=tree.first_leaf_heap,
                       sync_every=8)
    executed = blocks.run(torch.from_numpy(q))
    assert executed % 8 == 0 and executed >= int(r.rounds)
    assert int(blocks.rounds) == int(r.rounds)
    assert torch.equal(blocks.knn_d[:100], r.knn_d[:100])
    assert torch.equal(blocks.knn_i[:100], r.knn_i[:100])


def test_cache_reuses_the_batch_state():
    """``lazy_knn_jit(cache=)`` keeps one ``JitRounds`` per (m, k) and the
    second call gives the first call's answers."""
    pts, q = _data(2000, 64, 5, seed=6)
    tree = build_top_tree(pts, 3)
    ta = tree_arrays_from(tree, CPU)
    cache = {}
    kw = dict(k=7, tq=16, first_leaf_heap=tree.first_leaf_heap, cache=cache)
    a = lazy_knn_jit(torch.from_numpy(q), ta, **kw)
    held = cache[(64, 7)]
    b = lazy_knn_jit(torch.from_numpy(q), ta, **kw)
    assert list(cache) == [(64, 7)] and cache[(64, 7)] is held
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


def test_rounds_cache_keeps_the_latest_shapes():
    """A ``RoundsCache`` keeps the ``CACHED_SHAPES`` batch shapes used last
    (4: 50 and 40 are evicted, 64 was used again), the answers do not
    depend on what it evicted, and the jit engine's cache is one."""
    assert CACHED_SHAPES == 4
    pts, q = _data(2000, 64, 5, seed=7)
    tree = build_top_tree(pts, 3)
    ta = tree_arrays_from(tree, CPU)
    cache = RoundsCache()
    kw = dict(k=7, tq=16, first_leaf_heap=tree.first_leaf_heap)
    for m in (64, 50, 40, 30, 64, 20, 10):
        got = lazy_knn_jit(torch.from_numpy(q[:m]), ta, cache=cache, **kw)
        fresh = lazy_knn_jit(torch.from_numpy(q[:m]), ta, **kw)
        assert torch.equal(got[0], fresh[0]) and torch.equal(got[1], fresh[1])
        assert got[2] == fresh[2]
    assert list(cache) == [(30, 7), (64, 7), (20, 7), (10, 7)]

    index = KNNIndex.build(pts, IndexSpec(engine="jit", height=3, devices=CPUS))
    for m in range(20, 20 + 2 * CACHED_SHAPES):
        res = index.query(q[:m], 5)
        bd, _ = knn_brute(q[:m], pts, 5, device="cpu")
        np.testing.assert_allclose(res.dists, bd, **TOL)
    assert len(index._state.rounds) == CACHED_SHAPES


# (n, m, d, k, height): tests/test_api.py PARITY_SHAPES
PARITY_SHAPES = [
    pytest.param(4000, 300, 8, 10, 4, id="baseline"),
    pytest.param(700, 64, 4, 12, 6, id="k_gt_leaf"),
    pytest.param(2500, 128, 5, 7, 3, id="d_odd"),
    pytest.param(3000, 17, 8, 5, 4, id="m_lt_tile"),
]


@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_jit_engine_matches_reference(n, m, d, k, height):
    """``KNNIndex`` with ``engine="jit"`` against ``repro.api.KNNIndex``'s
    jit engine.  The port selects ``FP32_OVERFETCH`` candidates beyond k
    (ROADMAP Queue 3), so the reference runs at that width for the round
    count, and its first k columns are the answer.  Where that width is
    longer than the reference's leaf slab (it scans at most L_pad rows per
    leaf), the reference's fixed point runs on slabs padded to the width:
    pad rows are never ranked ahead of points, and the traversal does not
    read them."""
    pts, q = _data(n, m, d, seed=n + m)
    spec = dict(engine="jit", height=height, k_hint=k, tile_q=64)
    index = KNNIndex.build(pts, IndexSpec(devices=CPUS, **spec))
    res = index.query(q, k)
    k_eff = min(k + FP32_OVERFETCH, n)
    if k_eff <= jax_build_top_tree(pts, height).leaf_pad:
        ref = jax_api.KNNIndex.build(pts, spec=jax_api.IndexSpec(**spec)).query(q, k_eff)
        ref_d, ref_i, ref_rounds = ref.dists, ref.idx, ref.stats.iterations
    else:
        ref_d2, ref_i, ref_rounds = _reference(n, m, d, height, k_eff, 64, 0, n + m,
                                               leaf_pad_multiple=-(-k_eff // 8) * 8)
        ref_d = np.sqrt(np.maximum(ref_d2, 0.0))
    np.testing.assert_allclose(res.dists, ref_d[:, :k], **TOL)
    assert (res.idx == ref_i[:, :k]).mean() > 0.999
    assert res.stats.iterations == ref_rounds
    assert res.stats.exact_rows == 0
    bd, bi = knn_brute(q, pts, k, device="cpu")
    np.testing.assert_allclose(res.dists, bd, **TOL)
    assert res.engine == index.engine_name == "jit"


def test_jit_engine_is_registered_and_pinned_only():
    """The registry lists ``jit`` with the reference's capabilities; the
    planner takes it only when pinned, and it declares knn only."""
    caps = available_engines()["jit"]
    ref = jax_api.available_engines()["jit"]
    assert (caps.exact, caps.out_of_core, caps.multi_device) == (
        ref.exact, ref.out_of_core, ref.multi_device)
    assert caps.ops == ref.ops == frozenset({"knn"})
    for kw in (dict(n=200_000, d=10), dict(n=1000, d=3), dict(n=50_000, d=8, m=10)):
        assert plan(devices=CPUS, **kw).engine != "jit"
    assert plan(50_000, 8, devices=CPUS, engine="jit").engine == "jit"
    # its snapshot is the reference's TreeArrays and restores the same tree
    pts, _ = _data(700, 1, 5, seed=2)
    index = KNNIndex.build(pts, IndexSpec(engine="jit", height=3, devices=CPUS))
    arrays, meta = get_engine("jit").snapshot_state(index._state)
    ref = jax_tree_arrays_from(jax_build_top_tree(pts, 3))
    for name, value in ref._asdict().items():
        np.testing.assert_array_equal(arrays[f"tree/{name}"], np.asarray(value), name)
    back = get_engine("jit").restore_state(arrays, meta, index.spec, index.plan)
    for name, value in back.tree._asdict().items():
        assert torch.equal(value, getattr(index._state.tree, name)), name


def test_jit_warm_then_query():
    """``KNNIndex.warm`` runs one round of the batch shape (and, on a card,
    captures it); the query after it answers exactly."""
    pts, q = _data(3000, 50, 5, seed=1)
    index = KNNIndex.build(pts, IndexSpec(engine="jit", height=4, devices=CPUS))
    index.warm(50, 5)
    state = index._state
    assert list(state.rounds) == [(50, 5 + FP32_OVERFETCH)]
    res = index.query(q, 5)
    bd, bi = knn_brute(q, pts, 5, device="cpu")
    np.testing.assert_allclose(res.dists, bd, **TOL)
    np.testing.assert_array_equal(res.idx, bi)
