"""repro_torch's dual-tree ops (``core/dualtree.py``) vs the JAX reference.

Mirrors the 16 tests of ``tests/test_dualtree.py`` on the port, on the CPU.
The same numpy points go through ``repro.core.dualtree`` and the port's
module; each test names the ``repro`` function it holds the port against.
Fixtures are the reference's: integer-lattice points (every squared pair
distance an exact fp32 integer) with radii and histogram edges whose
squares are not integers, so radius and pair_count compare bit for bit;
kde is held to its declared contract ``|approx - exact| <= rtol*exact +
atol`` (plus fp32 slack).  The traversal's counters (levels, batches, leaf
pairs, points paired, chunk visits, batch shapes) must equal the
reference's on the same store layout.
"""

import numpy as np
import pytest
import torch

from repro.core.chunked import ChunkedLeafStore as JaxStore
from repro.core.dualtree import PAIR_RUNGS as JAX_PAIR_RUNGS
from repro.core.dualtree import DualTree as JaxDualTree
from repro.core.dualtree import kde_brute as jax_kde_brute
from repro.core.dualtree import node_bounds as jax_node_bounds
from repro.core.dualtree import pair_count_brute as jax_pair_count_brute
from repro.core.dualtree import radius_brute as jax_radius_brute
from repro.core.toptree import build_top_tree as jax_build_top_tree
from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.dualtree import (
    PAIR_RUNGS,
    QLEAF,
    QLEAF_RUNGS,
    DualTree,
    dualtree_cache_size,
    kde_brute,
    node_bounds,
    pair_count_brute,
    radius_brute,
)
from repro_torch.core.lazysearch import SearchStats
from repro_torch.core.toptree import build_top_tree

CPU = torch.device("cpu")

# non-integer-squared boundaries (see module doc)
EDGES = np.array([0.5, 3.5, 7.5, 11.5, 16.5, 25.5])
RADIUS = float(np.sqrt(7.5))

# the traversal counters both packages report
STAT_FIELDS = ("iterations", "flushes", "units_scanned", "points_scanned",
               "queries_advanced", "chunk_rounds", "plan_shapes")


def lattice(n, d, seed=0, span=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, span, size=(n, d)).astype(np.float32)


def clustered(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32)
    pts = centers[rng.integers(0, 8, n)] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    return pts.astype(np.float32)


def csr_rows_equal(ip_a, ix_a, ip_b, ix_b):
    """Same neighbor SETS per row; indptr must match exactly."""
    assert np.array_equal(ip_a, ip_b)
    for i in range(len(ip_a) - 1):
        assert set(ix_a[ip_a[i]:ip_a[i + 1]].tolist()) == set(
            ix_b[ip_b[i]:ip_b[i + 1]].tolist()
        ), f"row {i}"


def same_stats(a: SearchStats, b) -> None:
    for f in STAT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def _pad8(slabs):
    d = slabs.shape[-1]
    dp = max(8, -(-d // 8) * 8)
    if dp == d:
        return slabs
    pad = np.zeros(slabs.shape[:2] + (dp - d,), np.float32)
    return np.concatenate([slabs, pad], axis=-1)


def stores(pts, height):
    """The store variants every op must agree across — resident, chunked,
    and quantized (which forces DualTree's private fp32 store) — each with
    the reference's DualTree over the same layout (its slabs padded to a
    multiple of 8 features, the port's at width d)."""
    tree = build_top_tree(pts, height)
    jtree = jax_build_top_tree(pts, height)
    yield "resident", DualTree(tree, device=CPU), JaxDualTree(jtree)
    sizes = tree.leaf_sizes()
    slabs = tree.points_padded
    yield "chunked3", DualTree(
        tree, ChunkedLeafStore(slabs, n_chunks=3, uniform=True, leaf_sizes=sizes, device=CPU),
    ), JaxDualTree(jtree, JaxStore(_pad8(slabs), n_chunks=3, uniform=True, leaf_sizes=sizes))
    yield "quantized", DualTree(
        tree, ChunkedLeafStore(slabs, n_chunks=2, uniform=True, leaf_sizes=sizes,
                               precision="int8", device=CPU),
    ), JaxDualTree(jtree, JaxStore(_pad8(slabs), n_chunks=2, uniform=True,
                                   leaf_sizes=sizes, precision="int8"))


class TestNodeBounds:
    def test_boxes_match_brute_leaf_partition(self):
        """``repro.core.dualtree.node_bounds`` on the same tree: equal boxes
        and counts, leaves over their real rows, parents the union."""
        pts = lattice(500, 3, seed=1)
        tree = build_top_tree(pts, 4)
        b = node_bounds(tree)
        ref = jax_node_bounds(jax_build_top_tree(pts, 4))
        for f in ("lo", "hi", "count"):
            np.testing.assert_array_equal(getattr(b, f), getattr(ref, f))
        assert b.first_leaf == ref.first_leaf
        nl = tree.n_leaves
        sizes = tree.leaf_sizes()
        for j in range(nl):
            rows = tree.points_padded[j, : sizes[j], : tree.d]
            np.testing.assert_array_equal(b.lo[nl + j], rows.min(0))
            np.testing.assert_array_equal(b.hi[nl + j], rows.max(0))
        for v in range(nl - 1, 0, -1):
            np.testing.assert_array_equal(b.lo[v], np.minimum(b.lo[2 * v], b.lo[2 * v + 1]))
            assert b.count[v] == b.count[2 * v] + b.count[2 * v + 1]
        assert b.count[1] == 500


class TestRadius:
    @pytest.mark.parametrize("n,m,d,height", [(2000, 150, 3, 4), (700, 64, 5, 5)])
    def test_parity_all_store_variants(self, n, m, d, height):
        """``repro.core.dualtree.DualTree.radius`` per store variant: the
        reference oracle's rows, the reference traversal's counters."""
        pts = lattice(n, d, seed=n)
        q = lattice(m, d, seed=n + 1)
        bi, bj, bd = jax_radius_brute(q, pts, RADIUS)
        pi, pj, pd = radius_brute(q, pts, RADIUS, device=CPU)
        np.testing.assert_array_equal(pi, bi)
        np.testing.assert_array_equal(pd, bd)
        for name, dual, ref in stores(pts, height):
            ip, ix, dd, stats = dual.radius(q, RADIUS)
            csr_rows_equal(ip, ix, bi, bj)
            for i in range(m):
                row = dd[ip[i]:ip[i + 1]]
                assert np.all(np.diff(row) >= 0), (name, i)
            assert np.all(dd <= np.float32(RADIUS))
            rip, rix, rdd, rstats = ref.radius(q, RADIUS)
            np.testing.assert_array_equal(dd, rdd)
            same_stats(stats, rstats)
            assert stats.units_scanned > 0

    def test_prunes_vs_all_pairs(self):
        """Pruning keeps the all-pairs rows.  Near 1000 the decomposed form
        that ``repro.core.dualtree.radius_brute`` selects by rounds (|x|^2 ~
        3e6 carries steps of 0.25), where the direct form is exact on these
        quarter-integer differences: the rows are held against float64 and
        the port's ``radius_brute``; the traversal's counters against the
        reference's."""
        pts = np.concatenate([lattice(600, 3, seed=2), lattice(600, 3, seed=3) + 1000.0])
        q = pts[::10] + 0.25
        dual = DualTree(build_top_tree(pts, 5), device=CPU)
        ip, ix, dd, stats = dual.radius(q, RADIUS)
        total = dual.tree.n_leaves * -(-len(q) // 64)
        assert stats.units_scanned < total  # leaf pairs visited < full grid
        bi, bj, _ = radius_brute(q, pts, RADIUS, device=CPU)
        csr_rows_equal(ip, ix, bi, bj)
        d64 = np.sum((q[:, None, :].astype(np.float64) - pts[None]) ** 2, -1)
        assert np.array_equal(np.diff(bi), (d64 <= RADIUS ** 2).sum(1))
        _, _, _, rstats = JaxDualTree(jax_build_top_tree(pts, 5)).radius(q, RADIUS)
        same_stats(stats, rstats)

    def test_single_query_fallback(self):
        pts = lattice(300, 4, seed=4)
        dual = DualTree(build_top_tree(pts, 3), device=CPU)
        for q in (pts[:1] + 0.25, np.zeros((0, 4), np.float32)):
            ip, ix, dd, stats = dual.radius(q, RADIUS)
            bi, bj, _ = jax_radius_brute(q, pts, RADIUS)
            csr_rows_equal(ip, ix, bi, bj)

    def test_negative_radius_rejected(self):
        dual = DualTree(build_top_tree(lattice(64, 2), 2), device=CPU)
        with pytest.raises(ValueError):
            dual.radius(np.zeros((3, 2), np.float32), -1.0)


class TestKDE:
    @pytest.mark.parametrize("kernel", ["gaussian", "tophat"])
    def test_within_declared_tolerance(self, kernel):
        """The declared contract against ``repro.core.dualtree.kde_brute``,
        and the same accumulated error bound and counters as
        ``DualTree.kde`` (the prune decisions are the float64 frontier's)."""
        pts = clustered(3000, 3, seed=5)
        q = clustered(200, 3, seed=6)
        h, rtol, atol = 0.3, 1e-2, 1e-9
        exact = jax_kde_brute(q, pts, h, kernel=kernel).astype(np.float64)
        np.testing.assert_allclose(kde_brute(q, pts, h, kernel=kernel, device=CPU),
                                   exact, rtol=1e-6)
        for name, dual, ref in stores(pts, 4):
            dens, err, stats = dual.kde(q, h, rtol=rtol, atol=atol, kernel=kernel)
            bound = rtol * exact + atol + 1e-5 * np.maximum(exact, 1.0)
            assert np.all(np.abs(dens.astype(np.float64) - exact) <= bound), name
            assert err >= 0.0
            rdens, rerr, rstats = ref.kde(q, h, rtol=rtol, atol=atol, kernel=kernel)
            np.testing.assert_allclose(dens, rdens, rtol=1e-5, atol=1e-9)
            assert err == pytest.approx(rerr, rel=1e-12, abs=0.0)
            same_stats(stats, rstats)

    def test_tophat_exact_and_consistent_with_radius(self):
        pts = lattice(1500, 3, seed=7)
        q = lattice(100, 3, seed=8)
        dual = DualTree(build_top_tree(pts, 4), device=CPU)
        dens, err, _ = dual.kde(q, RADIUS, kernel="tophat")
        assert err == 0.0  # tophat prune is exact
        ip, _, _, _ = dual.radius(q, RADIUS)
        counts = np.diff(ip)
        np.testing.assert_allclose(dens, counts.astype(np.float32) / len(pts), rtol=1e-6)
        np.testing.assert_allclose(
            dens, jax_kde_brute(q, pts, RADIUS, kernel="tophat"), rtol=1e-6)

    def test_approximation_actually_prunes(self):
        pts = clustered(4000, 3, seed=9)
        q = clustered(256, 3, seed=10)
        dual = DualTree(build_top_tree(pts, 5), device=CPU)
        _, err_loose, s_loose = dual.kde(q, 0.1, rtol=0.3, atol=1e-6)
        _, _, s_tight = dual.kde(q, 0.1, rtol=1e-12, atol=0.0)
        assert s_loose.units_scanned < s_tight.units_scanned
        assert err_loose > 0.0
        ref = JaxDualTree(jax_build_top_tree(pts, 5))
        _, rerr, rs_loose = ref.kde(q, 0.1, rtol=0.3, atol=1e-6)
        same_stats(s_loose, rs_loose)
        assert err_loose == pytest.approx(rerr, rel=1e-12, abs=0.0)

    def test_bad_kernel_rejected(self):
        dual = DualTree(build_top_tree(lattice(64, 2), 2), device=CPU)
        with pytest.raises(ValueError):
            dual.kde(np.zeros((3, 2), np.float32), 1.0, kernel="sinc")


class TestPairCount:
    @pytest.mark.parametrize("n,d,height", [(1500, 3, 4), (900, 5, 5)])
    def test_parity_all_store_variants(self, n, d, height):
        """``repro.core.dualtree.pair_count_brute`` bit for bit, and the
        reference ``DualTree.pair_count``'s counters, per store variant."""
        pts = lattice(n, d, seed=n)
        ref_hist = jax_pair_count_brute(pts, EDGES)
        np.testing.assert_array_equal(pair_count_brute(pts, EDGES, device=CPU), ref_hist)
        for name, dual, ref in stores(pts, height):
            hist, stats = dual.pair_count(EDGES)
            assert np.array_equal(hist, ref_hist), name
            rhist, rstats = ref.pair_count(EDGES)
            assert np.array_equal(rhist, ref_hist)
            same_stats(stats, rstats)
            assert stats.units_scanned >= 0

    def test_matches_numpy_histogram_oracle(self):
        pts = lattice(800, 3, seed=11)
        diff = pts[:, None, :].astype(np.float64) - pts[None, :, :]
        dist = np.sqrt((diff * diff).sum(-1))
        mask = ~np.eye(len(pts), dtype=bool)
        ref, _ = np.histogram(dist[mask], bins=EDGES)
        hist, _ = DualTree(build_top_tree(pts, 4), device=CPU).pair_count(EDGES)
        assert np.array_equal(hist, ref.astype(np.int64))

    def test_zero_leading_edge_excludes_self_pairs(self):
        pts = lattice(500, 3, seed=12)
        edges = np.array([0.0, 3.5, 7.5, 16.5])
        diff = pts[:, None, :].astype(np.float64) - pts[None, :, :]
        dist = np.sqrt((diff * diff).sum(-1))
        mask = ~np.eye(len(pts), dtype=bool)
        ref, _ = np.histogram(dist[mask], bins=edges)
        hist, _ = DualTree(build_top_tree(pts, 4), device=CPU).pair_count(edges)
        assert np.array_equal(hist, ref.astype(np.int64))
        assert np.array_equal(pair_count_brute(pts, edges, device=CPU), ref)

    def test_total_count_conserved(self):
        pts = lattice(600, 4, seed=13, span=6)
        span_max = 4 * 6 * 6 * 4  # > any possible squared distance
        edges = np.array([0.0, 1.5, float(np.sqrt(span_max))])
        hist, _ = DualTree(build_top_tree(pts, 4), device=CPU).pair_count(edges)
        n = len(pts)
        assert hist.sum() == n * (n - 1)  # every ordered non-self pair

    def test_bad_edges_rejected(self):
        dual = DualTree(build_top_tree(lattice(64, 2), 2), device=CPU)
        for bad in ([1.0], [2.0, 1.0], [-1.0, 2.0]):
            with pytest.raises(ValueError):
                dual.pair_count(np.asarray(bad, np.float64))


class TestRecompileDiscipline:
    def test_warm_then_new_operands_no_compiles(self):
        """``repro.core.dualtree.dualtree_cache_size``'s contract on the
        port's count of distinct batch shapes: after ``warm``, new radii,
        bandwidths and edge values meet no new shape; another edge count is
        one new shape."""
        pts = lattice(2500, 3, seed=14)
        q = lattice(300, 3, seed=15)
        dual = DualTree(build_top_tree(pts, 4), device=CPU)
        dual.warm(("radius", "kde", "pair_count"), m=len(q), n_edges=len(EDGES))
        before = dualtree_cache_size()
        for r in (0.5, RADIUS, 9.0):
            dual.radius(q, r)
        for h in (0.4, 2.0):
            dual.kde(q, h)
            dual.kde(q, h, kernel="tophat")
        dual.pair_count(EDGES)
        dual.pair_count(EDGES * 2.0)
        assert dualtree_cache_size() == before
        dual.pair_count(np.array([0.5, 1.5, 2.5]))
        assert dualtree_cache_size() == before + 1

    def test_rungs_cover_pair_batches(self):
        assert tuple(sorted(PAIR_RUNGS)) == PAIR_RUNGS == JAX_PAIR_RUNGS
        assert PAIR_RUNGS[0] >= 1
        from repro.core import dualtree as jax_dualtree

        assert (QLEAF, QLEAF_RUNGS) == (jax_dualtree.QLEAF, jax_dualtree.QLEAF_RUNGS)


# -- the exactness target: the direct fp32 form ---------------------------
def _direct_d2_np(a, b):
    """sum_j (a_j - b_j)^2 in fp32, feature order (numpy, independent of
    the port's torch code)."""
    out = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for j in range(a.shape[1]):
        diff = (a[:, None, j] - b[None, :, j]).astype(np.float32)
        out = (out + diff * diff).astype(np.float32)
    return out


@pytest.mark.parametrize("engine", ["brute", "chunked", "streaming", "host"])
def test_one_twentieth_lattice_matches_the_direct_form(engine):
    """ROADMAP Queue 3 item 2's probe: 3000 points and 200 queries on a
    1/20 lattice in d = 3, where many pairs sit at r = 0.05 and at the bin
    edges, so fp32 rounding decides them.  radius sets, pair_count bins and
    tophat counts equal those of the direct fp32 form (213 radius pairs
    and 3078 ordered pairs in [0, 0.05) here; the decomposed form, which
    the parent selected by, gives 257 and 3970); the tree engines test
    the pairs in the rounding band again."""
    from repro_torch.api import IndexSpec, KNNIndex

    rng = np.random.default_rng(0)
    pts = (rng.integers(0, 20, (3000, 3)) / 20).astype(np.float32)
    q = (rng.integers(0, 20, (200, 3)) / 20).astype(np.float32)
    r, edges = 0.05, np.array([0.0, 0.05, 0.1, 0.2])
    t2 = np.float32(r * r)
    near = _direct_d2_np(q, pts) <= t2
    index = KNNIndex.build(pts, IndexSpec(engine=engine, op="pair_count", devices=(CPU,)))
    ip, ix, _ = res = index.radius(q, r)
    assert ip[-1] == near.sum() == 213
    csr_rows_equal(ip, ix, np.concatenate([[0], np.cumsum(near.sum(1))]),
                   np.nonzero(near)[1])
    e32 = edges.astype(np.float32)
    hist = np.zeros(3, np.int64)
    for lo in range(0, 3000, 500):
        dist = np.sqrt(_direct_d2_np(pts[lo:lo + 500], pts))
        b = np.searchsorted(e32, dist, side="right")
        b[dist == e32[-1]] = 3
        hist += np.bincount(b.ravel(), minlength=5)[1:4]
    hist[0] -= 3000   # the self-pairs, at 0
    got = index.pair_count(edges)
    np.testing.assert_array_equal(got.values, hist)
    assert hist[0] == 3078
    top, _ = index.kde(q, r, kernel="tophat")
    np.testing.assert_array_equal(top, (near.sum(1) / 3000).astype(np.float32))
    if engine != "brute":
        assert res.stats.retested_pairs > 0 and got.stats.retested_pairs > 0


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_threshold_just_off_a_representable_distance(n_chunks):
    """Two leaves of 64 equal points each, at x = 0 and x = 0.5 (d = 2):
    their box distance is exactly 0.5.  r = 0.5 - 1e-9 and the bin edge
    0.5 + 1e-9 round to 0.5 in fp32, so the direct form puts the facing
    pairs at r and in the bin above the edge.  The frontier must neither
    drop the leaf pair against float64 r^2 nor count it whole in the bin
    below against float64 edges."""
    pts = np.zeros((128, 2), np.float32)
    pts[64:, 0] = 0.5
    tree = build_top_tree(pts, 1)
    assert set(tree.leaf_sizes().tolist()) == {64}
    store = ChunkedLeafStore(tree.points_padded, n_chunks=n_chunks, uniform=True,
                             leaf_sizes=tree.leaf_sizes(), device=CPU)
    dual = DualTree(tree, store)
    q = np.zeros((2, 2), np.float32)
    r = 0.5 - 1e-9
    ip, ix, dd, _ = dual.radius(q, r)
    assert ip.tolist() == [0, 128, 256]
    bip, bix, bdd = radius_brute(q, pts, r, device=CPU)
    csr_rows_equal(ip, ix, bip, bix)
    np.testing.assert_array_equal(dd, bdd)
    top, _, _ = dual.kde(q, r, kernel="tophat")
    np.testing.assert_array_equal(top, np.ones(2, np.float32))
    edges = np.array([0.0, 0.5 + 1e-9, 2.0])
    hist, _ = dual.pair_count(edges)
    assert hist.tolist() == [2 * 64 * 63, 2 * 64 * 64]
    np.testing.assert_array_equal(hist, pair_count_brute(pts, edges, device=CPU))


def test_edge_bounds_decide_the_direct_bin():
    """``_edge_bounds`` / ``_hist_bounds`` against the rule they stand for,
    on fp32 squared distances a few ulps around every squared edge (edges
    at 0, at non-squares and at the closed last edge): a value counting an
    even number 2c of boundaries has c edges at or below its fp32 root
    (``_bins``), and so does every value within the shift ``s`` of it."""
    from repro_torch.core.dualtree import _bins, _edge_bounds, _hist_bounds

    edges = np.array([0.0, 0.05, 1 / 3, 0.5 + 1e-9, 2.0]).astype(np.float32)
    lower, upper = _edge_bounds(edges)
    sq = (edges.astype(np.float64) ** 2).astype(np.float32)
    steps = np.arange(-6, 7, dtype=np.float32)
    x = np.concatenate([v + steps * np.spacing(v) for v in sq[1:]] + [[0.0, 1e-30]])
    x = np.maximum(x, 0).astype(np.float32)
    root = np.sqrt(x)
    for i, e in enumerate(edges):
        assert np.all(root[x < lower[i]] < e)
        above = root[x >= upper[i]]
        assert np.all(above > e) if i == edges.size - 1 else np.all(above >= e)
    e_t = torch.from_numpy(edges)
    for s in (0.0, 4 * float(np.spacing(np.float32(1.0)))):
        b = torch.from_numpy(_hist_bounds(lower, upper, s))
        assert torch.all(b[1:] >= b[:-1])
        j = torch.bucketize(torch.from_numpy(x), b, right=True).numpy()
        even = j % 2 == 0
        assert even.any() and (~even).any()
        for shift in (-s, 0.0, s):
            # x moved by at most s, rounded toward x
            xs = (x.astype(np.float64) + shift).astype(np.float32)
            over = np.abs(xs.astype(np.float64) - x) > s
            xs[over] = np.nextafter(xs[over], x[over])
            xs = np.maximum(xs, 0)
            got = _bins(torch.sqrt(torch.from_numpy(xs)), e_t).numpy()
            np.testing.assert_array_equal((j // 2)[even], got[even])


# -- the oracles own their inputs (ROADMAP Queue 3, item 5) ----------------
def _written_during(module, fn_name, target, monkeypatch):
    """Make ``module.fn_name`` add 0.25 to the first half of the rows of
    ``target`` (the caller's array) on its first call, before it computes:
    another writer of the caller's memory while the port reads it."""
    real = getattr(module, fn_name)
    state = {"done": False}

    def wrapped(*args, **kwargs):
        if not state["done"]:
            half = target[: len(target) // 2]
            np.add(half, np.float32(0.25), out=half)
            state["done"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(module, fn_name, wrapped)


@pytest.mark.parametrize("oracle", ["radius_brute", "kde_tophat", "kde_gaussian",
                                    "pair_count_brute", "knn_brute_queries",
                                    "knn_brute_points"])
def test_oracles_own_their_inputs(oracle, monkeypatch):
    """The port's oracles compute on copies they own: a write to the
    caller's arrays while an oracle runs (as by another thread, or by
    another framework holding the same buffer) leaves its answer as it was
    for the arrays at the call.  On the CPU ``torch.from_numpy`` aliased
    the caller's buffer, so such a write reached the distances."""
    from repro_torch.core import brute as port_brute
    from repro_torch.core import dualtree as port_dualtree
    from repro_torch.core.brute import knn_brute

    pts = lattice(400, 3, seed=21)
    q = lattice(60, 3, seed=22)
    calls = {
        "radius_brute": (lambda a, b: radius_brute(a, b, RADIUS, device=CPU),
                         port_dualtree, "_pairwise_direct_d2", "points"),
        "kde_tophat": (lambda a, b: kde_brute(a, b, 2.5, kernel="tophat", device=CPU),
                       port_dualtree, "_pairwise_direct_d2", "points"),
        "kde_gaussian": (lambda a, b: kde_brute(a, b, 2.5, device=CPU),
                         port_dualtree, "_pairwise_d2", "points"),
        "pair_count_brute": (lambda a, b: pair_count_brute(b, EDGES, device=CPU),
                             port_dualtree, "_pairwise_direct_d2", "points"),
        "knn_brute_queries": (lambda a, b: knn_brute(a, b, 5, device=CPU),
                              port_brute, "_tile_step", "queries"),
        "knn_brute_points": (lambda a, b: knn_brute(a, b, 5, device=CPU),
                             port_brute, "_tile_step", "points"),
    }
    call, module, fn_name, which = calls[oracle]
    want = call(q.copy(), pts.copy())
    qa, pa = q.copy(), pts.copy()
    _written_during(module, fn_name, pa if which == "points" else qa, monkeypatch)
    got = call(qa, pa)
    assert not np.array_equal(pa if which == "points" else qa,
                              pts if which == "points" else q)   # the write happened
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_distances_are_correctly_rounded_roots():
    """Every distance the port returns is the IEEE (correctly rounded) fp32
    root of its fp32 squared distance, as numpy's ``sqrt`` computes it.
    PyTorch's CPU float32 ``sqrt`` is not: it returns 16.340134 for 267,
    where the correctly rounded root is 16.340136, and it once returned
    12-bit estimates for a sixth of ``radius_brute``'s distances (ROADMAP
    Queue 3 item 5); ``kernels/ops.py::sqrt`` takes numpy's on the CPU.
    The points are 267 apart squared: (11, 11, 5)."""
    from repro_torch.core.brute import knn_brute
    from repro_torch.kernels.ops import sqrt

    sq = np.arange(1 << 16, dtype=np.float32)
    np.testing.assert_array_equal(sqrt(torch.from_numpy(sq)).numpy(), np.sqrt(sq))
    right = np.sqrt(np.float32(267.0))
    q = np.zeros((1, 3), np.float32)
    pts = np.array([[11.0, 11.0, 5.0], [30.0, 0.0, 0.0]], np.float32)
    _, _, dd = radius_brute(q, pts, 17.0, device=CPU)
    assert dd.tolist() == [right]
    d, i = knn_brute(q, pts, 1, device=CPU)
    assert (d[0, 0], i[0, 0]) == (right, 0)
    ip, _, dd = DualTree(build_top_tree(pts, 1), device=CPU).radius(q, 17.0)[:3]
    assert dd.tolist() == [right]
    # the pair's distance lies on the edge: np.histogram's bins are [a, b)
    hist = pair_count_brute(np.concatenate([q, pts[:1]]), [0.0, float(right), 40.0],
                            device=CPU)
    assert hist.tolist() == [0, 2]
