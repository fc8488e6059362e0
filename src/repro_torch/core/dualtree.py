"""Dual-tree traversals over ``TopTree`` + ``ChunkedLeafStore``.

Counterpart of ``repro.core.dualtree``: radius search, kernel density
estimation and the 2-point correlation function (Gray & Moore,
"Multi-Tree Methods for Statistics on Very Large Datasets in Astronomy")
as node-pair frontier traversals.  The frontier (numpy, float64 boxes)
either prunes a pair of tree nodes wholesale or hands its leaf-pair
product to a leaf-pair function on the device:

  * the pointerless ``TopTree`` supplies the spatial partition (per-node
    bounding boxes are derived bottom-up over the implicit heap);
  * the ``ChunkedLeafStore`` supplies the leaf slabs, streamed chunk by
    chunk like the kNN rounds (leaf-pair batches are grouped by the chunk
    that owns their reference leaf, so each chunk is uploaded once per
    call);
  * leaf-pair batches are padded to the fixed ``PAIR_RUNGS`` sizes and the
    query-side slab count to ``QLEAF_RUNGS``.  Torch has no jit cache:
    ``dualtree_cache_size`` counts the distinct batch shapes run, the
    counterpart of the reference's compile count.

The leaf-pair functions are torch ops (the reference's are jnp, not
Pallas).  They compute a leaf pair's distances by the ||a||^2 + ||b||^2 -
2 a.b form in fp32 (``_pairwise_d2``).  The answer they give is the one of
the direct fp32 form, sum_j (a_j - b_j)^2 in feature order
(``_direct_d2``), the form the brute-force oracles below use: a pair whose
decomposed value lies within the rounding band of both forms (``_band``,
the slack of ``lazysearch.certify``) of fp32 r^2, of fp32 h^2 or of an
fp32 bin edge (``_edge_bounds``) is tested again directly, and every
radius hit's distance is the direct one.  The frontier prunes and counts
whole node pairs against the same fp32 thresholds, its float64 box
distances widened by the band of the boxes' largest norms.
(The reference selects by the decomposed form,
``repro/core/dualtree.py:162``: a documented divergence.)  Every product
and sum is an elementwise op of its own in feature order, so a pair of
points gets the same bits in every batch shape and in the oracles.
``radius`` compares on the device and copies back only the hits;
``pair_count`` evaluates a batch in sub-batches of at most
``_PAIR_ELEMS`` distances so the peak stays bounded; ``kde`` sums its
parts in float64 on the device.  ``SearchStats.retested_pairs`` counts the
pairs tested again.

Semantics (shared with the brute references):

  radius      all reference points with Euclidean ``dist <= r`` (inclusive),
              CSR over query rows, per-row neighbors sorted by distance;
  kde         mean kernel value ``density[i] = (1/n) * sum_j K(|q_i - x_j|)``
              with K gaussian ``exp(-d^2 / 2h^2)`` or tophat ``1[d <= h]``
              (no normalization constant).  Gaussian satisfies ``|approx -
              exact| <= rtol*exact + atol`` per query; tophat is exact.
  pair_count  histogram over ``edges`` (np.histogram bin semantics, last
              edge closed) of the distances of all ORDERED pairs (i, j),
              i != j — twice the unordered 2-point count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.lazysearch import SearchStats
from repro_torch.core.toptree import PAD_COORD, TopTree, build_top_tree
from repro_torch.kernels.ops import owned_tensor, resolve_device, sqrt

__all__ = [
    "DualTree",
    "NodeBounds",
    "node_bounds",
    "dualtree_cache_size",
    "radius_brute",
    "kde_brute",
    "pair_count_brute",
    "leaf_norm_max",
    "PAIR_RUNGS",
    "QLEAF",
    "QLEAF_RUNGS",
]

# Leaf-pair batches are padded up to these fixed sizes.
PAIR_RUNGS = (8, 32, 128)

# Query-side tree leaves are built to hold <= QLEAF points and padded to
# exactly QLEAF rows.
QLEAF = 64

# The query-side slab COUNT (2**q_height) is padded up to these rungs.
QLEAF_RUNGS = (2, 8, 32, 128, 512, 2048, 8192)

_KERNELS = ("gaussian", "tophat")

# distances one pair_count sub-batch evaluates at most (bounds its peak:
# a few fp32 / int64 tensors of this many elements)
_PAIR_ELEMS = 1 << 26

# distinct leaf-pair batch shapes run so far (process-wide, like the
# reference's jit caches)
_SHAPES: Set[Tuple] = set()


def _rung_up(x: int, rungs: Sequence[int]) -> int:
    for r in rungs:
        if x <= r:
            return r
    return rungs[-1]


# ---------------------------------------------------------------------------
# Per-node bounding boxes over the implicit heap (numpy, float64)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NodeBounds:
    """Axis-aligned boxes + point counts for every heap node of a TopTree.

    Heap-indexed (index 0 unused, root at 1, leaves at
    ``first_leaf_heap .. 2*first_leaf_heap - 1``).  Empty nodes carry
    ``lo=+inf, hi=-inf, count=0`` and must be pruned by count before their
    box is used.  float64, so prune decisions do not wobble with fp32
    rounding.
    """

    lo: np.ndarray      # f64[2*n_leaves, d]
    hi: np.ndarray      # f64[2*n_leaves, d]
    count: np.ndarray   # i64[2*n_leaves]
    first_leaf: int


def node_bounds(tree: TopTree) -> NodeBounds:
    """Compute per-leaf boxes from the slabs, then merge bottom-up."""
    nl, d = tree.n_leaves, tree.d
    pp = tree.points_padded[:, :, :d].astype(np.float64)
    sizes = tree.leaf_sizes().astype(np.int64)
    valid = np.arange(tree.leaf_pad)[None, :] < sizes[:, None]
    lo = np.full((2 * nl, d), np.inf)
    hi = np.full((2 * nl, d), -np.inf)
    lo[nl:] = np.where(valid[:, :, None], pp, np.inf).min(axis=1)
    hi[nl:] = np.where(valid[:, :, None], pp, -np.inf).max(axis=1)
    count = np.zeros(2 * nl, np.int64)
    count[nl:] = sizes
    v = nl // 2
    while v >= 1:
        sl = slice(v, 2 * v)
        lo[sl] = np.minimum(lo[2 * v:4 * v:2], lo[2 * v + 1:4 * v:2])
        hi[sl] = np.maximum(hi[2 * v:4 * v:2], hi[2 * v + 1:4 * v:2])
        count[sl] = count[2 * v:4 * v:2] + count[2 * v + 1:4 * v:2]
        v //= 2
    return NodeBounds(lo=lo, hi=hi, count=count, first_leaf=nl)


def _box_dist2(
    a: NodeBounds, u: np.ndarray, b: NodeBounds, v: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(min, max) squared distance between node boxes a[u] and b[v]."""
    alo, ahi = a.lo[u], a.hi[u]
    blo, bhi = b.lo[v], b.hi[v]
    gap = np.maximum(np.maximum(alo - bhi, blo - ahi), 0.0)
    dmin2 = (gap * gap).sum(axis=1)
    far = np.maximum(ahi - blo, bhi - alo)
    dmax2 = (far * far).sum(axis=1)
    return dmin2, dmax2


# ---------------------------------------------------------------------------
# Leaf-pair functions (torch ops on the slabs' device)
# ---------------------------------------------------------------------------
def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    """||a||^2 over the last axis, summed in feature order."""
    out = a[..., 0] * a[..., 0]
    for j in range(1, a.shape[-1]):
        out = out + a[..., j] * a[..., j]
    return out


def _pairwise_d2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., a, b] of A [..., a, d] against B [..., b, d]
    via ||a||^2 + ||b||^2 - 2 a.b, clamped at 0.  The dot products are
    summed in feature order, one elementwise product and sum per feature,
    so a pair's value does not depend on the batch it is computed in.
    PAD_COORD rows against real rows come out huge; PAD against PAD
    cancels to garbage near 0 — callers mask or row-slice those."""
    cross = A[..., :, None, 0] * B[..., None, :, 0]
    for j in range(1, A.shape[-1]):
        cross = cross + A[..., :, None, j] * B[..., None, :, j]
    d2 = _sq_norms(A)[..., :, None] + _sq_norms(B)[..., None, :] - 2.0 * cross
    return torch.clamp(d2, min=0.0)


def _direct_d2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared distances sum_j (A_j - B_j)^2 of broadcast rows A [..., d]
    and B [..., d] (the direct fp32 form), summed in feature order, one
    elementwise op per step: the same bits for a pair in any shape."""
    diff = A[..., 0] - B[..., 0]
    out = diff * diff
    for j in range(1, A.shape[-1]):
        diff = A[..., j] - B[..., j]
        out = out + diff * diff
    return out


def _pairwise_direct_d2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``_direct_d2`` of every row of A [..., a, d] against every row of
    B [..., b, d]: [..., a, b]."""
    return _direct_d2(A[..., :, None, :], B[..., None, :, :])


def leaf_norm_max(tree: TopTree) -> np.ndarray:
    """Largest norm of a real point in each leaf (float64[n_leaves], 0 for
    an empty leaf): one side of the rounding band of a leaf pair."""
    norms = np.sqrt(np.sum(tree.points.astype(np.float64) ** 2, axis=1))
    leaf = np.repeat(np.arange(tree.n_leaves), tree.leaf_sizes())
    out = np.zeros(tree.n_leaves)
    np.maximum.at(out, leaf, norms)
    return out


def _band(norm_a: np.ndarray, norm_b: np.ndarray, d: int) -> np.ndarray:
    """Rounding band of a pair of points of norms up to ``norm_a`` and
    ``norm_b``, f64: ``lazysearch.certify``'s slack 2 (d + 2) 2^-24
    (|a| + |b|)^2, which bounds the fp32 rounding of the decomposed form
    plus that of the direct form, widened by an eighth to cover the
    rounding of the band test itself.  A pair whose decomposed value, or
    exact value, lies farther than this from a threshold falls on the same
    side of it as its direct value."""
    return 1.125 * 2 * (d + 2) * 2.0 ** -24 * (norm_a + norm_b) ** 2


def _box_norm(b: NodeBounds, u: np.ndarray) -> np.ndarray:
    """Largest norm a point in node box b[u] can have, f64."""
    far = np.maximum(b.lo[u] ** 2, b.hi[u] ** 2)
    return np.sqrt(far.sum(axis=1))


def _edge_bounds(edges32: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Squared-distance bounds (lower, upper) f64[E+1] of fp32 bin edges:
    an fp32 value x below lower[i] has fp32 sqrt(x) < edges[i], one at or
    above upper[i] has sqrt(x) >= edges[i] (> for the last edge, which is
    closed).  Exact for any faithfully rounded sqrt; an edge at 0 is
    passed by every x >= 0 (-inf both)."""
    e = edges32.astype(np.float32)
    prev = np.nextafter(e, np.float32(-np.inf)).astype(np.float64)
    lower = np.where(e > 0, prev * prev, -np.inf)
    upper = np.where(e > 0, e.astype(np.float64) ** 2, -np.inf)
    nxt = float(np.nextafter(e[-1], np.float32(np.inf)))
    upper[-1] = nxt * nxt
    return lower, upper


def _hist_bounds(lower: np.ndarray, upper: np.ndarray, s: float) -> np.ndarray:
    """f32[2 (E+1)] sorted boundaries (lower[i] - s, upper[i] + s), rounded
    outward to fp32: a value x whose count of boundaries <= x is even, 2c,
    lies more than ``s`` from every edge's [lower, upper) interval, so any
    value within ``s`` of x has c edges at or below its root."""
    lo, hi = lower - s, upper + s
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    out = np.stack([lo32, hi32], axis=1).ravel()
    return np.maximum.accumulate(out).astype(np.float32)


def _radius_kernel(qslab, rslab, iq, ir):
    """Squared distances of query-leaf x ref-leaf pair batches.

    qslab f32[QL, qlp, d] (device query slab), rslab f32[C, lp, d] (chunk
    slab), iq/ir i64[P].  Returns f32[P, qlp, lp]; the caller compares with
    r^2 and masks pad query rows (PAD x PAD cancellation can fake a 0 on
    pad rows — never on valid ones)."""
    _SHAPES.add(("radius", iq.shape[0], tuple(qslab.shape), tuple(rslab.shape)))
    return _pairwise_d2(qslab[iq], rslab[ir])


def _kde_gauss_kernel(qslab, rslab, iq, ir, scale: float):
    """Per-query-row gaussian mass of each pair: sum_j exp(-d2*scale),
    f32[P, qlp], scale = 1/(2 h^2) in fp32.  PAD ref rows contribute
    exp(-huge) = 0; pad QUERY rows collect junk and are dropped."""
    _SHAPES.add(("kde_gauss", iq.shape[0], tuple(qslab.shape), tuple(rslab.shape)))
    d2 = _pairwise_d2(qslab[iq], rslab[ir])
    return torch.exp(-d2 * scale).sum(dim=-1)


def _kde_tophat_kernel(qslab, rslab, iq, ir, h2: float, band, qn, rn):
    """Per-query-row tophat count of each pair, #{j : d2 <= h^2} by the
    direct form (fp32 h^2), f32[P, qlp], and the number of pairs tested
    again: those of real rows (``qn`` / ``rn`` i64[P] row counts) whose
    decomposed value lies within ``band`` f32[P] of h^2."""
    _SHAPES.add(("kde_tophat", iq.shape[0], tuple(qslab.shape), tuple(rslab.shape)))
    a, b = qslab[iq], rslab[ir]
    d2 = _pairwise_d2(a, b)
    s = band[:, None, None]
    inside = d2 + s <= h2
    rows = torch.arange(a.shape[1], device=a.device)
    cols = torch.arange(b.shape[1], device=a.device)
    real = (rows[None, :, None] < qn[:, None, None]) & (cols[None, None, :] < rn[:, None, None])
    p, i, j = torch.nonzero((d2 - s <= h2) & ~inside & real, as_tuple=True)
    hit = (_direct_d2(a[p, i], b[p, j]) <= h2).to(torch.float32)
    count = inside.to(torch.float32).sum(dim=-1)
    count.index_put_((p, i), hit, accumulate=True)
    return count, p.shape[0]


def _bins(dist: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """np.histogram bin + 1 of each distance over ``edges`` f32[E+1]: 0
    below the first edge, E + 1 above the last (and +inf), the last edge
    closed; a nondecreasing function of the distance."""
    r = torch.bucketize(dist, edges, right=True)   # searchsorted side="right"
    return torch.where(dist == edges[-1], edges.shape[0] - 1, r)


def _hist_counts(bins: torch.Tensor, rows: torch.Tensor, n_rows: int, e: int) -> torch.Tensor:
    """Counts of ``bins`` (from ``_bins``) per row ``rows`` (i64, same
    shape) in 0..n_rows-1, over the E = ``e`` real bins: i64[n_rows, E]."""
    flat = (bins + (e + 2) * rows).reshape(-1)
    hist = torch.bincount(flat, minlength=n_rows * (e + 2)).reshape(n_rows, e + 2)
    return hist[:, 1:e + 1]


def _pair_hist_kernel(aslab, bslab, ia, ib, sa, sb, edges, bounds):
    """Distance histogram of leaf x leaf pair batches, np.histogram bins of
    the direct form's distances.

    Both sides gather from chunk slabs; ``sa`` / ``sb`` i64[P] are the real
    row counts (PAD x PAD rows can cancel to a fake 0, so they are
    dropped).  ``bounds`` f32[2 (E+1)] are ``_hist_bounds`` of the edges at
    the batch's largest band: a pair whose decomposed value counts an even
    number 2c of them is binned in c; the rest are binned by
    ``_direct_d2``.  Returns (i64[P, E] counts for E = len(edges) - 1 bins,
    the number of pairs tested again).  Evaluated ``_PAIR_ELEMS`` distances
    at a time."""
    p = ia.shape[0]
    e = edges.shape[0] - 1
    la, lb = aslab.shape[1], bslab.shape[1]
    _SHAPES.add(("pair_hist", p, tuple(aslab.shape), tuple(bslab.shape), edges.shape[0]))
    rows = torch.arange(la, device=aslab.device)
    cols = torch.arange(lb, device=aslab.device)
    step = max(1, _PAIR_ELEMS // (la * lb))
    out, retested = [], 0
    for s in range(0, p, step):
        a, b = aslab[ia[s:s + step]], bslab[ib[s:s + step]]
        j = torch.bucketize(_pairwise_d2(a, b), bounds, right=True)
        valid = (rows[None, :, None] < sa[s:s + step, None, None]) & (
            cols[None, None, :] < sb[s:s + step, None, None])
        near = (j & 1) == 1
        # invalid and near pairs go above the last bin, which is not counted
        bins = torch.where(valid & ~near, j >> 1, e + 1)
        pp = torch.arange(a.shape[0], device=a.device)[:, None, None].expand_as(bins)
        hist = _hist_counts(bins, pp, a.shape[0], e)
        q, i, k = torch.nonzero(valid & near, as_tuple=True)
        if q.numel():
            again = _bins(sqrt(_direct_d2(a[q, i], b[q, k])), edges)
            hist += _hist_counts(again, q, a.shape[0], e)
            retested += q.numel()
        out.append(hist)
    return torch.cat(out), retested


def dualtree_cache_size() -> int:
    """Distinct leaf-pair batch shapes run in this process (the counterpart
    of the reference's compiled-variant count: one per entered rung shape,
    none for new radii, bandwidths or edge values)."""
    return len(_SHAPES)


# ---------------------------------------------------------------------------
# The traversal engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _TraceStats:
    """Mutable counters one traversal accumulates, frozen into SearchStats."""

    levels: int = 0
    pairs_pruned: int = 0
    leaf_pairs: int = 0
    batches: int = 0
    chunk_visits: int = 0
    points_paired: int = 0
    retested: int = 0
    shapes: set = dataclasses.field(default_factory=set)

    def freeze(self, m: int) -> SearchStats:
        return SearchStats(
            iterations=self.levels,
            flushes=self.batches,
            units_scanned=self.leaf_pairs,
            points_scanned=self.points_paired,
            queries_advanced=m,
            chunk_rounds=self.chunk_visits,
            plan_shapes=len(self.shapes),
            retested_pairs=self.retested,
        )


class DualTree:
    """Node-pair frontier ops over a built ``TopTree`` + leaf store.

    ``store`` is the index's ``ChunkedLeafStore`` when its slabs are fp32;
    a quantized store cannot feed the distance functions, so a private fp32
    store with the same chunk count is built from the tree's fp32 slabs
    (at the points' width d) — the ops stay exact at any index precision,
    for one host fp32 slab copy.  ``device`` is used only when no store is
    given (None = cuda:0).
    """

    def __init__(
        self,
        tree: TopTree,
        store: Optional[ChunkedLeafStore] = None,
        *,
        device=None,
    ):
        self.tree = tree
        if store is not None and not store.quantized:
            self.store = store
        else:
            self.store = ChunkedLeafStore(
                tree.points_padded,
                n_chunks=store.n_chunks if store is not None else 1,
                device=store.device if store is not None else resolve_device(device),
                uniform=True,
                leaf_sizes=tree.leaf_sizes(),
            )
        self.device = self.store.device
        self.bounds = node_bounds(tree)
        self.d = self.store.host.shape[2]
        self._leaf_sizes = tree.leaf_sizes().astype(np.int64)
        self._leaf_norm = leaf_norm_max(tree)
        # device slab cache for pair_count's (chunk_a, chunk_b) groups:
        # at most two chunk slabs resident, mirroring the store's two slots
        self._slab_cache: Dict[int, torch.Tensor] = {}

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # -- query-side tree -------------------------------------------------
    def _build_qtree(self, queries: np.ndarray) -> Tuple[TopTree, NodeBounds, torch.Tensor]:
        """Top tree over the query batch with a FIXED leaf pad (QLEAF) and
        a rung-padded slab count, so the device query slab's shape depends
        only on the batch-size rung."""
        m = queries.shape[0]
        h = max(1, math.ceil(math.log2(max(2, -(-m // QLEAF)))))
        qt = build_top_tree(queries, h, leaf_pad_multiple=QLEAF)
        qb = node_bounds(qt)
        slab = qt.points_padded
        ql_pad = _rung_up(slab.shape[0], QLEAF_RUNGS)
        if ql_pad != slab.shape[0]:
            fill = np.full((ql_pad - slab.shape[0],) + slab.shape[1:], np.float32(PAD_COORD))
            slab = np.concatenate([slab, fill], axis=0)
        return qt, qb, self._dev(slab)

    # -- frontier expansion (numpy, as the reference) ---------------------
    def _qr_leaf_pairs(
        self, qb: NodeBounds, prune, trace: _TraceStats
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Expand the (query-node, ref-node) frontier down to leaf pairs.

        ``prune(u, v, dmin2, dmax2)`` returns a boolean drop mask (True =
        the pair is fully handled: out of range, or accumulated by the
        op's approximation rule).  Returns (q_leaf_ids, ref_leaf_ids).
        """
        rb = self.bounds
        u = np.array([1], np.int64)
        v = np.array([1], np.int64)
        out_q, out_r = [], []
        while u.size:
            trace.levels += 1
            alive = (qb.count[u] > 0) & (rb.count[v] > 0)
            u, v = u[alive], v[alive]
            if not u.size:
                break
            dmin2, dmax2 = _box_dist2(qb, u, rb, v)
            drop = prune(u, v, dmin2, dmax2)
            trace.pairs_pruned += int(drop.sum())
            u, v = u[~drop], v[~drop]
            q_leaf = u >= qb.first_leaf
            r_leaf = v >= rb.first_leaf
            done = q_leaf & r_leaf
            out_q.append(u[done] - qb.first_leaf)
            out_r.append(v[done] - rb.first_leaf)
            u, v = u[~done], v[~done]
            if not u.size:
                continue
            ql = u >= qb.first_leaf
            rl = v >= rb.first_leaf
            # expand every non-leaf side (both at once when both are
            # internal: 4 child pairs; else 2); a leaf side repeats itself
            # in its two "children", and unique() drops the duplicates
            nu = np.where(ql, u, 2 * u)
            nu2 = np.where(ql, u, 2 * u + 1)
            nv = np.where(rl, v, 2 * v)
            nv2 = np.where(rl, v, 2 * v + 1)
            pairs = np.unique(
                np.stack(
                    [
                        np.concatenate([nu, nu2, nu, nu2]),
                        np.concatenate([nv, nv, nv2, nv2]),
                    ],
                    axis=1,
                ),
                axis=0,
            )
            u, v = pairs[:, 0], pairs[:, 1]
        if out_q:
            return np.concatenate(out_q), np.concatenate(out_r)
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    def _self_leaf_pairs(
        self, prune, trace: _TraceStats
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Symmetric (ref x ref) frontier for pair_count.

        Pairs carry an ordered-pair weight: the diagonal root (1, 1) starts
        at weight 1; expanding a diagonal pair (a, a) yields (2a, 2a) w,
        (2a, 2a+1) 2w, (2a+1, 2a+1) w.  Off-diagonal pairs have disjoint
        subtrees, so their children inherit the weight.  ``prune(a, b, w,
        dmin2, dmax2)`` may accumulate and drop.  Returns leaf (a, b, w).
        """
        rb = self.bounds
        a = np.array([1], np.int64)
        b = np.array([1], np.int64)
        w = np.array([1], np.int64)
        out_a, out_b, out_w = [], [], []
        while a.size:
            trace.levels += 1
            alive = (rb.count[a] > 0) & (rb.count[b] > 0)
            a, b, w = a[alive], b[alive], w[alive]
            if not a.size:
                break
            dmin2, dmax2 = _box_dist2(rb, a, rb, b)
            drop = prune(a, b, w, dmin2, dmax2)
            trace.pairs_pruned += int(drop.sum())
            a, b, w = a[~drop], b[~drop], w[~drop]
            leaf = a >= rb.first_leaf  # a <= b and leaves share one level
            done = leaf & (b >= rb.first_leaf)
            out_a.append(a[done] - rb.first_leaf)
            out_b.append(b[done] - rb.first_leaf)
            out_w.append(w[done])
            a, b, w = a[~done], b[~done], w[~done]
            if not a.size:
                continue
            diag = a == b
            da = a[diag]
            na = [2 * da, 2 * da, 2 * da + 1]
            nb = [2 * da, 2 * da + 1, 2 * da + 1]
            nw = [w[diag], 2 * w[diag], w[diag]]
            oa, ob, ow = a[~diag], b[~diag], w[~diag]
            if oa.size:
                # both sides are internal here: in one tree every pair's
                # components sit at the same depth
                na.append(np.concatenate([2 * oa, 2 * oa + 1, 2 * oa, 2 * oa + 1]))
                nb.append(np.concatenate([2 * ob, 2 * ob, 2 * ob + 1, 2 * ob + 1]))
                nw.append(np.tile(ow, 4))
            a = np.concatenate(na)
            b = np.concatenate(nb)
            w = np.concatenate(nw)
            lohi = np.sort(np.stack([a, b], axis=1), axis=1)
            a, b = lohi[:, 0], lohi[:, 1]
        if out_a:
            return (np.concatenate(out_a), np.concatenate(out_b), np.concatenate(out_w))
        return (np.zeros(0, np.int64),) * 3

    # -- leaf-pair batching ----------------------------------------------
    def _batches(self, n: int):
        """Yield (lo, hi, rung) slices covering [0, n) at PAIR_RUNGS sizes."""
        top = PAIR_RUNGS[-1]
        lo = 0
        while lo < n:
            take = min(top, n - lo)
            yield lo, lo + take, _rung_up(take, PAIR_RUNGS)
            lo += take

    def _pad_pairs(self, arrs, lo, hi, rung):
        """Device i64[rung] slices of ``arrs`` [lo:hi], padded with 0."""
        out = []
        for arr in arrs:
            sl = np.zeros(rung, np.int64)
            sl[: hi - lo] = arr[lo:hi]
            out.append(self._dev(sl))
        return out

    # -- ops ----------------------------------------------------------------
    def radius(
        self, queries: np.ndarray, r: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, SearchStats]:
        """All reference points within Euclidean ``r`` (inclusive) of each
        query row, as CSR (indptr i64[m+1], indices i64[nnz] into the
        original point ordering, dists f32[nnz] ascending per row)."""
        queries = np.asarray(queries, np.float32)
        m = queries.shape[0]
        r = float(r)
        if r < 0:
            raise ValueError(f"radius must be >= 0, got {r}")
        trace = _TraceStats()
        if m < 2:
            ip, ix, dd = radius_brute(queries, self.tree.points, r, device=self.device)
            ix = self.tree.orig_idx.astype(np.int64)[ix]
            return ip, ix, dd, trace.freeze(m)
        qt, qb, qslab = self._build_qtree(queries)
        q_norm = leaf_norm_max(qt)
        t2 = float(np.float32(r * r))   # the fp32 threshold both forms meet

        def prune(u, v, dmin2, dmax2):
            # no direct value can reach t2 (the band covers its rounding)
            return dmin2 - _band(_box_norm(qb, u), _box_norm(self.bounds, v), self.d) > t2

        ql, rl = self._qr_leaf_pairs(qb, prune, trace)
        q_start = self._dev(qt.leaf_start.astype(np.int64))
        q_sizes = self._dev(qt.leaf_sizes().astype(np.int64))
        r_start = self._dev(self.tree.leaf_start.astype(np.int64))
        rows = torch.arange(qslab.shape[1], device=self.device)
        q_ids, r_ids, dists = [], [], []
        for buf, qsel, rsel, rung, iq, ir in self._stream_ref(ql, rl, trace):
            real = qsel.size
            # the pairs the decomposed form, less the band, puts within r
            # are rescored directly on the device; only the hits come back
            d2 = _radius_kernel(qslab, buf, iq, ir)[:real]
            trace.shapes.add((rung, qslab.shape[0]))
            qs, rs = self._dev(qsel), self._dev(rsel)
            band = self._dev(_band(q_norm[qsel], self._leaf_norm[rsel], self.d).astype(np.float32))
            rowok = rows[None, :] < q_sizes[qs][:, None]
            p, qi, rj = torch.nonzero(
                (d2 - band[:, None, None] <= t2) & rowok[:, :, None], as_tuple=True)
            trace.retested += int((d2[p, qi, rj] + band[p] > t2).sum())
            dd2 = _direct_d2(qslab[iq[p], qi], buf[ir[p], rj])
            hit = dd2 <= t2
            p, qi, rj = p[hit], qi[hit], rj[hit]
            q_ids.append(q_start[qs[p]] + qi)
            r_ids.append(r_start[rs[p]] + rj)
            dists.append(sqrt(dd2[hit]))
        if q_ids:
            qrow = self._dev(qt.orig_idx.astype(np.int64))[torch.cat(q_ids)]
            ridx = self._dev(self.tree.orig_idx.astype(np.int64))[torch.cat(r_ids)]
            dd = torch.cat(dists)
            # np.lexsort((dd, qrow)): by row, then distance, then position
            o1 = torch.sort(dd, stable=True).indices
            order = o1[torch.sort(qrow[o1], stable=True).indices]
            qrow = qrow[order].cpu().numpy()
            ridx = ridx[order].cpu().numpy()
            dd = dd[order].cpu().numpy()
        else:
            qrow = np.zeros(0, np.int64)
            ridx = np.zeros(0, np.int64)
            dd = np.zeros(0, np.float32)
        indptr = np.zeros(m + 1, np.int64)
        np.cumsum(np.bincount(qrow, minlength=m), out=indptr[1:])
        return indptr, ridx, dd, trace.freeze(m)

    def kde(
        self,
        queries: np.ndarray,
        bandwidth: float,
        *,
        rtol: float = 1e-2,
        atol: float = 1e-9,
        kernel: str = "gaussian",
    ) -> Tuple[np.ndarray, float, SearchStats]:
        """Mean kernel value per query (see module doc for semantics).

        A node pair is midpoint-approximated when the error that adds is
        within ``rtol`` times a lower bound of the pair's own true
        contribution OR within ``atol`` spread over the whole point set.
        Returns (density f32[m], err_bound, stats): ``err_bound`` is the
        largest per-query absolute error bound the prune rule accumulated
        (0.0 when everything was computed exactly — always for tophat).
        """
        queries = np.asarray(queries, np.float32)
        m = queries.shape[0]
        h = float(bandwidth)
        if h <= 0:
            raise ValueError(f"bandwidth must be > 0, got {h}")
        if kernel not in _KERNELS:
            raise ValueError(f"kernel={kernel!r} not in {_KERNELS}")
        rtol = float(rtol)
        atol = float(atol)
        trace = _TraceStats()
        n = self.tree.n
        if m < 2:
            dens = kde_brute(queries, self.tree.points, h, kernel=kernel, device=self.device)
            return dens, 0.0, trace.freeze(m)
        qt, qb, qslab = self._build_qtree(queries)
        h2 = h * h
        rb = self.bounds
        # midpoint contributions accumulated on QUERY heap nodes, pushed
        # down to rows after the traversal
        contrib = np.zeros(2 * qb.first_leaf)
        err = np.zeros(2 * qb.first_leaf)

        if kernel == "gaussian":
            def prune(u, v, dmin2, dmax2):
                kmax = np.exp(-dmin2 / (2.0 * h2))
                kmin = np.exp(-dmax2 / (2.0 * h2))
                # midpoint error (kmax-kmin)/2 per point, accepted against
                # rtol * kmin or the atol allowance: summed over a query's
                # accepted pairs, err <= rtol*density + atol
                ok = (kmax - kmin) <= 2.0 * np.maximum(rtol * kmin, atol)
                if ok.any():
                    c = rb.count[v[ok]].astype(np.float64)
                    np.add.at(contrib, u[ok], c * 0.5 * (kmax[ok] + kmin[ok]) / n)
                    np.add.at(err, u[ok], c * 0.5 * (kmax[ok] - kmin[ok]) / n)
                return ok
        else:
            t2 = float(np.float32(h2))   # the direct form's threshold

            def prune(u, v, dmin2, dmax2):
                band = _band(_box_norm(qb, u), _box_norm(rb, v), self.d)
                inside = dmax2 + band <= t2
                if inside.any():
                    np.add.at(contrib, u[inside], rb.count[v[inside]].astype(np.float64) / n)
                return inside | (dmin2 - band > t2)

        ql, rl = self._qr_leaf_pairs(qb, prune, trace)
        # the leaf-pair parts, summed per query row in float64 on the device
        density = torch.zeros(qt.n, dtype=torch.float64, device=self.device)
        q_start = self._dev(qt.leaf_start.astype(np.int64))
        q_sizes = self._dev(qt.leaf_sizes().astype(np.int64))
        q_norm = leaf_norm_max(qt)
        q_sizes_h = qt.leaf_sizes().astype(np.int64)
        rows = torch.arange(qslab.shape[1], device=self.device)
        for buf, qsel, rsel, rung, iq, ir in self._stream_ref(ql, rl, trace):
            if kernel == "gaussian":
                part = _kde_gauss_kernel(qslab, buf, iq, ir, float(np.float32(1.0 / (2.0 * h2))))
            else:
                # tophat: the direct form decides membership (as radius)
                pad = iq.shape[0] - qsel.size
                band = np.pad(_band(q_norm[qsel], self._leaf_norm[rsel], self.d), (0, pad))
                band = band.astype(np.float32)
                qn = np.pad(q_sizes_h[qsel], (0, pad))
                rn = np.pad(self._leaf_sizes[rsel], (0, pad))
                part, again = _kde_tophat_kernel(qslab, buf, iq, ir, float(np.float32(h2)),
                                                 self._dev(band), self._dev(qn), self._dev(rn))
                trace.retested += again
            part = part[: qsel.size].to(torch.float64) / n
            trace.shapes.add((rung, qslab.shape[0]))
            qs = self._dev(qsel)
            ok = rows[None, :] < q_sizes[qs][:, None]
            pos = q_start[qs][:, None] + rows[None, :]
            density.index_add_(0, pos[ok], part[ok])
        density = density.cpu().numpy()
        # push node contributions down the query heap to its leaves
        v = 1
        while v < qb.first_leaf:
            sl = slice(v, 2 * v)
            contrib[2 * v:4 * v:2] += contrib[sl]
            contrib[2 * v + 1:4 * v:2] += contrib[sl]
            err[2 * v:4 * v:2] += err[sl]
            err[2 * v + 1:4 * v:2] += err[sl]
            v *= 2
        q_start_h = qt.leaf_start.astype(np.int64)
        q_sizes_h = qt.leaf_sizes().astype(np.int64)
        for leaf in range(qb.first_leaf):
            s = q_sizes_h[leaf]
            density[q_start_h[leaf]:q_start_h[leaf] + s] += contrib[qb.first_leaf + leaf]
        out = np.zeros(m, np.float64)
        out[qt.orig_idx.astype(np.int64)] = density
        bound = float(err[qb.first_leaf:].max()) if err.any() else 0.0
        return out.astype(np.float32), bound, trace.freeze(m)

    def pair_count(self, edges: np.ndarray) -> Tuple[np.ndarray, SearchStats]:
        """2-point correlation: histogram (np.histogram semantics) of the
        distances of all ordered pairs (i, j), i != j, of the reference
        set against itself.  Returns (hist i64[E], stats)."""
        edges = np.asarray(edges, np.float64).ravel()
        if edges.size < 2 or not np.all(np.diff(edges) > 0):
            raise ValueError("edges must be >= 2 strictly increasing values")
        if edges[0] < 0:
            raise ValueError("distance edges must be >= 0")
        E = edges.size - 1
        trace = _TraceStats()
        hist = np.zeros(E, np.int64)
        edges32 = edges.astype(np.float32)
        lower, upper = _edge_bounds(edges32)
        rb = self.bounds

        def prune(a, b, w, dmin2, dmax2):
            # every direct value of the pair lies in [dmin2 - band, dmax2 +
            # band]: one count of edges passed for both ends = one bin
            band = _band(_box_norm(rb, a), _box_norm(rb, b), self.d)
            bl = np.searchsorted(upper, dmin2 - band, side="right")
            bh = np.searchsorted(lower, dmax2 + band, side="right")
            same = bl == bh
            onebin = same & (bl >= 1) & (bl <= E)
            if onebin.any():
                width = w[onebin] * rb.count[a[onebin]] * rb.count[b[onebin]]
                np.add.at(hist, bl[onebin] - 1, width)
            return same

        la, lb, lw = self._self_leaf_pairs(prune, trace)
        edges_dev = self._dev(edges32)
        sizes, norm = self._leaf_sizes, self._leaf_norm
        # group leaf pairs by their (chunk_a, chunk_b) so at most two chunk
        # slabs are device-resident at a time (the store's own slot count)
        ca = np.asarray(self.store.chunk_of_leaf(la))
        cb = np.asarray(self.store.chunk_of_leaf(lb))
        order = np.lexsort((lb, la, cb, ca))
        la, lb, lw, ca, cb = la[order], lb[order], lw[order], ca[order], cb[order]
        group = np.concatenate(
            [[0], np.nonzero((np.diff(ca) != 0) | (np.diff(cb) != 0))[0] + 1, [la.size]]
        )
        total = torch.zeros(E, dtype=torch.int64, device=self.device)
        for g in range(group.size - 1):
            glo, ghi = int(group[g]), int(group[g + 1])
            if glo == ghi:
                continue
            buf_a, lo_a = self._chunk_slab(int(ca[glo]), trace)
            buf_b, lo_b = self._chunk_slab(int(cb[glo]), trace)
            for lo, hi, rung in self._batches(ghi - glo):
                lo, hi = glo + lo, glo + hi
                ia, ib = self._pad_pairs((la - lo_a, lb - lo_b), lo, hi, rung)
                sa, sb = self._pad_pairs((sizes[la], sizes[lb]), lo, hi, rung)
                s = float(_band(norm[la[lo:hi]], norm[lb[lo:hi]], self.d).max())
                h, again = _pair_hist_kernel(buf_a, buf_b, ia, ib, sa, sb, edges_dev,
                                             self._dev(_hist_bounds(lower, upper, s)))
                trace.retested += again
                trace.shapes.add((rung, "pc"))
                trace.batches += 1
                real = hi - lo
                trace.leaf_pairs += real
                trace.points_paired += int((sizes[la[lo:hi]] * sizes[lb[lo:hi]]).sum())
                total += (h[:real] * self._dev(lw[lo:hi])[:, None]).sum(dim=0)
        hist += total.cpu().numpy()
        # the traversal counts ordered pairs INCLUDING the diagonal; the n
        # self-pairs sit at distance 0 — remove them from whichever bin
        # holds 0 (if any)
        zbin = np.searchsorted(edges, 0.0, side="right")
        if zbin == 0 and edges[0] == 0.0:
            zbin = 1
        if 1 <= zbin <= E:
            hist[zbin - 1] -= self.tree.n
        return hist, trace.freeze(0)

    # -- chunk streaming helpers ----------------------------------------
    def _stream_ref(self, ql, rl, trace: _TraceStats):
        """Group (query-leaf, ref-leaf) pairs by the chunk owning the ref
        leaf and stream each chunk once (double-buffered by the store),
        yielding rung-padded batches with device-local ref indices."""
        if ql.size == 0:
            return
        chunks = np.asarray(self.store.chunk_of_leaf(rl))
        order = np.argsort(chunks, kind="stable")
        ql, rl, chunks = ql[order], rl[order], chunks[order]
        bounds = np.concatenate([[0], np.nonzero(np.diff(chunks) != 0)[0] + 1, [rl.size]])
        chunk_ids = [int(chunks[b]) for b in bounds[:-1]]
        starts = {c: (int(lo), int(hi)) for c, lo, hi in zip(chunk_ids, bounds[:-1], bounds[1:])}
        for j, buf, leaf_lo in self.store.stream(chunk_ids):
            trace.chunk_visits += 1
            glo, ghi = starts[j]
            for lo, hi, rung in self._batches(ghi - glo):
                lo, hi = glo + lo, glo + hi
                iq, ir = self._pad_pairs((ql, rl - leaf_lo), lo, hi, rung)
                trace.batches += 1
                trace.leaf_pairs += hi - lo
                trace.points_paired += int(self._leaf_sizes[rl[lo:hi]].sum())
                yield buf, ql[lo:hi], rl[lo:hi], rung, iq, ir

    def _chunk_slab(self, j: int, trace: _TraceStats) -> Tuple[torch.Tensor, int]:
        """Device slab for chunk ``j`` with a two-entry cache (pair_count
        needs two chunks at once, which the store's stream cannot serve)."""
        lo, hi = self.store._slab_range(j)
        if j not in self._slab_cache:
            if len(self._slab_cache) >= 2:
                # drop the slab the current chunk-pair group does not use
                self._slab_cache.pop(next(iter(self._slab_cache)))
            self._slab_cache[j] = self.store.host[lo:hi].to(self.device)
            trace.chunk_visits += 1
        return self._slab_cache[j], lo

    # -- warmup ----------------------------------------------------------
    def warm(
        self,
        ops: Sequence[str] = ("radius", "kde", "pair_count"),
        *,
        m: Optional[int] = None,
        n_edges: int = 9,
    ) -> None:
        """Run every leaf-pair function the given ops can hit, at every
        PAIR_RUNGS size (and, for the query-side ops, the QLEAF rung ``m``
        maps to), so a live call meets no new batch shape: new radii,
        bandwidths and edge values are plain operands.  ``n_edges`` is the
        expected pair_count edge count; another count is a new shape."""
        c = self.store.host.shape[0] // self.store.n_chunks
        lp = self.store.host.shape[1]
        buf = torch.full((c, lp, self.d), PAD_COORD, device=self.device)
        mm = int(m) if m else QLEAF
        qh = max(1, math.ceil(math.log2(max(2, -(-mm // QLEAF)))))
        qn = _rung_up(1 << qh, QLEAF_RUNGS)
        qbuf = torch.full((qn, QLEAF, self.d), PAD_COORD, device=self.device)
        edges = np.linspace(0.0, 1.0, int(n_edges)).astype(np.float32)
        bounds = self._dev(_hist_bounds(*_edge_bounds(edges), 0.0))
        edges = self._dev(edges)
        for rung in PAIR_RUNGS:
            iq = torch.zeros(rung, dtype=torch.int64, device=self.device)
            if "radius" in ops:
                _radius_kernel(qbuf, buf, iq, iq)
            band = torch.zeros(rung, device=self.device)
            if "kde" in ops:
                _kde_gauss_kernel(qbuf, buf, iq, iq, 1.0)
                _kde_tophat_kernel(qbuf, buf, iq, iq, 1.0, band, iq, iq)
            if "pair_count" in ops:
                _pair_hist_kernel(buf, buf, iq, iq, iq, iq, edges, bounds)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# Naive all-pairs references (the brute engine's ops + the oracles)
# ---------------------------------------------------------------------------
def _oracle_inputs(queries, points, device, dtype=torch.float32):
    """``queries`` and ``points`` (numpy or tensors, fp32 values) as
    ``dtype`` tensors on ``device`` (default: the points tensor's, else
    cuda:0), copies the oracle owns (``owned_tensor``)."""
    if device is None and isinstance(points, torch.Tensor):
        device = points.device
    dev = resolve_device(device)

    def put(a) -> torch.Tensor:
        return owned_tensor(a, dev).to(dtype)

    return put(queries), put(points)


def radius_brute(
    queries: np.ndarray, points, r: float, *, tile_q: int = 512, device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact all-pairs radius search: the pairs whose direct fp32 squared
    distance (``_direct_d2``) is at most fp32(r^2), CSR like
    ``DualTree.radius`` (indices into ``points``' own ordering).
    ``points`` numpy or a tensor; ``device`` defaults to the tensor's, else
    cuda:0."""
    q_all, pts = _oracle_inputs(queries, points, device)
    m = q_all.shape[0]
    r2 = float(np.float32(float(r) ** 2))
    rows, cols, dists = [], [], []
    for lo in range(0, m, tile_q):
        d2 = _pairwise_direct_d2(q_all[lo:lo + tile_q], pts)
        qi, rj = torch.nonzero(d2 <= r2, as_tuple=True)
        rows.append(qi + lo)
        cols.append(rj)
        dists.append(sqrt(d2[qi, rj]))
    if rows:
        qrow, ridx, dd = torch.cat(rows), torch.cat(cols), torch.cat(dists)
        o1 = torch.sort(dd, stable=True).indices
        order = o1[torch.sort(qrow[o1], stable=True).indices]
        qrow, ridx, dd = (t[order].cpu().numpy() for t in (qrow, ridx, dd))
    else:
        qrow = np.zeros(0, np.int64)
        ridx = np.zeros(0, np.int64)
        dd = np.zeros(0, np.float32)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(qrow, minlength=m), out=indptr[1:])
    return indptr, ridx.astype(np.int64), dd.astype(np.float32)


def kde_brute(
    queries: np.ndarray,
    points,
    bandwidth: float,
    *,
    kernel: str = "gaussian",
    tile_q: int = 512,
    device=None,
) -> np.ndarray:
    """Exact mean kernel value per query: gaussian from float64 distances,
    tophat counting the points whose direct fp32 squared distance
    (``_direct_d2``) is at most fp32(h^2); sums in float64."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel={kernel!r} not in {_KERNELS}")
    gauss = kernel == "gaussian"
    q_all, pts = _oracle_inputs(queries, points, device,
                                torch.float64 if gauss else torch.float32)
    h2 = float(bandwidth) ** 2
    n = pts.shape[0]
    out = []
    for lo in range(0, q_all.shape[0], tile_q):
        if gauss:
            d2 = _pairwise_d2(q_all[lo:lo + tile_q], pts)
            out.append(torch.exp(-d2 / (2.0 * h2)).sum(1) / n)
        else:
            d2 = _pairwise_direct_d2(q_all[lo:lo + tile_q], pts)
            out.append((d2 <= float(np.float32(h2))).sum(1).to(torch.float64) / n)
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy().astype(np.float32)


def pair_count_brute(
    points, edges: np.ndarray, *, tile_q: int = 1024, device=None,
) -> np.ndarray:
    """Exact all-ordered-pairs (i != j) distance histogram: query tiles of
    the points against all points, distances the roots of the direct fp32
    form (``_direct_d2``), then the n self-pairs removed from the bin
    containing 0."""
    pts, _ = _oracle_inputs(points, points, device)
    n = pts.shape[0]
    edges = np.asarray(edges, np.float64).ravel()
    E = edges.size - 1
    edges_dev = torch.as_tensor(edges.astype(np.float32), device=pts.device)
    hist = torch.zeros(E, dtype=torch.int64, device=pts.device)
    for lo in range(0, n, tile_q):
        bins = _bins(sqrt(_pairwise_direct_d2(pts[lo:lo + tile_q], pts)), edges_dev)
        hist += _hist_counts(bins, torch.zeros_like(bins), 1, E)[0]
    hist = hist.cpu().numpy()
    zbin = np.searchsorted(edges, 0.0, side="right")
    if zbin == 0 and edges[0] == 0.0:
        zbin = 1
    if 1 <= zbin <= E:
        hist[zbin - 1] -= n
    return hist
