"""LazySearch: the buffer k-d tree query engine (paper Algorithm 1 + §3.2).

Counterpart of ``repro.core.lazysearch``, with two tiers over one
double-buffered ``ChunkedLeafStore``:

  * ``engine="chunked"`` (default): the chunk-resident bulk-synchronous
    round loop (``chunked_jit.ChunkResidentEngine``);
  * ``engine="host"``: the paper's own host loop (``HostLoop``): query
    queues, per-leaf buffers and ProcessAllBuffers work plans on the host
    (``core/buffers.py``), around the device's traversal, leaf scan and
    merge.

``JitTree`` answers one reference set exactly through the device-resident
fixed point of ``core/jitsearch.py`` (the ``jit`` engine, and each shard of
the ``forest``).

Both tiers end in an exact fp32 re-rank of the selected candidates on the
host (``finalize_candidates``).  A store of fp16/int8
codes runs the engine at ``k + QUANT_OVERFETCH`` and an fp32 store at
``k + FP32_OVERFETCH`` (``_engine_k``); the re-rank from the fp32
``tree.points`` slices back to k, and rows whose answer the quantization
band or the decomposed distance's rounding leaves unproven (``certify``)
are searched again (``BufferKDTree.search``), on either tier.

Defaults follow the paper's footnote 8: for tree height h, buffer capacity
B = 2^(24-h) (capped), the input of the B/2 chunk-visit rule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import traversal
from repro_torch.core.brute import knn_brute
from repro_torch.core.buffers import LeafBuffers, QueryQueues, build_work_plan
from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.chunked_jit import (
    DEFAULT_STARVATION_DEADLINE,
    ChunkResidentEngine,
    scan_merge,
)
from repro_torch.core.jitsearch import RoundsCache, lazy_knn_jit, tree_arrays_from
from repro_torch.core.quantize import (
    QUANT_OVERFETCH,
    QUANT_REFINE_OVERFETCH,
    QuantizedSlabs,
)
from repro_torch.core.toptree import (
    TopTree,
    build_top_tree,
    default_buffer_size,
    suggest_height,
)
from repro_torch.kernels import ops as kops

__all__ = [
    "BufferKDTree",
    "HostLoop",
    "JitTree",
    "PLAN_LADDER",
    "SearchStats",
    "finalize_candidates",
    "orig_ids",
    "certify",
    "FP32_OVERFETCH",
]

# Extra candidates an fp32 store's engine selects beyond k.  The engine
# selects by ||q||^2 - 2 q.x + ||x||^2 in fp32, whose rounding can swap a
# true neighbour out of an exact-k list; with a few more candidates the
# exact re-rank sees past that band and ``certify`` proves the row.  Chosen
# end to end on an H100 (``scripts/fp32_overfetch.py --end-to-end 2,6`` on
# chip_smoke.py's main cell): at 2, 5647 of 2**20 rows stay unproven and
# their second pass (or the jit engine's brute force) costs more than the
# wider list; at 6 none does, and k = 10 + 6 keeps the register list.
FP32_OVERFETCH = 6


def finalize_candidates(
    tree: TopTree, queries: np.ndarray, gi: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact rescoring of engine candidates for a (sub)set of query rows.

    The decomposition ||q||^2 - 2qx + ||x||^2 carries O(eps |q||x|)
    absolute error, which explodes relative to near-zero distances; the k
    selected candidates are recomputed directly ((q-x)^2) and re-sorted.
    ``queries`` f32[r, d], ``gi`` i32[r, k] reordered-global indices ->
    (dists f32[r, k] ascending Euclidean, idx i64[r, k] original ordering).
    """
    safe = np.clip(gi, 0, None)
    diff = tree.points[safe] - queries[:, None, :]
    d2 = np.einsum("mkd,mkd->mk", diff, diff)
    d2[gi < 0] = np.inf
    order = np.argsort(d2, axis=1, kind="stable")
    d2 = np.take_along_axis(d2, order, axis=1)
    gi = np.take_along_axis(gi, order, axis=1)
    return np.sqrt(np.maximum(d2, 0.0)), orig_ids(tree, gi)


def orig_ids(tree: TopTree, ri: np.ndarray) -> np.ndarray:
    """``knn_brute``'s row ids over ``tree.points`` as the caller's original
    ids (i64); -1 ("no finite neighbour": a NaN or overflowing query) stays
    -1, as in ``finalize_candidates``."""
    idx = tree.orig_idx[np.clip(ri, 0, None)].astype(np.int64)
    idx[ri < 0] = -1
    return idx


def certify(queries, d2, dists, k: int, k_eff: int, *, eps: float,
            x_norm_max: float) -> np.ndarray:
    """Rows whose rescored top-k is proven exact (up to ties).

    Every point the engine did not return at width ``k_eff`` has an
    approximate squared distance of at least the k_eff-th one, ``d2[:,
    k_eff-1]`` (leaves pruned by the eps-inflated radius are farther
    still), so its true distance is at least the root of that, less the
    fp32 rounding of the ||q||^2 - 2 q.x + ||x||^2 form (taken off with a
    bound first: ``x_norm_max`` bounds every stored point's norm) and less
    ``eps``, the store's reconstruction bound (0 for fp32).  When this is no
    less than the exact k-th distance ``dists[:, k-1]``, no point left out
    can be nearer.  ``queries`` f32[r, d], ``d2`` f32[r, k_eff] engine
    distances, ``dists`` f32[r, >=k] rescored ones -> bool[r]."""
    d = queries.shape[1]
    qn = np.sqrt(np.sum(queries.astype(np.float64) ** 2, axis=1))
    slack = 2 * (d + 2) * 2.0 ** -24 * (qn + x_norm_max) ** 2
    far = np.sqrt(np.maximum(d2[:, k_eff - 1].astype(np.float64) - slack, 0.0))
    return far - eps >= dists[:, k - 1].astype(np.float64)


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Immutable per-call search statistics (a fresh instance per query)."""

    iterations: int = 0
    flushes: int = 0
    units_scanned: int = 0
    points_scanned: int = 0
    queries_advanced: int = 0
    chunk_rounds: int = 0
    compactions: int = 0     # ladder rungs entered
    steady_rounds: int = 0   # rounds at the full batch shape
    tail_rounds: int = 0     # rounds at a compacted ladder rung
    steady_s: float = 0.0    # wall seconds in steady-state rounds
    tail_s: float = 0.0      # wall seconds in tail (compacted) rounds
    sync_wait_s: float = 0.0  # wall seconds blocked on readbacks/barriers
    chunk_copies: int = 0    # host->device chunk transfers in this call
    early_retired: int = 0   # rows delivered by the streaming hook before
                             # the round loop finished (0 on batch queries)
    refined_rows: int = 0    # rows run again at the wider overfetch
    exact_rows: int = 0      # rows answered by fp32 brute force
    plan_shapes: int = 0     # distinct batch shapes: dual-tree leaf-pair
                             # batches; host loop: padded plan widths
    retested_pairs: int = 0  # dual-tree ops: pairs tested again directly
    # operational events of the call (the mutable index's device loss and
    # re-placement; the facade adds them to ``Plan.reasons``)
    events: Tuple[str, ...] = ()

    @classmethod
    def from_info(cls, info, leaf_pad: int) -> "SearchStats":
        """Stats from ``ChunkResidentEngine.run`` counters (summed over the
        runs of one search)."""
        get = info.get
        return cls(
            iterations=get("iterations", get("rounds", 0)),
            flushes=get("flushes", get("rounds", 0)),
            units_scanned=get("units", 0),
            points_scanned=get("units", 0) * leaf_pad,
            queries_advanced=get("queries_advanced", 0),
            chunk_rounds=get("chunk_rounds", 0),
            compactions=get("compactions", 0),
            steady_rounds=get("steady_rounds", 0),
            tail_rounds=get("tail_rounds", 0),
            steady_s=get("steady_s", 0.0),
            tail_s=get("tail_s", 0.0),
            sync_wait_s=get("sync_wait_s", 0.0),
            chunk_copies=get("chunk_copies", 0),
            early_retired=get("early_retired", 0),
            refined_rows=get("refined_rows", 0),
            exact_rows=get("exact_rows", 0),
            plan_shapes=get("plan_shapes", 0),
        )


# The reference host loop pads every flush's plan width up to one of these
# rungs, which bounds its XLA compiles.  A CUDA launch takes any number of
# units, so the port scans the plan as it is and keeps the rungs only for the
# ``plan_shapes`` statistic.
PLAN_LADDER = (16, 64, 256, 1024, 4096, 16384, 65536)


def _plan_pad(w: int) -> int:
    """Smallest ladder rung >= w (quadrupling beyond the table)."""
    for rung in PLAN_LADDER:
        if w <= rung:
            return rung
    rung = PLAN_LADDER[-1]
    while rung < w:
        rung *= 4
    return rung


class HostLoop:
    """The paper's Algorithm 1 as a host loop (the reference's
    ``engine="host"``, ``repro/core/lazysearch.py:525-612``).

    Per iteration, FindLeafBatch: fetch up to ``fetch_m`` queries from the
    host queues (reinsert first), advance them on the device
    (``traversal.advance``, radius sqrt(k-th distance) + the store's
    ``quant_eps``) and read back their leaf ids, the one readback of an
    iteration: that is the paper's host queue.  Queries that reached a
    leaf go into its buffer.  When a buffer holds B/2 queries (or the
    queues are empty), ProcessAllBuffers: the buffers become a work plan
    (``build_work_plan``), the chunks it touches are streamed
    (``store.stream``), each chunk's units take one leaf-scan launch on the
    resident chunk slot (the kernel reads the codes and the dead mask of a
    quantized store itself) and the merge (``chunked_jit.scan_merge``),
    and the scanned queries exit their leaf and go back to the reinsert
    queue.  The traversal state and the running top-k stay on the device.
    ``run`` has ``ChunkResidentEngine.run``'s interface."""

    def __init__(self, store: ChunkedLeafStore, split_dim, split_val, leaf_start,
                 leaf_size, first_leaf_heap: int, *, backend: str = "auto",
                 fetch_m: int):
        self.store = store
        self._split_dim = split_dim.long()
        self._split_val = split_val
        self._leaf_start = leaf_start
        self._leaf_size = leaf_size
        self.first_leaf_heap = int(first_leaf_heap)
        self.backend = kops.resolve_backend(backend, store.device)
        self.fetch_m = int(fetch_m)
        self._meta = store.device_meta() if store.quantized else (None, None, None)
        self._qeps = float(store.quant_eps)

    def warm(self, m: int, k: int, tq: int) -> int:
        """Nothing to warm: the loop's shapes follow the flushes."""
        return 0

    def run(self, q: torch.Tensor, k: int, tq: int, buffer_size: int, on_retire=None):
        """Returns (sq-dists f32[m, k], reordered-global idx i32[m, k], info
        counters); distances are pre-rescoring.  ``on_retire``, when given,
        receives every row once, at the end."""
        store = self.store
        dev = store.device
        m = q.shape[0]
        q = q.to(dev)
        first_leaf = self.first_leaf_heap
        knn_d = torch.full((m + 1, k), kops.INVALID_DIST, device=dev)
        knn_i = torch.full((m + 1, k), -1, dtype=torch.int32, device=dev)
        st = traversal.init_state(m, dev)
        node, fromc = st.node, st.fromc
        queues = QueryQueues(m)
        buffers = LeafBuffers(store.n_leaves, buffer_size)
        fetch_m = max(tq, min(self.fetch_m, m))
        info = {"iterations": 0, "flushes": 0, "chunk_rounds": 0, "units": 0,
                "queries_advanced": 0}
        widths = set()
        copies_before = store.copies

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        while True:
            progressed = False
            if not queues.empty:
                idx = queues.fetch(fetch_m)
                rows = up(idx.astype(np.int64))
                radius = kops.sqrt(knn_d[rows, k - 1]) + self._qeps
                leaf, adv = traversal.advance(
                    traversal.TraversalState(node[rows], fromc[rows]), q[rows], radius,
                    self._split_dim, self._split_val, first_leaf_heap=first_leaf,
                )
                node[rows], fromc[rows] = adv.node, adv.fromc
                leaf = leaf.cpu().numpy()
                live = leaf >= 0
                buffers.insert(leaf[live], idx[live])
                info["iterations"] += 1
                info["queries_advanced"] += int(idx.size)
                progressed = True

            if buffers.should_flush(force=queues.empty):
                bl, bq = buffers.drain()
                plan = build_work_plan(bl, bq, tq)
                chunk_of_unit = store.chunk_of_leaf(plan.unit_leaf)
                for cid, slab, lo in store.stream(sorted(set(chunk_of_unit.tolist()))):
                    sel = chunk_of_unit == cid
                    w = int(sel.sum())
                    scan_merge(
                        knn_d, knn_i, q, slab, lo, up(plan.unit_leaf[sel] - np.int32(lo)),
                        up(plan.unit_query[sel]), torch.tensor(w, dtype=torch.int32, device=dev),
                        self._leaf_start, self._leaf_size, self._meta, k=k,
                        backend=self.backend,
                    )
                    widths.add((_plan_pad(w), tq))
                    info["chunk_rounds"] += 1
                    info["units"] += w
                # the scanned queries resume by exiting their leaf
                done = np.unique(bq)
                rows = up(done.astype(np.int64))
                ex = traversal.exit_leaf(
                    traversal.TraversalState(node[rows], fromc[rows]), first_leaf)
                node[rows], fromc[rows] = ex.node, ex.fromc
                queues.push_reinsert(done)
                info["flushes"] += 1
                progressed = True

            if queues.empty and buffers.total == 0:
                break
            if not progressed:  # pragma: no cover - safety valve
                raise RuntimeError("LazySearch made no progress (engine bug)")

        d2 = knn_d[:m].cpu().numpy()
        gi = knn_i[:m].cpu().numpy()
        if on_retire is not None:
            on_retire(np.arange(m), d2, gi)
        info["plan_shapes"] = len(widths)
        info["chunk_copies"] = store.copies - copies_before
        return d2, gi, info


class BufferKDTree:
    """Buffer k-d tree: build + LazySearch queries on the ``chunked`` or
    the ``host`` tier.

    Example:
        index = BufferKDTree(points, height=9, n_chunks=3,
                             device=torch.device("cuda", 0))
        dists, idx = index.query(queries, k=10)
        index.stats          # immutable stats of the LAST query

    ``store_state`` (a snapshot's ``QuantizedSlabs``) is adopted as the
    store's codes instead of quantizing the points again.
    ``live`` (bool[n] over ``points``; default every row) marks the rows
    that can be answers: the certificate bounds its rounding by their norms
    only (the mutable index's padding and deleted rows are left out).  The
    array is held, not copied: a caller that deletes rows clears their bits
    and writes PAD_COORD into them.
    """

    def __init__(
        self,
        points: np.ndarray,
        *,
        height: Optional[int] = None,
        n_chunks: int = 1,
        buffer_size: Optional[int] = None,
        fetch_m: Optional[int] = None,
        backend: str = "auto",
        tile_q: int = 128,
        device=None,
        engine: str = "chunked",
        starvation_deadline: int = DEFAULT_STARVATION_DEADLINE,
        tree: Optional[TopTree] = None,
        precision: str = "fp32",
        store_state: Optional[QuantizedSlabs] = None,
        live: Optional[np.ndarray] = None,
    ):
        if engine not in ("chunked", "host"):
            raise ValueError(f"engine={engine!r} not in ('chunked', 'host')")
        self.engine = engine
        self.device = kops.resolve_device(device)
        points = np.asarray(points, dtype=np.float32)
        n, d = points.shape
        if tree is not None:
            # adopt a prebuilt tree (e.g. one built by the JAX reference
            # and carried over as arrays): no second median build
            if tree.n != n or tree.d != d:
                raise ValueError(
                    f"prebuilt tree is for [{tree.n}, {tree.d}] points, got [{n}, {d}]"
                )
            self.tree = tree
        else:
            self.tree = build_top_tree(
                points, height if height is not None else suggest_height(n)
            )
        # the caller's mask of the rows that can be answers (None: every
        # row); held, not copied, so the bound sees the bits deletes clear
        self._live = live
        h = self.tree.height
        self.tile_q = int(tile_q)
        # slabs keep the points' own width d: the kernel pads each row with
        # zeros in registers and shared memory, so the device holds no pad
        # columns
        if store_state is not None:
            # a snapshot's codes, at the points' width d (a snapshot written
            # by the reference carries codes padded to a multiple of 8)
            store_state = dataclasses.replace(
                store_state, codes=np.ascontiguousarray(store_state.codes[..., :d]),
                scale=np.ascontiguousarray(store_state.scale[:, :d]),
                offset=np.ascontiguousarray(store_state.offset[:, :d]))
        self.store = ChunkedLeafStore(
            self.tree.points_padded if store_state is None else store_state,
            n_chunks=n_chunks, device=self.device, uniform=True,
            precision=precision, leaf_sizes=self.tree.leaf_sizes(),
        )
        self.precision = self.store.precision
        self.buffer_size = int(
            buffer_size if buffer_size is not None else default_buffer_size(h)
        )
        self.fetch_m = int(fetch_m) if fetch_m is not None else 10 * self.buffer_size
        self._last_stats = SearchStats()

        resolved = kops.resolve_backend(backend, self.device)
        # the host loop scans at the tile asked for (as the reference's)
        self.engine_tile_q = (self.tile_q if engine == "host"
                              else kops.engine_tile_q(self.tile_q, resolved))

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        tree_args = (
            self.store,
            dev(self.tree.split_dim),
            dev(self.tree.split_val),
            dev(self.tree.leaf_start),
            dev(self.tree.leaf_sizes().astype(np.int32)),
            self.tree.first_leaf_heap,
        )
        if engine == "host":
            self._engine = HostLoop(*tree_args, backend=resolved, fetch_m=self.fetch_m)
        else:
            self._engine = ChunkResidentEngine(
                *tree_args, backend=resolved, starvation_deadline=starvation_deadline)

    @property
    def n(self) -> int:
        return self.tree.n

    @property
    def d(self) -> int:
        return self.tree.d

    @property
    def stats(self) -> SearchStats:
        """Stats of the most recent ``query`` call (immutable snapshot)."""
        return self._last_stats

    def _engine_k(self, k: int) -> int:
        """Selection width the engine runs at: quantized stores overfetch so
        the exact fp32 re-rank sees past the quantization selection band
        (``quantize.QUANT_OVERFETCH``), fp32 stores past the decomposed
        distance's rounding (``FP32_OVERFETCH``; the reference runs fp32 at
        k)."""
        extra = QUANT_OVERFETCH if self.store.quantized else FP32_OVERFETCH
        return min(k + extra, self.n)

    def warm(self, m: int, k: int = 10) -> None:
        """Run the chunk round once at the full shape of a batch of ``m``
        and at every compaction-ladder rung (builds the kernel); nothing
        for the host tier."""
        self._engine.warm(m, self._engine_k(k), self.engine_tile_q)

    def dualtree(self):
        """The dual-tree view over this index's TopTree and leaf store
        (``core/dualtree.DualTree``: radius / kde / pair_count), made once:
        node boxes are computed at the first call, and a quantized store
        gets a private fp32 store at width d so the ops stay exact."""
        if getattr(self, "_dualtree", None) is None:
            from repro_torch.core.dualtree import DualTree

            self._dualtree = DualTree(self.tree, self.store)
        return self._dualtree

    def check_queries(self, queries: np.ndarray, k: int) -> np.ndarray:
        """``queries`` as f32[m, d], after checking them and k."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.d:
            raise ValueError(f"queries must be [m, {self.d}], got {queries.shape}")
        if k > self.n:
            raise ValueError(f"k={k} > n={self.n}")
        return queries

    def _certified(self, queries, d2, dists, k: int, k_eff: int) -> np.ndarray:
        """Rows whose rescored top-k is proven exact (``certify``, with the
        store's eps: 0 for fp32).  A k_eff reaching n is exact by
        construction."""
        if k_eff >= self.n:
            return np.ones(len(queries), bool)
        return certify(queries, d2, dists, k, k_eff, eps=self.store.quant_eps,
                       x_norm_max=self._x_norm_max)

    @functools.cached_property
    def _x_norm_max(self) -> float:
        """Largest norm a dequantized live point can have (bounds fp32
        error): over every row, or over the rows ``live`` marks when it is
        first needed.  The mutable index pads its tree shards to their rung
        with PAD_COORD rows and writes it into deleted rows
        (``core/dynamic.py``); a 1e18 norm would make every row's slack
        ~1e31, so no row would be proven.  Such rows cannot be an answer's
        neighbour (they rank after every live row), so the bound over the
        live rows is the one ``certify`` needs.  Kills only remove rows, so
        a value cached before them still bounds."""
        pts = self.tree.points
        if self._live is not None:
            pts = pts[np.asarray(self._live, bool)[self.tree.orig_idx]]
        if pts.shape[0] == 0:
            return self.store.quant_eps
        norms = np.sqrt(np.sum(pts.astype(np.float64) ** 2, axis=1))
        return float(norms.max()) + self.store.quant_eps

    def _exact_rows(self, queries: np.ndarray, k: int):
        """fp32 brute force of a few rows over the host points, one tile of
        points on the device at a time (the last resort of ``search``)."""
        dists, ri = knn_brute(queries, self.tree.points, k, device=self.device)
        return dists, orig_ids(self.tree, ri)

    def search(self, queries: np.ndarray, k: int, emit=None):
        """Exact top-k of every row: ``(dists f32[m, k], idx i64[m, k],
        SearchStats)``.  ``emit(rows, dists, idx)``, when given, receives
        each row's final answer once, as soon as it is known (the streaming
        path: rows retire during the round loop).

        The engine runs at ``_engine_k(k)`` (``k + QUANT_OVERFETCH`` for
        codes, as the reference does; ``k + FP32_OVERFETCH`` for fp32, where
        the reference runs at k), the candidates are rescored exactly, and
        the rows ``_certified`` proves are kept; the rest run again at
        ``k + QUANT_REFINE_OVERFETCH``, and rows still unproven take fp32
        brute force.  (The reference keeps the first run's answer, which
        can miss a true neighbour: at int8 when more than QUANT_OVERFETCH
        points lie within the quantization band of the k-th, at fp32 when
        the decomposed distance's rounding swaps the k-th out.)"""
        m = queries.shape[0]
        out_d = np.empty((m, k), np.float32)
        out_i = np.full((m, k), -1, np.int64)
        totals: dict = {}
        rows = np.arange(m)
        passes = [self._engine_k(k), min(k + QUANT_REFINE_OVERFETCH, self.n)]
        for p, k_eff in enumerate(passes):
            if rows.size == 0 or (p > 0 and k_eff <= passes[p - 1]):
                break
            q_rows = queries[rows]
            open_rows = []

            def deliver(rr, d2, gi, q_rows=q_rows, rows=rows, k_eff=k_eff,
                        open_rows=open_rows):
                dists, idx = finalize_candidates(self.tree, q_rows[rr], gi)
                ok = self._certified(q_rows[rr], d2, dists, k, k_eff)
                done = rows[rr[ok]]
                out_d[done] = dists[ok, :k]
                out_i[done] = idx[ok, :k]
                if emit is not None and done.size:
                    emit(done, out_d[done], out_i[done])
                open_rows.append(rows[rr[~ok]])

            q = torch.from_numpy(np.ascontiguousarray(q_rows)).to(self.device)
            d2, gi, info = self._engine.run(
                q, k_eff, self.engine_tile_q, self.buffer_size,
                on_retire=deliver if emit is not None else None,
            )
            if emit is None:
                deliver(np.arange(rows.size), d2, gi)
            for key, v in info.items():
                totals[key] = totals.get(key, 0) + v
            if p > 0:
                totals["refined_rows"] = totals.get("refined_rows", 0) + rows.size
            rows = np.concatenate(open_rows) if open_rows else rows[:0]
        if rows.size:
            dists, idx = self._exact_rows(queries[rows], k)
            out_d[rows], out_i[rows] = dists, idx
            if emit is not None:
                emit(rows, dists, idx)
            totals["exact_rows"] = int(rows.size)
        return out_d, out_i, SearchStats.from_info(totals, self.store.host.shape[1])

    def query(
        self, queries: np.ndarray, k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest neighbors for every query: (dists f32[m, k] ascending
        Euclidean, idx i64[m, k] into the caller's original ordering)."""
        queries = self.check_queries(queries, k)
        dists, idx, self._last_stats = self.search(queries, k)
        return dists, idx


class JitTree:
    """One reference set answered exactly by the device-resident fixed point
    (``jitsearch.lazy_knn_jit``): the state of the ``jit`` engine and of
    each ``forest`` shard.  ``top`` is the host tree, ``tree`` its arrays on
    ``device``, ``rounds`` the ``RoundsCache`` of its captured rounds (one
    per tree, so each device slot replays its own CUDA graphs).

    ``query`` selects ``FP32_OVERFETCH`` candidates beyond k, rescores them
    exactly on the device and keeps the rows ``certify`` proves at eps = 0;
    the rest take fp32 brute force over ``top.points``.  Ids are the
    caller's original ordering of ``top``'s points."""

    def __init__(self, top: TopTree, device, *, tile_q: int = 128, backend: str = "auto"):
        dev = kops.resolve_device(device)
        self.top = top
        self.backend = kops.resolve_backend(backend, dev)
        self.tree = tree_arrays_from(top, dev)
        self.tq = kops.engine_tile_q(tile_q, self.backend)
        norms = np.sqrt(np.sum(top.points.astype(np.float64) ** 2, axis=1))
        self.x_norm_max = float(norms.max())   # bounds the fp32 rounding in certify
        self.rounds = RoundsCache()

    def query(self, queries: np.ndarray, k: int):
        """(dists f32[m, k] ascending Euclidean, ids i64[m, k], SearchStats)."""
        top, n = self.top, self.top.n
        m = queries.shape[0]
        k_eff = min(k + FP32_OVERFETCH, n)
        q = kops.owned_tensor(queries, self.tree.slabs.device)
        d2, oi, rounds = lazy_knn_jit(
            q, self.tree, k=k_eff, tq=self.tq, first_leaf_heap=top.first_leaf_heap,
            backend=self.backend, cache=self.rounds,
        )
        raw = self.rounds[(m, k_eff)].knn_d[:m].cpu().numpy()
        dists = np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))
        idx = oi.cpu().numpy()
        ok = np.ones(m, bool) if k_eff >= n else certify(
            queries, raw, dists, k, k_eff, eps=0.0, x_norm_max=self.x_norm_max)
        dists, idx = dists[:, :k].copy(), idx[:, :k].copy()
        rows = np.nonzero(~ok)[0]
        if rows.size:
            bd, bi = knn_brute(queries[rows], top.points, k, device=q.device)
            dists[rows], idx[rows] = bd, orig_ids(top, bi)
        stats = SearchStats(iterations=rounds, queries_advanced=rounds * m,
                            exact_rows=int(rows.size))
        return dists.astype(np.float32), idx.astype(np.int64), stats

    def warm(self, m: int, k: int) -> None:
        """Run the round once for a batch of ``m`` at ``k`` and capture it
        (on CUDA), so the first query only replays."""
        k_eff = min(k + FP32_OVERFETCH, self.top.n)
        q = torch.zeros((m, self.top.d), device=self.tree.slabs.device)
        lazy_knn_jit(q, self.tree, k=k_eff, tq=self.tq, first_leaf_heap=self.top.first_leaf_heap,
                     backend=self.backend, cache=self.rounds, max_rounds=1)
