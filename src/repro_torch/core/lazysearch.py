"""LazySearch: the buffer k-d tree query engine (paper Algorithm 1 + §3.2).

Counterpart of ``repro.core.lazysearch`` on the ``chunked`` engine: the
chunk-resident bulk-synchronous round loop
(``chunked_jit.ChunkResidentEngine``) over a double-buffered
``ChunkedLeafStore``, followed by an exact fp32 re-rank of the selected
candidates on the host (``finalize_candidates``).  A store of fp16/int8
codes runs the engine at ``k + QUANT_OVERFETCH`` and an fp32 store at
``k + FP32_OVERFETCH`` (``_engine_k``); the re-rank from the fp32
``tree.points`` slices back to k, and rows whose answer the quantization
band or the decomposed distance's rounding leaves unproven (``certify``)
are searched again (``BufferKDTree.search``).  The paper-faithful host loop
(``engine="host"``) is not ported yet (ROADMAP Queue 1 item 17).

Defaults follow the paper's footnote 8: for tree height h, buffer capacity
B = 2^(24-h) (capped), the input of the B/2 chunk-visit rule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.brute import knn_brute
from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.chunked_jit import (
    DEFAULT_STARVATION_DEADLINE,
    ChunkResidentEngine,
)
from repro_torch.core.quantize import QUANT_OVERFETCH, QUANT_REFINE_OVERFETCH
from repro_torch.core.toptree import (
    TopTree,
    build_top_tree,
    default_buffer_size,
    suggest_height,
)
from repro_torch.kernels import ops as kops

__all__ = [
    "BufferKDTree",
    "SearchStats",
    "finalize_candidates",
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
    dists = np.sqrt(np.maximum(d2, 0.0))
    idx_out = tree.orig_idx[np.clip(gi, 0, None)].astype(np.int64)
    idx_out[gi < 0] = -1
    return dists, idx_out


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
    plan_shapes: int = 0     # dual-tree ops: distinct leaf-pair batch shapes

    @classmethod
    def from_info(cls, info, leaf_pad: int) -> "SearchStats":
        """Stats from ``ChunkResidentEngine.run`` counters (summed over the
        runs of one search)."""
        get = info.get
        return cls(
            iterations=get("rounds", 0),
            flushes=get("rounds", 0),
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
        )


class BufferKDTree:
    """Buffer k-d tree: build + LazySearch queries on the chunked engine.

    Example:
        index = BufferKDTree(points, height=9, n_chunks=3,
                             device=torch.device("cuda", 0))
        dists, idx = index.query(queries, k=10)
        index.stats          # immutable stats of the LAST query
    """

    def __init__(
        self,
        points: np.ndarray,
        *,
        height: Optional[int] = None,
        n_chunks: int = 1,
        buffer_size: Optional[int] = None,
        backend: str = "auto",
        tile_q: int = 128,
        device=None,
        engine: str = "chunked",
        starvation_deadline: int = DEFAULT_STARVATION_DEADLINE,
        tree: Optional[TopTree] = None,
        precision: str = "fp32",
    ):
        if engine != "chunked":
            if engine == "host":
                raise NotImplementedError(
                    "engine='host' (the paper-faithful host loop) is not "
                    "ported yet: ROADMAP Queue 1 item 17"
                )
            raise ValueError(f"engine={engine!r} not in ('chunked',)")
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
        h = self.tree.height
        self.tile_q = int(tile_q)
        # slabs keep the points' own width d: the kernel pads each row with
        # zeros in registers and shared memory, so the device holds no pad
        # columns
        self.store = ChunkedLeafStore(
            self.tree.points_padded, n_chunks=n_chunks, device=self.device,
            uniform=True, precision=precision,
            leaf_sizes=self.tree.leaf_sizes(),
        )
        self.precision = self.store.precision
        self.buffer_size = int(
            buffer_size if buffer_size is not None else default_buffer_size(h)
        )
        self._last_stats = SearchStats()

        resolved = kops.resolve_backend(backend, self.device)
        self.engine_tile_q = kops.engine_tile_q(self.tile_q, resolved)

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self._engine = ChunkResidentEngine(
            self.store,
            dev(self.tree.split_dim),
            dev(self.tree.split_val),
            dev(self.tree.leaf_start),
            dev(self.tree.leaf_sizes().astype(np.int32)),
            self.tree.first_leaf_heap,
            backend=resolved,
            starvation_deadline=starvation_deadline,
        )

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
        and at every compaction-ladder rung (builds the kernel)."""
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
        """Largest norm a dequantized point can have (bounds fp32 error)."""
        norms = np.sqrt(np.sum(self.tree.points.astype(np.float64) ** 2, axis=1))
        return float(norms.max()) + self.store.quant_eps

    def _exact_rows(self, queries: np.ndarray, k: int):
        """fp32 brute force of a few rows over the host points, one tile of
        points on the device at a time (the last resort of ``search``)."""
        dists, ri = knn_brute(queries, self.tree.points, k, device=self.device)
        return dists, self.tree.orig_idx[ri].astype(np.int64)

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
