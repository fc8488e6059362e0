"""``KNNIndex``: the front door (counterpart of ``repro.api.index``).

    from repro_torch.api import KNNIndex

    index = KNNIndex.build(points)            # planner picks the engine
    dists, idx = index.query(queries, k=10)   # QueryResult, tuple-unpackable

With ``IndexSpec.devices`` unset the index runs on ``cuda:0`` and raises
without a card; pass ``devices=(torch.device("cpu"),)`` for the CPU.
``query_stream`` delivers per-row results on an index built with
``IndexSpec(engine="streaming")``; ``radius``, ``kde`` and ``pair_count``
run the dual-tree ops on the engines that declare them (``caps.ops``), and
raise the typed ``OpUnsupported`` elsewhere.  Persistence and mutation
wait for their ROADMAP items; their entry points raise the reference's
typed errors.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.api.engine import (
    KNOWN_OPS,
    EngineBase,
    MutabilityError,
    OpUnsupported,
    StreamingUnsupported,
    available_engines,
    get_engine,
)
from repro_torch.api.planner import Plan, default_devices, plan as make_plan
from repro_torch.api.spec import (
    IndexSpec,
    QueryResult,
    RadiusResult,
    SearchStats,
    StatResult,
)

__all__ = ["KNNIndex"]


class KNNIndex:
    """A built kNN index: points + a planned engine + its opaque state."""

    def __init__(self, *, spec: IndexSpec, plan: Plan, engine: EngineBase,
                 state, n: int, d: int):
        self.spec = spec
        self.plan = plan
        self._engine = engine
        self._state = state
        self.n = n
        self.d = d
        self._last_stats: Optional[SearchStats] = None
        # engines declaring stateful_query stream chunk slots during a
        # query: one batch at a time per index
        self._qlock = threading.Lock() if engine.caps.stateful_query else None

    def _serialized(self, fn, *args):
        if self._qlock is None:
            return fn(*args)
        with self._qlock:
            return fn(*args)

    @classmethod
    def build(
        cls, points: np.ndarray, spec: Optional[IndexSpec] = None, **overrides
    ) -> "KNNIndex":
        """Plan + build an index over ``points``."""
        spec = spec or IndexSpec()
        if overrides:
            spec = spec.replace(**overrides)
        points = np.asarray(points, dtype=np.float32)
        if points.ndim != 2:
            raise ValueError(f"points must be [n, d], got {points.shape}")
        n, d = points.shape
        if spec.devices is None:
            spec = spec.replace(devices=default_devices())
        pl = make_plan(
            n, d,
            m=spec.m_hint,
            k=spec.k_hint,
            devices=spec.devices,
            memory_budget=spec.memory_budget,
            engine=spec.engine,
            height=spec.height,
            n_chunks=spec.n_chunks,
            n_shards=spec.n_shards,
            buffer_size=spec.buffer_size,
            tile_q=spec.tile_q,
            backend=spec.backend,
            precision=spec.precision,
            strict_budget=spec.strict_budget,
            op=spec.op,
        )
        engine = get_engine(pl.engine)
        state = engine.build(points, spec, pl)
        return cls(spec=spec, plan=pl, engine=engine, state=state, n=n, d=d)

    def _check_queries(self, queries) -> np.ndarray:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.d:
            raise ValueError(f"queries must be [m, {self.d}], got {queries.shape}")
        return queries

    def query(self, queries: np.ndarray, k: Optional[int] = None) -> QueryResult:
        """k nearest neighbors of every query row (``k`` defaults to the
        spec's ``k_hint``)."""
        k = int(k) if k is not None else self.spec.k_hint
        queries = self._check_queries(queries)
        if k > self.n:
            raise ValueError(f"k={k} > n={self.n}")
        dists, idx, stats = self._serialized(
            self._engine.query, self._state, queries, k
        )
        self._last_stats = stats
        return QueryResult(dists=dists, idx=idx, stats=stats,
                           engine=self.plan.engine, k=k)

    def _require_op(self, op: str) -> None:
        if op not in self._engine.caps.ops:
            raise OpUnsupported(
                f"engine {self.engine_name!r} does not declare op {op!r} "
                f"(caps.ops={sorted(self._engine.caps.ops)}); build with "
                f"IndexSpec(op={op!r}) so the planner picks a declaring "
                f"engine ({sorted(available_engines(op=op))})"
            )

    def radius(self, queries: np.ndarray, r: float) -> RadiusResult:
        """All reference points within Euclidean distance ``r`` of each
        query row (inclusive of ``dist == r``): a ``RadiusResult``, CSR over
        query rows, unpacking as ``(indptr, indices, dists)``; ``indices``
        i64 into the caller's original ``points`` ordering, ``dists``
        ascending per row.  Engines not declaring "radius" raise
        ``OpUnsupported``."""
        self._require_op("radius")
        r = float(r)
        if not r >= 0.0:
            raise ValueError(f"need r >= 0, got {r}")
        queries = self._check_queries(queries)
        indptr, indices, dists, stats = self._serialized(
            self._engine.radius, self._state, queries, r
        )
        self._last_stats = stats
        return RadiusResult(indptr=indptr, indices=indices, dists=dists, stats=stats,
                            engine=self.plan.engine, r=r)

    def kde(self, queries: np.ndarray, bandwidth: float, *, rtol: float = 1e-2,
            atol: float = 1e-9, kernel: str = "gaussian") -> StatResult:
        """Kernel density at each query row over the reference points (the
        mean of ``K(||q - x|| / bandwidth)``, gaussian or tophat): a
        ``StatResult`` unpacking as ``(densities f32[m], error_bound)``,
        with ``|approx - exact| <= rtol * exact + atol`` (tophat exact)."""
        self._require_op("kde")
        bandwidth = float(bandwidth)
        if not bandwidth > 0.0:
            raise ValueError(f"need bandwidth > 0, got {bandwidth}")
        queries = self._check_queries(queries)
        dens, err, stats = self._serialized(
            lambda: self._engine.kde(self._state, queries, bandwidth, rtol=rtol,
                                     atol=atol, kernel=kernel)
        )
        self._last_stats = stats
        return StatResult(values=dens, error_bound=float(err), stats=stats,
                          engine=self.plan.engine, op="kde")

    def pair_count(self, edges) -> StatResult:
        """2-point correlation: the histogram of all ordered cross-pair
        distances of the reference set over ``edges`` (np.histogram
        semantics, self-pairs excluded): a ``StatResult`` unpacking as
        ``(hist i64[len(edges) - 1], 0.0)`` (the op is exact)."""
        self._require_op("pair_count")
        edges = np.asarray(edges, dtype=np.float64).ravel()
        if edges.size < 2 or not np.all(np.diff(edges) > 0):
            raise ValueError("edges must be >= 2 strictly increasing values")
        if edges[0] < 0:
            raise ValueError("distance edges must be >= 0")
        hist, stats = self._serialized(self._engine.pair_count, self._state, edges)
        self._last_stats = stats
        return StatResult(values=hist, error_bound=0.0, stats=stats,
                          engine=self.plan.engine, op="pair_count")

    def insert(self, points: np.ndarray):
        raise MutabilityError(
            f"engine {self.engine_name!r} is immutable; the mutable engine "
            "is ROADMAP Queue 1 item 14"
        )

    def delete(self, ids):
        raise MutabilityError(
            f"engine {self.engine_name!r} is immutable; the mutable engine "
            "is ROADMAP Queue 1 item 14"
        )

    def query_stream(self, queries, k=None, *, on_complete) -> QueryResult:
        """k nearest neighbors with per-row streaming delivery.

        ``on_complete(rows, dists, idx)`` is called from inside the round
        loop as query rows retire, each row exactly once, with the values
        ``query`` returns; the assembled ``QueryResult`` is returned after
        the last delivery.  The callback runs on the calling thread.
        Engines that do not declare ``caps.streaming`` raise the typed
        ``StreamingUnsupported``: build with ``IndexSpec(engine="streaming")``.
        """
        if not self._engine.caps.streaming:
            raise StreamingUnsupported(
                f"engine {self.engine_name!r} cannot stream per-row "
                "completions (caps.streaming=False); build with "
                "IndexSpec(engine='streaming')"
            )
        k = int(k) if k is not None else self.spec.k_hint
        queries = self._check_queries(queries)
        if k > self.n:
            raise ValueError(f"k={k} > n={self.n}")
        dists, idx, stats = self._serialized(
            self._engine.query_stream, self._state, queries, k, on_complete
        )
        self._last_stats = stats
        return QueryResult(dists=dists, idx=idx, stats=stats,
                           engine=self.plan.engine, k=k)

    def warm(self, m: Optional[int] = None, k: Optional[int] = None, *,
             ops: Optional[tuple] = None, n_edges: int = 9) -> None:
        """Run the execution path of the given ``ops`` (default: the spec's
        primary ``op``) once for batches of ``m`` queries, before the first
        call.  For "knn" at ``k`` (default ``k_hint``): the chunked engine's
        round at the full shape and every ladder rung (this builds the
        kernel), the jit engine's round and its CUDA graph.  For the
        dual-tree ops, their leaf-pair functions at every rung shape
        (``n_edges`` = expected pair_count edge count); an engine that does
        not declare an op raises ``OpUnsupported``."""
        ops = tuple(ops) if ops is not None else (self.spec.op,)
        for op in ops:
            if op not in KNOWN_OPS:
                raise ValueError(f"unknown op {op!r}; known: {sorted(KNOWN_OPS)}")
        k = int(k) if k is not None else self.spec.k_hint
        mm = int(m) if m is not None else (self.spec.m_hint or self.spec.tile_q)
        if "knn" in ops:
            self._serialized(self._engine.warm, self._state, mm, k)
        dual = tuple(op for op in ops if op != "knn")
        if dual:
            for op in dual:
                self._require_op(op)
            self._serialized(self._engine.warm_ops, self._state, dual,
                             int(m) if m is not None else self.spec.m_hint, n_edges)

    @property
    def engine_name(self) -> str:
        return self.plan.engine

    @property
    def height(self) -> int:
        return self.plan.height

    @property
    def stats(self) -> SearchStats:
        """Stats of the most recent ``query`` (empty before the first)."""
        return self._last_stats if self._last_stats is not None else SearchStats()

    def resident_bytes(self) -> int:
        """Per-device bytes the reference structure occupies."""
        return self._engine.resident_bytes(self.plan, self._state)

    def describe(self) -> str:
        """Human-readable plan summary (engine, parameters, reasons)."""
        pl = self.plan
        lines = [
            f"KNNIndex: n={self.n} d={self.d} engine={pl.engine} "
            f"h={pl.height} n_chunks={pl.n_chunks} n_shards={pl.n_shards} "
            f"B={pl.buffer_size} precision={pl.precision} "
            f"resident~{pl.resident_bytes / 1e6:.1f}MB",
        ]
        lines += [f"  - {r}" for r in pl.reasons]
        return "\n".join(lines)
