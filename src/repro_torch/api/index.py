"""``KNNIndex``: the front door (counterpart of ``repro.api.index``).

    from repro_torch.api import KNNIndex

    index = KNNIndex.build(points)            # planner picks the engine
    dists, idx = index.query(queries, k=10)   # QueryResult, tuple-unpackable

With ``IndexSpec.devices`` unset the index runs on every visible CUDA
device, one slot each, and raises without a card; pass
``devices=(torch.device("cpu"),)`` for the CPU.  More than one slot (a
device may repeat: ``(cuda:0,) * 4`` is four slots on one card) plans the
``forest`` or ``sharded`` engine (planner rule 3); ``ring`` is pinned.
``query_stream`` delivers per-row results on an index built with
``IndexSpec(engine="streaming")`` (whole batches on the ``dynamic``
engine); ``radius``, ``kde`` and ``pair_count`` run the dual-tree ops on
the engines that declare them (``caps.ops``), and raise the typed
``OpUnsupported`` elsewhere.  ``IndexSpec(mutable=True)`` plans the
``dynamic`` engine: ``insert`` / ``delete`` (each appended to the WAL once
the engine has applied it, before it returns) and ``drain`` for its
background merges; other engines raise ``MutabilityError``.  ``save`` /
``load`` write and read snapshots in the reference's format
(``repro_torch.persist``), so either package loads the other's, and
``load`` replays the WAL records acknowledged after the snapshot.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import tracing
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
from repro_torch.persist import PersistError, VersionStore, WriteAheadLog

__all__ = ["KNNIndex"]

# IndexSpec fields a snapshot manifest records (the reference's list): the
# host-bound ones (devices, persist_dir, a measured calibration) are not in it
_SPEC_MANIFEST_FIELDS = (
    "engine", "op", "height", "n_chunks", "n_shards", "buffer_size",
    "tile_q", "backend", "k_hint", "m_hint", "memory_budget", "precision",
    "strict_budget", "mutable", "merge_async", "snapshot_keep", "wal_fsync",
)
_BACKENDS = ("auto", "cuda", "ref")


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
        # the persisted lifecycle (spec.persist_dir / load): snapshot store,
        # WAL and acknowledged-mutation count; None / 0 in memory only
        self._store: Optional[VersionStore] = None
        self._wal: Optional[WriteAheadLog] = None
        self._mutation_seq: int = 0
        self._extra_arrays: Dict[str, np.ndarray] = {}
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
        """Plan + build an index over ``points`` (host span ``build``, with
        ``build.plan`` and the engine's ``build.tree`` / ``build.upload``)."""
        spec = spec or IndexSpec()
        if overrides:
            spec = spec.replace(**overrides)
        points = np.asarray(points, dtype=np.float32)
        if points.ndim != 2:
            raise ValueError(f"points must be [n, d], got {points.shape}")
        n, d = points.shape
        if spec.devices is None:
            spec = spec.replace(devices=default_devices())
        with tracing.span("build"):
            with tracing.span("build.plan"):
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
                    mutable=spec.mutable,
                    merge_async=spec.merge_async,
                    calibration=spec.calibration,
                )
            engine = get_engine(pl.engine)
            state = engine.build(points, spec, pl)
        idx = cls(spec=spec, plan=pl, engine=engine, state=state, n=n, d=d)
        if spec.persist_dir:
            idx._init_persistence()
        return idx

    # -- persistence (counterpart of repro/api/index.py:183-340) ---------
    def _init_persistence(self) -> None:
        """Root a fresh persist dir: a baseline snapshot and an empty WAL.
        A directory that already holds versions is refused: resume it with
        ``KNNIndex.load``."""
        root = self.spec.persist_dir
        store = VersionStore(os.path.join(root, "versions"))
        if store.versions():
            raise PersistError(
                f"persist_dir {root!r} already holds snapshot versions; "
                "resume it with KNNIndex.load(...) or point build at a "
                "fresh directory"
            )
        self._store = store
        self._wal = WriteAheadLog(os.path.join(root, "wal"), fsync=self.spec.wal_fsync)
        self.plan = self.plan.replace(reasons=self.plan.reasons + (
            f"persistence: versioned snapshots + mutation WAL at {root}",
        ))
        self.save()

    def save(self, path: Optional[str] = None, *,
             extra_arrays: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Write one complete snapshot version; returns its number.

        With ``path=None`` the version goes to the index's persist dir
        (``spec.persist_dir``; an error without one), the WAL rotates to a
        fresh segment and segments no kept snapshot needs are dropped.  A
        ``path`` writes a one-off export.  ``extra_arrays`` ride along
        under ``extra/`` and come back from ``load``.  Crash-atomic: a
        version is complete (manifest present) or invisible to ``load``."""
        if path is None:
            if self._store is None:
                raise PersistError(
                    "index has no live persist dir: build with "
                    "IndexSpec(persist_dir=...) or pass save(path=...)"
                )
            store = self._store
        else:
            store = VersionStore(os.path.join(path, "versions"))
        arrays, meta = self._serialized(self._engine.snapshot_state, self._state)
        arrays = dict(arrays)
        for key, value in (extra_arrays or self._extra_arrays).items():
            arrays[f"extra/{key}"] = np.asarray(value)
        pl = self.plan
        manifest = {
            "engine": pl.engine,
            "n": int(self.n),
            "d": int(self.d),
            "mutation_seq": int(self._mutation_seq),
            "spec": {f: getattr(self.spec, f) for f in _SPEC_MANIFEST_FIELDS},
            # the built geometry, so load plans the layout the state has
            "plan": {"height": pl.height, "n_chunks": pl.n_chunks,
                     "n_shards": pl.n_shards, "buffer_size": pl.buffer_size},
            "meta": meta,
            "created": time.time(),
        }
        version = store.commit(arrays, manifest, keep=max(1, self.spec.snapshot_keep))
        if store is self._store and self._wal is not None:
            self._wal.rotate(self._mutation_seq)
            kept = store.versions()
            self._wal.gc(min(int(store.read_manifest(v)["mutation_seq"]) for v in kept))
        return version

    @classmethod
    def load(cls, path: str, *, devices=None) -> "KNNIndex":
        """Restore an index from a persist dir (the port's or the
        reference's): the latest complete snapshot, then a replay of the
        WAL records acknowledged after it (inserts and deletes of a mutable
        index).  The state is restored onto ``devices`` (default: every
        visible CUDA device); the snapshot itself is host-side and holds no
        device.  The loaded index continues the same lifecycle: later
        mutations append to the same WAL, a later ``save()`` adds a
        version."""
        store = VersionStore(os.path.join(path, "versions"))
        # copy-on-write mmap: the bulk arrays page in as they are read
        arrays, manifest, version = store.read(mmap=True)
        devs = tuple(devices) if devices else default_devices()
        fields = {f.name for f in dataclasses.fields(IndexSpec)}
        pins = manifest["plan"]
        spec = IndexSpec(**{k: v for k, v in manifest["spec"].items() if k in fields}).replace(
            engine=manifest["engine"],
            devices=devs,
            persist_dir=str(path),
            height=pins["height"],
            n_chunks=pins["n_chunks"],
            n_shards=pins["n_shards"],
            buffer_size=pins["buffer_size"],
        )
        if spec.backend not in _BACKENDS:
            # a backend name of the reference's (its Pallas kernel): the
            # port picks its own by the device
            spec = spec.replace(backend="auto")
        n, d = int(manifest["n"]), int(manifest["d"])
        pl = make_plan(
            max(1, n), d,
            m=spec.m_hint,
            k=spec.k_hint,
            devices=devs,
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
            mutable=spec.mutable,
            merge_async=spec.merge_async,
        )
        engine = get_engine(pl.engine)
        state = engine.restore_state(
            {k: v for k, v in arrays.items() if not k.startswith("extra/")},
            manifest["meta"], spec, pl,
        )
        idx = cls(spec=spec, plan=pl, engine=engine, state=state, n=n, d=d)
        idx._extra_arrays = {
            k[len("extra/"):]: v for k, v in arrays.items() if k.startswith("extra/")
        }
        seq = int(manifest["mutation_seq"])
        wal = WriteAheadLog(os.path.join(path, "wal"), fsync=spec.wal_fsync)
        replayed = 0
        for rseq, op, arr in wal.replay(min_seq=seq):
            if op == "insert":
                idx._serialized(engine.insert, state, np.ascontiguousarray(arr, np.float32))
            else:
                idx._serialized(engine.delete, state, np.asarray(arr, np.int64))
            seq = rseq + 1
            replayed += 1
        idx.n = int(getattr(state, "n_live", idx.n))
        idx._store, idx._wal, idx._mutation_seq = store, wal, seq
        idx.plan = pl.replace(reasons=pl.reasons + (
            f"restored from {path} v{version} (format {manifest['format']}, "
            f"snapshot seq {manifest['mutation_seq']}, replayed {replayed} WAL record(s))",
        ))
        return idx

    def _check_queries(self, queries) -> np.ndarray:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.d:
            raise ValueError(f"queries must be [m, {self.d}], got {queries.shape}")
        return queries

    def query(self, queries: np.ndarray, k: Optional[int] = None) -> QueryResult:
        """k nearest neighbors of every query row (``k`` defaults to the
        spec's ``k_hint``), under the host span ``query``, whose call id
        the result's ``stats.call`` carries."""
        k = int(k) if k is not None else self.spec.k_hint
        queries = self._check_queries(queries)
        if k > self.n:
            raise ValueError(f"k={k} > n={self.n}")
        with tracing.span("query") as here:
            dists, idx, stats = self._serialized(
                self._engine.query, self._state, queries, k
            )
        stats = dataclasses.replace(stats, call=here.call)
        self._record_stats(stats)
        return QueryResult(dists=dists, idx=idx, stats=stats,
                           engine=self.plan.engine, k=k)

    def _record_stats(self, stats: SearchStats) -> None:
        """Keep the call's stats; its operational events (a device loss and
        the re-placement) go into ``plan.reasons`` too."""
        self._last_stats = stats
        if stats.events:
            self.plan = self.plan.replace(reasons=self.plan.reasons + tuple(stats.events))

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
        self._record_stats(stats)
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
        self._record_stats(stats)
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
        self._record_stats(stats)
        return StatResult(values=hist, error_bound=0.0, stats=stats,
                          engine=self.plan.engine, op="pair_count")

    def _require_mutable(self) -> None:
        if not self._engine.caps.mutable:
            raise MutabilityError(
                f"engine {self.engine_name!r} is immutable (caps.mutable=False); "
                "build with IndexSpec(mutable=True)"
            )

    def insert(self, points: np.ndarray) -> np.ndarray:
        """Add ``points``; returns their i64 ids, allocated in insertion
        order (``build``'s points hold ``0..n-1``), which ``query``
        returns.  The WAL record is appended after the engine applied the
        batch (a rejected batch never reaches the log) and before this
        returns (an acknowledged mutation is always replayable)."""
        self._require_mutable()
        points = np.asarray(points, dtype=np.float32)
        if points.ndim != 2 or points.shape[1] != self.d:
            raise ValueError(f"points must be [b, {self.d}], got {points.shape}")
        ids = self._serialized(self._engine.insert, self._state, points)
        self.n = getattr(self._state, "n_live", self.n + points.shape[0])
        if self._wal is not None:
            self._wal.append("insert", points, self._mutation_seq)
            self._mutation_seq += 1
        return ids

    def delete(self, ids) -> int:
        """Remove the given ids; returns the count removed.  Exact: an
        unknown, already deleted or repeated id raises ``KeyError`` and
        nothing is removed.  WAL as ``insert``."""
        self._require_mutable()
        removed = self._serialized(self._engine.delete, self._state, ids)
        self.n = getattr(self._state, "n_live", self.n - removed)
        if self._wal is not None:
            self._wal.append("delete", np.ascontiguousarray(np.asarray(ids, np.int64).ravel()),
                             self._mutation_seq)
            self._mutation_seq += 1
        return removed

    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait for background index maintenance (the dynamic engine's carry
        merges) to settle; queries are exact regardless.  Re-raises a
        background failure (``MergeRetryExhausted``) and ``DrainTimeout``
        when ``timeout`` expires; engines without background work return at
        once."""
        fn = getattr(self._state, "drain_merges", None)
        if fn is not None:
            fn(timeout)

    def query_stream(self, queries, k=None, *, on_complete) -> QueryResult:
        """k nearest neighbors with per-row streaming delivery.

        ``on_complete(rows, dists, idx)`` is called from inside the round
        loop as query rows retire, each row exactly once, with the values
        ``query`` returns; the assembled ``QueryResult`` is returned after
        the last delivery.  The callback runs on the calling thread.
        Engines declaring ``caps.batch_stream`` (the dynamic forest)
        deliver the whole batch in one call.  Engines declaring neither
        raise the typed ``StreamingUnsupported``: build with
        ``IndexSpec(engine="streaming")``.
        """
        caps = self._engine.caps
        if not (caps.streaming or caps.batch_stream):
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
        self._record_stats(stats)
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
            with tracing.span("warm"):
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
        slots = ", ".join(str(d) for d in self.spec.devices or ())
        lines = [
            f"KNNIndex: n={self.n} d={self.d} engine={pl.engine} slots=[{slots}] "
            f"h={pl.height} n_chunks={pl.n_chunks} n_shards={pl.n_shards} "
            f"B={pl.buffer_size} precision={pl.precision} "
            f"resident~{pl.resident_bytes / 1e6:.1f}MB",
        ]
        lines += [f"  - {r}" for r in pl.reasons]
        return "\n".join(lines)
