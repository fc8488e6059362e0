"""Registered engines (counterpart of ``repro.api.engines``).

  brute      tiled brute-force (paper baseline (3); also the oracle)
  kdtree     classic unbuffered k-d traversal on the host (paper baseline
             (2)); host numpy, nothing on a device
  host       the paper's Algorithm 1: host queues and leaf buffers around
             the device's traversal, leaf scan and merge
  chunked    chunk-resident bulk-synchronous LazySearch (§3 out-of-core path)
  streaming  the chunked engine plus per-row delivery (``query_stream``):
             each query's result is emitted the round it retires
  jit        the device-resident fixed point (``core/jitsearch.py``): one
             round captured as a CUDA graph and replayed; knn only
  dynamic    the mutable logarithmic-method forest (``core/dynamic.py``):
             insert / delete, shards placed over device slots, background
             carry merges; knn only, whole-batch ``query_stream``

All translate their native conventions into the one ``QueryResult``
contract: ascending Euclidean f32[m, k] distances and i64[m, k] ids in the
caller's original ordering.  ``brute``, ``host``, ``chunked`` and
``streaming`` declare the dual-tree ops (``radius``, ``kde``,
``pair_count``): brute by its all-pairs oracles, the tree engines by
``core/dualtree.py`` over the index's own tree and leaf store.  Every
engine here has a host-side snapshot (``snapshot_state`` /
``restore_state``) in the reference's format: tree arrays, fp32 points,
and a quantized store's codes with their columns padded to a multiple of 8
as the reference lays them out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.engine import KNOWN_OPS, EngineBase, EngineCaps, register_engine
from repro_torch.api.planner import chunked_resident_bytes
from repro_torch.core import dualtree
from repro_torch.core.brute import knn_brute
from repro_torch.core.hostkdtree import knn_host_kdtree
from repro_torch.core.jitsearch import (
    RoundsCache, TreeArrays, lazy_knn_jit, tree_arrays_from,
)
from repro_torch.core.lazysearch import (
    FP32_OVERFETCH,
    BufferKDTree,
    SearchStats,
    certify,
    orig_ids,
)
from repro_torch.core.quantize import QuantizedSlabs
from repro_torch.core.streaming import stream_query
from repro_torch.core.toptree import (
    TopTree,
    build_top_tree,
    tree_from_arrays,
    tree_to_arrays,
)
from repro_torch.kernels import ops as kops

__all__ = []  # engines are reached through the registry, not imports

# the reference pads the feature columns of its slabs and codes to a
# multiple of this; snapshots carry that layout
_D_PAD = 8


def _device(spec) -> torch.device:
    return kops.resolve_device(spec.devices[0] if spec.devices else None)


def _pad_cols(a: np.ndarray, fill: float = 0.0) -> np.ndarray:
    """``a`` [..., d] with columns of ``fill`` up to the reference's width
    (a multiple of ``_D_PAD``)."""
    d = a.shape[-1]
    width = max(_D_PAD, -(-d // _D_PAD) * _D_PAD)
    if width == d:
        return np.asarray(a)
    pad = np.full(a.shape[:-1] + (width - d,), fill, a.dtype)
    return np.concatenate([a, pad], axis=-1)


def _tree_snapshot(tree: TopTree):
    arrays = dict(tree_to_arrays(tree, include_derived=True))
    return arrays, {"height": tree.height, "leaf_pad": tree.leaf_pad}


def _tree_restore(arrays, meta) -> TopTree:
    return tree_from_arrays(
        np.ascontiguousarray(arrays["points"], np.float32), arrays,
        height=int(meta["height"]), leaf_pad=int(meta["leaf_pad"]),
    )


@register_engine
class BruteEngine(EngineBase):
    name = "brute"
    caps = EngineCaps(
        exact=True, out_of_core=False, multi_device=False, needs_build=False,
        ops=KNOWN_OPS,
        description="tiled brute-force streaming (baseline/oracle)",
    )

    def build(self, points, spec, plan):
        return kops.owned_tensor(points, _device(spec))

    def _stats(self, state, m: int) -> SearchStats:
        return SearchStats(iterations=1, points_scanned=m * state.shape[0],
                           queries_advanced=m)

    def radius(self, state, queries, r):
        ip, ix, dd = dualtree.radius_brute(queries, state, float(r))
        return ip, ix, dd, self._stats(state, queries.shape[0])

    def kde(self, state, queries, bandwidth, *, rtol=1e-2, atol=1e-9,
            kernel="gaussian"):
        dens = dualtree.kde_brute(queries, state, float(bandwidth), kernel=kernel)
        # an exact all-pairs sum: no traversal error
        return dens, 0.0, self._stats(state, queries.shape[0])

    def pair_count(self, state, edges):
        hist = dualtree.pair_count_brute(state, edges)
        return hist, SearchStats(iterations=1,
                                 points_scanned=state.shape[0] * state.shape[0])

    def query(self, state, queries, k):
        d, i = knn_brute(queries, state, k)
        stats = SearchStats(
            iterations=1,
            points_scanned=queries.shape[0] * state.shape[0],
            queries_advanced=queries.shape[0],
        )
        return d, i, stats

    def snapshot_state(self, state):
        return {"points": state.cpu().numpy()}, {}

    def restore_state(self, arrays, meta, spec, plan):
        points = np.ascontiguousarray(arrays["points"], np.float32)
        return torch.as_tensor(points, device=_device(spec))

    def resident_bytes(self, plan, state=None) -> int:
        return plan.n * plan.d * 4   # the reference points, unpadded


@register_engine
class HostKDTreeEngine(EngineBase):
    """The paper's CPU baseline (2): host numpy over the top tree, so it
    holds nothing on a device whatever ``spec.devices`` says."""

    name = "kdtree"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=False,
        description="classic unbuffered k-d traversal (CPU baseline)",
    )

    def build(self, points, spec, plan):
        return build_top_tree(np.asarray(points, np.float32), plan.height)

    def query(self, state: TopTree, queries, k):
        d, i = knn_host_kdtree(queries, state, k)
        return d, i, SearchStats(queries_advanced=queries.shape[0])

    def snapshot_state(self, state: TopTree):
        return _tree_snapshot(state)

    def restore_state(self, arrays, meta, spec, plan):
        return _tree_restore(arrays, meta)

    def resident_bytes(self, plan, state=None) -> int:
        return 0


@register_engine
class ChunkedEngine(EngineBase):
    name = "chunked"
    _tier = "chunked"   # BufferKDTree's engine
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=False, stateful_query=True,
        ops=KNOWN_OPS,
        description="chunk-resident bulk-synchronous LazySearch (§3)",
    )

    def _tree_engine(self, points, spec, plan, **kw) -> BufferKDTree:
        return BufferKDTree(
            points,
            n_chunks=plan.n_chunks,
            buffer_size=plan.buffer_size,
            fetch_m=plan.fetch_m,
            tile_q=plan.tile_q,
            backend=plan.backend,
            engine=self._tier,
            starvation_deadline=plan.starvation_deadline,
            device=spec.devices[0] if spec.devices else None,
            **kw,
        )

    def build(self, points, spec, plan):
        return self._tree_engine(points, spec, plan, height=plan.height,
                                 precision=plan.precision)

    def snapshot_state(self, state: BufferKDTree):
        arrays, meta = _tree_snapshot(state.tree)
        meta["precision"] = state.precision
        if state.store.quantized:
            arrays.update(state.store.quantized_state().reference_layout().to_arrays())
        return arrays, meta

    def restore_state(self, arrays, meta, spec, plan):
        tree = _tree_restore(arrays, meta)
        # snapshots without a precision field predate it: fp32
        precision = str(meta.get("precision", "fp32"))
        store_state = None
        if precision != "fp32":
            store_state = QuantizedSlabs.from_arrays(arrays, precision)
        return self._tree_engine(tree.points, spec, plan, tree=tree, precision=precision,
                                 store_state=store_state)

    def query(self, state: BufferKDTree, queries, k):
        d, i = state.query(queries, k=k)
        return d, i, state.stats

    # -- dual-tree ops: node-pair frontier over the same TopTree and leaf
    # store the kNN rounds use (core/dualtree.py) ------------------------
    def radius(self, state: BufferKDTree, queries, r):
        return state.dualtree().radius(queries, float(r))

    def kde(self, state: BufferKDTree, queries, bandwidth, *, rtol=1e-2,
            atol=1e-9, kernel="gaussian"):
        return state.dualtree().kde(queries, float(bandwidth), rtol=rtol,
                                    atol=atol, kernel=kernel)

    def pair_count(self, state: BufferKDTree, edges):
        return state.dualtree().pair_count(edges)

    def warm_ops(self, state: BufferKDTree, ops, m=None, n_edges=9):
        dual = [op for op in ops if op != "knn"]
        if dual:
            state.dualtree().warm(dual, m=m, n_edges=n_edges)

    def resident_bytes(self, plan, state=None) -> int:
        if state is not None:
            return state.store.resident_bytes()   # measured, not estimated
        return chunked_resident_bytes(plan)


@register_engine
class HostLoopEngine(ChunkedEngine):
    """The paper's Algorithm 1 (``BufferKDTree(engine="host")``): the same
    tree, store, passes and dual-tree ops as ``chunked``, with the host
    loop of queues, leaf buffers and work plans in place of the round
    loop.  Never picked by the planner: pinned only."""

    name = "host"
    _tier = "host"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=False, stateful_query=True,
        ops=KNOWN_OPS,
        description="paper-faithful Alg. 1 host loop (reference tier)",
    )


@register_engine
class StreamingEngine(ChunkedEngine):
    """The chunked engine plus per-row streaming delivery: the same build,
    state and batch query, and ``query_stream``, which runs the same round
    loop with the early-retirement hook attached.  Never picked by the
    planner: callers that serve online traffic pin it."""

    name = "streaming"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=False, stateful_query=True,
        streaming=True, ops=KNOWN_OPS,
        description="chunked engine + per-row early-retirement streaming "
                    "(the online serving engine)",
    )

    def query_stream(self, state: BufferKDTree, queries, k, emit):
        return stream_query(state, queries, k, emit)


@dataclasses.dataclass
class _JitState:
    top: TopTree            # host tree: points for the brute-force last resort
    tree: TreeArrays        # device arrays the rounds read
    tq: int
    backend: str
    x_norm_max: float       # bounds the fp32 rounding in ``certify``
    rounds: RoundsCache = dataclasses.field(default_factory=RoundsCache)


@register_engine
class JitEngine(EngineBase):
    """The device-resident fixed point (``core/jitsearch.py``): every round
    over fixed shapes, captured once as a CUDA graph and replayed.  It
    selects ``FP32_OVERFETCH`` candidates beyond k, rescores them exactly
    on the device and keeps the rows ``certify`` proves; the rest take fp32
    brute force over the tree's points.  Picked only when pinned."""

    name = "jit"
    caps = EngineCaps(
        exact=True, out_of_core=False, multi_device=False, stateful_query=True,
        description="device-resident fixed point, one CUDA graph per round",
    )

    def build(self, points, spec, plan):
        return self._state(build_top_tree(np.asarray(points, np.float32), plan.height),
                           spec, plan)

    def _state(self, top: TopTree, spec, plan) -> _JitState:
        dev = _device(spec)
        backend = kops.resolve_backend(plan.backend, dev)
        norms = np.sqrt(np.sum(top.points.astype(np.float64) ** 2, axis=1))
        return _JitState(
            top=top, tree=tree_arrays_from(top, dev),
            tq=kops.engine_tile_q(plan.tile_q, backend), backend=backend,
            x_norm_max=float(norms.max()),
        )

    def snapshot_state(self, state: _JitState):
        """The reference's ``tree/*`` arrays (its ``TreeArrays``: i32 split
        dims and ids, slabs with columns padded to a multiple of 8)."""
        top = state.top
        arrays = {
            "tree/split_dim": top.split_dim.astype(np.int32),
            "tree/split_val": top.split_val,
            "tree/leaf_start": top.leaf_start.astype(np.int32),
            "tree/leaf_size": top.leaf_sizes().astype(np.int32),
            "tree/slabs": _pad_cols(top.points_padded),
            "tree/orig_idx": top.orig_idx.astype(np.int32),
        }
        # the port's backend follows the device it is restored on
        meta = {"first_leaf_heap": top.first_leaf_heap, "d": top.d, "tq": state.tq,
                "backend": "auto"}
        return arrays, meta

    def restore_state(self, arrays, meta, spec, plan):
        d = int(meta["d"])
        slabs = np.ascontiguousarray(arrays["tree/slabs"][..., :d], np.float32)
        start = np.asarray(arrays["tree/leaf_start"], np.int32)
        size = np.asarray(arrays["tree/leaf_size"], np.int32)
        # the leaves hold the reordered points in order
        points = slabs[np.arange(slabs.shape[1])[None, :] < size[:, None]]
        tree = {"split_dim": arrays["tree/split_dim"], "split_val": arrays["tree/split_val"],
                "leaf_start": start, "leaf_end": start + size,
                "orig_idx": arrays["tree/orig_idx"], "points_padded": slabs}
        top = tree_from_arrays(points, tree, height=int(meta["first_leaf_heap"]).bit_length() - 1,
                               leaf_pad=slabs.shape[1])
        return self._state(top, spec, plan)

    def query(self, state: _JitState, queries, k):
        top, n = state.top, state.top.n
        m = queries.shape[0]
        k_eff = min(k + FP32_OVERFETCH, n)
        q = kops.owned_tensor(queries, state.tree.slabs.device)
        d2, oi, rounds = lazy_knn_jit(
            q, state.tree, k=k_eff, tq=state.tq, first_leaf_heap=top.first_leaf_heap,
            backend=state.backend, cache=state.rounds,
        )
        raw = state.rounds[(m, k_eff)].knn_d[:m].cpu().numpy()
        dists = np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))
        idx = oi.cpu().numpy()
        ok = np.ones(m, bool) if k_eff >= n else certify(
            queries, raw, dists, k, k_eff, eps=0.0, x_norm_max=state.x_norm_max)
        dists, idx = dists[:, :k].copy(), idx[:, :k].copy()
        rows = np.nonzero(~ok)[0]
        if rows.size:
            bd, bi = knn_brute(queries[rows], top.points, k, device=q.device)
            dists[rows], idx[rows] = bd, orig_ids(top, bi)
        stats = SearchStats(iterations=rounds, queries_advanced=rounds * m,
                            exact_rows=int(rows.size))
        return dists.astype(np.float32), idx.astype(np.int64), stats

    def warm(self, state: _JitState, m: int, k: int) -> None:
        """Run the round once for a batch of ``m`` at ``k`` and capture it
        (on CUDA), so the first query only replays."""
        k_eff = min(k + FP32_OVERFETCH, state.top.n)
        q = torch.zeros((m, state.top.d), device=state.tree.slabs.device)
        lazy_knn_jit(q, state.tree, k=k_eff, tq=state.tq,
                     first_leaf_heap=state.top.first_leaf_heap,
                     backend=state.backend, cache=state.rounds, max_rounds=1)


@register_engine
class DynamicEngine(EngineBase):
    """The mutable forest.  ``stateful_query``: its tree shards are
    ``BufferKDTree``s whose queries use chunk slots, and insert / delete
    rebuild shards, so the facade's lock serializes all three.
    ``batch_stream``: ``query_stream`` delivers the whole batch in one call
    once the fan-out returns, which lets ``KNNServer`` front it."""

    name = "dynamic"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=True, stateful_query=True,
        mutable=True, device_parallel_mutable=True, batch_stream=True,
        description="batch-dynamic logarithmic-method forest (incremental "
                    "insert/delete, device-placed shards)",
    )

    def build(self, points, spec, plan):
        from repro_torch.api.planner import BRUTE_N_MAX
        from repro_torch.core.dynamic import DEFAULT_BASE_CAPACITY, DynamicIndex

        idx = DynamicIndex(
            points.shape[1] if points.ndim == 2 else 0,
            # rungs are B * 2**i with B the plan's buffer size, capped at the
            # default so a shallow tree's big buffer does not inflate rung 0
            base_capacity=min(plan.buffer_size, DEFAULT_BASE_CAPACITY),
            brute_cutoff=BRUTE_N_MAX,
            rebuild_crossover=plan.crossover_batch,
            tile_q=plan.tile_q,
            backend=plan.backend,
            devices=list(spec.devices) if spec.devices else None,
            merge_async=plan.merge_async,
            precision=plan.precision,
            memory_budget=spec.memory_budget,
        )
        # register the expected batch shape before the first insert, so
        # every shard (staging shards too) runs it when it is built
        if spec.m_hint:
            idx.warm(spec.m_hint, spec.k_hint)
        idx.insert(np.asarray(points, np.float32))
        return idx

    def query(self, state, queries, k):
        return state.query(queries, k)

    def query_stream(self, state, queries, k, emit):
        d, i, stats = state.query(queries, k)
        emit(np.arange(queries.shape[0], dtype=np.int64), d, i)
        return d, i, stats

    def insert(self, state, points):
        return state.insert(points)

    def delete(self, state, ids):
        return state.delete(ids)

    def snapshot_state(self, state):
        return state.snapshot()

    def restore_state(self, arrays, meta, spec, plan):
        from repro_torch.core.dynamic import DynamicIndex

        idx = DynamicIndex.restore(arrays, meta,
                                   devices=list(spec.devices) if spec.devices else None)
        if spec.m_hint:
            idx.warm(spec.m_hint, spec.k_hint)
        return idx

    def resident_bytes(self, plan, state=None) -> int:
        if state is not None:
            return state.resident_bytes()   # measured, not estimated
        # worst case per device: the largest rung holds ~all n points in one
        # power-of-two padded slab (~2x the flat slab), never split
        return 2 * plan.slab_bytes
