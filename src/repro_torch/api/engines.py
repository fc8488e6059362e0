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
  sharded    the paper's §3.2 query chunking: one tree engine per device
             slot, each answering a contiguous chunk of the batch
  forest     one tree per slot over equal shards of the reference set
             (each answering as ``jit`` does), lists merged on the lead slot
  ring       reference shards resident on the slots, query blocks rotated
             around them, every scan the leaf-scan kernel
  dynamic    the mutable logarithmic-method forest (``core/dynamic.py``):
             insert / delete, shards placed over device slots, background
             carry merges; knn only, whole-batch ``query_stream``

All translate their native conventions into the one ``QueryResult``
contract: ascending Euclidean f32[m, k] distances and i64[m, k] ids in the
caller's original ordering.  ``brute``, ``host``, ``chunked`` and
``streaming`` declare the dual-tree ops (``radius``, ``kde``,
``pair_count``): brute by its all-pairs oracles, the tree engines by
``core/dualtree.py`` over the index's own tree and leaf store.  Every
engine here but the three multi-device ones (which the reference does not
snapshot either) has a host-side snapshot (``snapshot_state`` /
``restore_state``) in the reference's format: tree arrays, fp32 points,
and a quantized store's codes with their columns padded to a multiple of 8
as the reference lays them out.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.engine import KNOWN_OPS, EngineBase, EngineCaps, register_engine
from repro_torch.api.planner import chunked_resident_bytes
from repro_torch.core import dualtree
from repro_torch.core.brute import knn_brute
from repro_torch.core.hostkdtree import knn_host_kdtree
from repro_torch.core.lazysearch import BufferKDTree, JitTree, SearchStats
from repro_torch.core.quantize import QuantizedSlabs
from repro_torch.core.streaming import stream_query
from repro_torch.core.toptree import (
    TopTree,
    build_top_tree,
    tree_from_arrays,
    tree_to_arrays,
)
from repro_torch.distributed.forest import (
    Forest, build_forest, forest_knn, stack_forest, warm_forest,
)
from repro_torch.distributed.ring_knn import RingShards, ring_knn_brute, ring_shards
from repro_torch.distributed.sharded import MultiDeviceTrees
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


@register_engine
class JitEngine(EngineBase):
    """The device-resident fixed point (``core/jitsearch.py``): every round
    over fixed shapes, captured once as a CUDA graph and replayed, answered
    exactly by ``lazysearch.JitTree``.  Picked only when pinned."""

    name = "jit"
    caps = EngineCaps(
        exact=True, out_of_core=False, multi_device=False, stateful_query=True,
        description="device-resident fixed point, one CUDA graph per round",
    )

    def build(self, points, spec, plan):
        return self._state(build_top_tree(np.asarray(points, np.float32), plan.height),
                           spec, plan)

    def _state(self, top: TopTree, spec, plan) -> JitTree:
        return JitTree(top, _device(spec), tile_q=plan.tile_q, backend=plan.backend)

    def snapshot_state(self, state: JitTree):
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

    def query(self, state: JitTree, queries, k):
        return state.query(queries, k)


def _slots(spec, p: int):
    """The first ``p`` device slots of ``spec`` (slots are ordinals: a
    device may repeat)."""
    devs = list(spec.devices) if spec.devices else list(kops.visible_devices())
    if len(devs) < p:
        raise ValueError(f"need {p} device slots, have {len(devs)}")
    return [torch.device(d) for d in devs[:p]]


@register_engine
class ShardedEngine(EngineBase):
    """The paper's §3.2 query chunking (``distributed/sharded.py``): one
    chunked tree engine per device slot, each answering a contiguous chunk
    of the batch.  Stateful, but ``MultiDeviceTrees`` carries its own lock,
    so the facade need not serialize on top of it."""

    name = "sharded"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=True,
        description="paper §3.2 query chunking: one tree engine per device",
    )

    def build(self, points, spec, plan):
        return MultiDeviceTrees(
            points, devices=list(spec.devices) if spec.devices else None,
            height=plan.height, n_chunks=plan.n_chunks, backend=plan.backend,
            tile_q=plan.tile_q, buffer_size=plan.buffer_size,
            starvation_deadline=plan.starvation_deadline, precision=plan.precision,
        )

    def query(self, state: MultiDeviceTrees, queries, k):
        # the slots' stats snapshots are taken under the state's lock, so
        # concurrent batches cannot clobber this aggregation
        d, i, _, ran = state.query_with_active(queries, k)
        return d, i, SearchStats(
            iterations=max((s.iterations for s in ran), default=0),
            flushes=sum(s.flushes for s in ran),
            units_scanned=sum(s.units_scanned for s in ran),
            points_scanned=sum(s.points_scanned for s in ran),
            queries_advanced=sum(s.queries_advanced for s in ran),
            chunk_rounds=sum(s.chunk_rounds for s in ran),
            refined_rows=sum(s.refined_rows for s in ran),
            exact_rows=sum(s.exact_rows for s in ran),
        )

    def resident_bytes(self, plan, state=None) -> int:
        if state is not None:
            return state.resident_bytes()   # measured, not estimated
        # per slot: the whole structure, replicated and chunk-streamed
        return chunked_resident_bytes(plan)


@register_engine
class ForestEngine(EngineBase):
    """Per-slot buffer k-d trees over equal shards, merged on the lead slot
    (``distributed/forest.py``); each shard answers as the ``jit`` engine
    does."""

    name = "forest"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=True,
        description="per-shard buffer k-d trees + all-gather top-k merge",
    )

    def build(self, points, spec, plan):
        points = np.asarray(points, np.float32)
        n, ns = points.shape[0], plan.n_shards
        if n % ns:
            raise ValueError(
                f"forest engine needs n % n_shards == 0 (n={n}, n_shards={ns}); the "
                "planner falls back to 'sharded' for uneven sets"
            )
        trees, offsets = build_forest(points, ns, height=plan.height)
        return stack_forest(trees, offsets, _slots(spec, ns), tile_q=plan.tile_q,
                            backend=plan.backend)

    def query(self, state: Forest, queries, k):
        return forest_knn(queries, state, k=k)

    def warm(self, state: Forest, m: int, k: int) -> None:
        warm_forest(state, m, k)

    def resident_bytes(self, plan, state=None) -> int:
        return plan.slab_bytes // max(1, plan.n_shards)


@register_engine
class RingEngine(EngineBase):
    """Reference shards resident on the slots, query blocks rotated around
    them (``distributed/ring_knn.py``), every scan the leaf-scan kernel."""

    name = "ring"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=True, needs_build=False,
        description="resident reference shards, query blocks ringed",
    )

    def build(self, points, spec, plan):
        return ring_shards(points, _slots(spec, plan.n_shards), tile_q=plan.tile_q,
                           backend=plan.backend)

    def query(self, state: RingShards, queries, k):
        m = queries.shape[0]
        dists, idx, brute_rows = ring_knn_brute(queries, state, k=k)
        return dists, idx, SearchStats(iterations=state.p, points_scanned=m * state.n,
                                       queries_advanced=m, exact_rows=brute_rows)

    def resident_bytes(self, plan, state=None) -> int:
        # the raw reference shard per slot (no leaf-structure padding)
        p = max(1, plan.n_shards)
        return -(-plan.n // p) * p * plan.d * 4 // p


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
