"""Registered engines (counterpart of ``repro.api.engines``).

  brute      tiled brute-force (paper baseline (3); also the oracle)
  chunked    chunk-resident bulk-synchronous LazySearch (§3 out-of-core path)
  streaming  the chunked engine plus per-row delivery (``query_stream``):
             each query's result is emitted the round it retires
  jit        the device-resident fixed point (``core/jitsearch.py``): one
             round captured as a CUDA graph and replayed; knn only

All translate their native conventions into the one ``QueryResult``
contract: ascending Euclidean f32[m, k] distances and i64[m, k] ids in the
caller's original ordering.  ``brute``, ``chunked`` and ``streaming``
declare the dual-tree ops (``radius``, ``kde``, ``pair_count``): brute by
its all-pairs oracles, the tree engines by ``core/dualtree.py`` over the
index's own tree and leaf store.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.engine import KNOWN_OPS, EngineBase, EngineCaps, register_engine
from repro_torch.api.planner import chunked_resident_bytes
from repro_torch.core import dualtree
from repro_torch.core.brute import knn_brute
from repro_torch.core.jitsearch import (
    RoundsCache, TreeArrays, lazy_knn_jit, tree_arrays_from,
)
from repro_torch.core.lazysearch import (
    FP32_OVERFETCH,
    BufferKDTree,
    SearchStats,
    certify,
)
from repro_torch.core.streaming import stream_query
from repro_torch.core.toptree import TopTree, build_top_tree
from repro_torch.kernels import ops as kops

__all__ = []  # engines are reached through the registry, not imports


@register_engine
class BruteEngine(EngineBase):
    name = "brute"
    caps = EngineCaps(
        exact=True, out_of_core=False, multi_device=False, needs_build=False,
        ops=KNOWN_OPS,
        description="tiled brute-force streaming (baseline/oracle)",
    )

    def build(self, points, spec, plan):
        dev = kops.resolve_device(spec.devices[0] if spec.devices else None)
        return torch.as_tensor(np.asarray(points, np.float32), device=dev)

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

    def resident_bytes(self, plan, state=None) -> int:
        return plan.n * plan.d * 4   # the reference points, unpadded


@register_engine
class ChunkedEngine(EngineBase):
    name = "chunked"
    caps = EngineCaps(
        exact=True, out_of_core=True, multi_device=False, stateful_query=True,
        ops=KNOWN_OPS,
        description="chunk-resident bulk-synchronous LazySearch (§3)",
    )

    def build(self, points, spec, plan):
        return BufferKDTree(
            points,
            height=plan.height,
            n_chunks=plan.n_chunks,
            buffer_size=plan.buffer_size,
            tile_q=plan.tile_q,
            backend=plan.backend,
            starvation_deadline=plan.starvation_deadline,
            device=spec.devices[0] if spec.devices else None,
            precision=plan.precision,
        )

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
        dev = kops.resolve_device(spec.devices[0] if spec.devices else None)
        top = build_top_tree(np.asarray(points, np.float32), plan.height)
        backend = kops.resolve_backend(plan.backend, dev)
        norms = np.sqrt(np.sum(top.points.astype(np.float64) ** 2, axis=1))
        return _JitState(
            top=top, tree=tree_arrays_from(top, dev),
            tq=kops.engine_tile_q(plan.tile_q, backend), backend=backend,
            x_norm_max=float(norms.max()),
        )

    def query(self, state: _JitState, queries, k):
        top, n = state.top, state.top.n
        m = queries.shape[0]
        k_eff = min(k + FP32_OVERFETCH, n)
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(state.tree.slabs.device)
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
            dists[rows], idx[rows] = bd, top.orig_idx[bi]
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
