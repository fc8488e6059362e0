"""Registered engines (counterpart of ``repro.api.engines``): kNN only.

  brute      tiled brute-force (paper baseline (3); also the oracle)
  chunked    chunk-resident bulk-synchronous LazySearch (§3 out-of-core path)
  streaming  the chunked engine plus per-row delivery (``query_stream``):
             each query's result is emitted the round it retires

All translate their native conventions into the one ``QueryResult``
contract: ascending Euclidean f32[m, k] distances and i64[m, k] ids in the
caller's original ordering.  They declare ``ops={"knn"}`` until the
dual-tree ops are ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.engine import EngineBase, EngineCaps, register_engine
from repro_torch.api.planner import chunked_resident_bytes
from repro_torch.core.brute import knn_brute
from repro_torch.core.lazysearch import BufferKDTree, SearchStats
from repro_torch.core.streaming import stream_query
from repro_torch.kernels.ops import resolve_device

__all__ = []  # engines are reached through the registry, not imports


@register_engine
class BruteEngine(EngineBase):
    name = "brute"
    caps = EngineCaps(
        exact=True, out_of_core=False, multi_device=False, needs_build=False,
        description="tiled brute-force streaming (baseline/oracle)",
    )

    def build(self, points, spec, plan):
        dev = resolve_device(spec.devices[0] if spec.devices else None)
        return torch.as_tensor(np.asarray(points, np.float32), device=dev)

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
        streaming=True,
        description="chunked engine + per-row early-retirement streaming "
                    "(the online serving engine)",
    )

    def query_stream(self, state: BufferKDTree, queries, k, emit):
        return stream_query(state, queries, k, emit)
