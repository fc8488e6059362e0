"""Streaming queries: per-row completions out of the chunked round loop.

Counterpart of ``repro.core.streaming``.  The chunk-resident engine
(``chunked_jit.ChunkResidentEngine``) retires queries monotonically: once a
row's pending-leaf entry goes to -1 its knn row is final, though the round
loop runs on for the rest of the batch.  ``stream_query`` runs the round
loop with the engine's ``on_retire`` hook attached
(``BufferKDTree.search``), rescores each retired subset exactly (the batch
path's re-rank) and hands it to the caller's ``emit`` while later rounds
are still scanning; on a quantized store a row whose answer is not yet
proven is held back for the refining pass and emitted from there.
Detection rides the double-buffered schedule readback, so streaming adds
no device synchronisation of its own.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from repro_torch.core.lazysearch import BufferKDTree, SearchStats

__all__ = ["stream_query"]

# emit(rows i64[r], dists f32[r, k], idx i64[r, k]): rows are original query
# rows; each row is delivered exactly once, in retirement order, with
# rescored, sorted results in the caller's original point ordering.
EmitFn = Callable[[np.ndarray, np.ndarray, np.ndarray], None]


def stream_query(
    bkd: BufferKDTree, queries: np.ndarray, k: int, emit: EmitFn
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Exact kNN over ``queries`` with per-row streaming delivery.

    Every time a subset of rows retires, their results go to ``emit(rows,
    dists, idx)``.  Returns the assembled batch ``(dists, idx, stats)``,
    equal to ``bkd.query``'s, after the last emission.  ``emit`` runs on the
    calling thread between rounds: keep it cheap.  An exception raised by
    ``emit`` propagates and abandons the remaining rounds; rows emitted
    before stay delivered, and the index is left as it was.
    """
    queries = bkd.check_queries(queries, k)
    dists, idx, stats = bkd.search(queries, k, emit)
    bkd._last_stats = stats
    return dists, idx, stats
