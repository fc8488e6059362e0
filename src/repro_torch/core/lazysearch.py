"""LazySearch: the buffer k-d tree query engine (paper Algorithm 1 + §3.2).

Counterpart of ``repro.core.lazysearch`` on the ``chunked`` engine: the
chunk-resident bulk-synchronous round loop
(``chunked_jit.ChunkResidentEngine``) over a double-buffered
``ChunkedLeafStore``, followed by an exact fp32 re-rank of the selected
candidates on the host (``finalize_candidates``).  The paper-faithful host
loop (``engine="host"``) is not ported yet (ROADMAP Queue 1 item 17).

Defaults follow the paper's footnote 8: for tree height h, buffer capacity
B = 2^(24-h) (capped), the input of the B/2 chunk-visit rule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.chunked_jit import (
    DEFAULT_STARVATION_DEADLINE,
    ChunkResidentEngine,
)
from repro_torch.core.toptree import (
    TopTree,
    build_top_tree,
    default_buffer_size,
    suggest_height,
)
from repro_torch.kernels import ops as kops

__all__ = ["BufferKDTree", "SearchStats", "finalize_candidates"]


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

    def warm(self, m: int, k: int = 10) -> None:
        """Run the chunk round once at the full shape of a batch of ``m``
        and at every compaction-ladder rung (builds the kernel)."""
        self._engine.warm(m, k, self.engine_tile_q)

    def query(
        self, queries: np.ndarray, k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest neighbors for every query: (dists f32[m, k] ascending
        Euclidean, idx i64[m, k] into the caller's original ordering)."""
        queries = np.asarray(queries, dtype=np.float32)
        m, d = queries.shape
        if d != self.d:
            raise ValueError(f"query dim {d} != reference dim {self.d}")
        if k > self.n:
            raise ValueError(f"k={k} > n={self.n}")
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
        _d2, gi, info = self._engine.run(
            q, k, self.engine_tile_q, self.buffer_size
        )
        self._last_stats = SearchStats(
            iterations=info["rounds"],
            flushes=info["rounds"],
            units_scanned=info["units"],
            points_scanned=info["units"] * self.store.host.shape[1],
            queries_advanced=info["queries_advanced"],
            chunk_rounds=info["chunk_rounds"],
            compactions=info["compactions"],
            steady_rounds=info["steady_rounds"],
            tail_rounds=info["tail_rounds"],
            steady_s=info["steady_s"],
            tail_s=info["tail_s"],
            sync_wait_s=info["sync_wait_s"],
            chunk_copies=info["chunk_copies"],
        )
        return finalize_candidates(self.tree, queries, gi)
