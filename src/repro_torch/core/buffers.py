"""Leaf buffers, queues and the ProcessAllBuffers work plan (paper Alg. 1).

The paper attaches a B-slot buffer to every leaf and two queues (``input``,
``reinsert``) to the tree.  On a SIMD device the payoff of the buffers is
that queries *sorted by destination leaf* turn the leaf scans into dense,
regular work units.  We realize the buffers exactly that way: buffered
(query, leaf) pairs are kept per-leaf and, when flushed, compiled into a
padded work plan

    unit_leaf  i32[W]          leaf id per work unit
    unit_query i32[W, TQ]      query ids, -1 padded

with every unit holding at most TQ queries of a single leaf — the shape the
leaf-scan kernel consumes directly.  Plan construction is vectorized numpy
(host side, like the paper's queue management).

Counterpart of ``repro.core.buffers`` (numpy only, kept as the port's own
copy): the host loop of ``core/lazysearch.py`` (``engine="host"``) keeps
its queues and buffers here and launches the leaf scan on these plans.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Tuple

import numpy as np

__all__ = ["QueryQueues", "LeafBuffers", "WorkPlan", "build_work_plan"]


@dataclasses.dataclass
class WorkPlan:
    unit_leaf: np.ndarray    # i32[W]
    unit_query: np.ndarray   # i32[W, TQ]  (-1 padded)

    @property
    def n_units(self) -> int:
        return int(self.unit_leaf.shape[0])


def build_work_plan(leaf_ids: np.ndarray, query_ids: np.ndarray, tq: int) -> WorkPlan:
    """Compile buffered (leaf, query) pairs into padded work units.

    Stable-sorts by leaf (the "buffer" grouping), then splits each leaf's
    group into ceil(c/TQ) units.  Fully vectorized.
    """
    leaf_ids = np.asarray(leaf_ids, dtype=np.int32)
    query_ids = np.asarray(query_ids, dtype=np.int32)
    if leaf_ids.shape != query_ids.shape or leaf_ids.ndim != 1:
        raise ValueError("leaf_ids/query_ids must be equal-length 1-D arrays")
    p = leaf_ids.shape[0]
    if p == 0:
        return WorkPlan(np.zeros((0,), np.int32), np.zeros((0, tq), np.int32))

    order = np.argsort(leaf_ids, kind="stable")
    sl, sq = leaf_ids[order], query_ids[order]
    uniq, starts, counts = np.unique(sl, return_index=True, return_counts=True)
    units_per_leaf = (counts + tq - 1) // tq
    unit_offsets = np.concatenate([[0], np.cumsum(units_per_leaf)])
    w = int(unit_offsets[-1])

    # position of each element within its leaf group
    within = np.arange(p) - np.repeat(starts, counts)
    elem_unit = np.repeat(unit_offsets[:-1], counts) + within // tq
    elem_slot = within % tq

    unit_leaf = np.repeat(uniq, units_per_leaf).astype(np.int32)
    unit_query = np.full((w, tq), -1, dtype=np.int32)
    unit_query[elem_unit, elem_slot] = sq
    return WorkPlan(unit_leaf=unit_leaf, unit_query=unit_query)


class QueryQueues:
    """The paper's ``input`` and ``reinsert`` queues (host side, FIFO).

    ``fetch(M)`` drains reinsert first, then input (Alg. 1 line 4 fetches
    from both; reinsert-first keeps in-flight traversals moving so their
    buffers refill fastest — matches the reference implementation).

    Queues are deques of int32 ARRAY SEGMENTS, drained by numpy slicing:
    both ``push_reinsert`` and ``fetch`` are O(segments), never O(elements)
    Python-loop work — the old per-int list shuffling was a measurable
    host-side cost at large m (every query id passed through it once per
    leaf visit).
    """

    def __init__(self, m: int):
        self._input: Deque[np.ndarray] = deque()
        if m:
            self._input.append(np.arange(m, dtype=np.int32))
        self._reinsert: Deque[np.ndarray] = deque()
        self._n = int(m)

    def push_reinsert(self, idx: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int32)
        if idx.size:
            self._reinsert.append(idx)
            self._n += int(idx.size)

    def fetch(self, m_fetch: int) -> np.ndarray:
        out: List[np.ndarray] = []
        need = int(m_fetch)
        for dq in (self._reinsert, self._input):
            while need and dq:
                seg = dq[0]
                if seg.size <= need:
                    out.append(seg)
                    dq.popleft()
                    need -= seg.size
                else:
                    out.append(seg[:need])
                    dq[0] = seg[need:]
                    need = 0
        got = np.concatenate(out) if out else np.zeros((0,), np.int32)
        self._n -= int(got.size)
        return got

    def __len__(self) -> int:
        return self._n

    @property
    def empty(self) -> bool:
        return self._n == 0


class LeafBuffers:
    """Per-leaf query buffers with the paper's fill heuristic.

    ``should_flush`` is true when at least one buffer holds >= B/2 entries
    (paper line 11) or when forced (queues empty).

    Fill counts live in a dense i32[n_leaves] array updated by one
    ``np.bincount`` per insert, touching only the id range the batch
    actually hit (the same numpy-slice design as ``QueryQueues``): no
    per-leaf Python dict work on the hot path, and ``max_fill`` is a
    running maximum — O(1) per ``should_flush`` check.
    """

    def __init__(self, n_leaves: int, capacity: int):
        self.capacity = int(capacity)
        self.n_leaves = int(n_leaves)
        self._leaf: List[np.ndarray] = []
        self._query: List[np.ndarray] = []
        self._fill = np.zeros((self.n_leaves,), np.int32)
        self._max_fill = 0
        self._total = 0

    def insert(self, leaf_ids: np.ndarray, query_ids: np.ndarray) -> None:
        if leaf_ids.size == 0:
            return
        leaf_ids = np.asarray(leaf_ids, np.int32)
        self._leaf.append(leaf_ids)
        self._query.append(np.asarray(query_ids, np.int32))
        cnt = np.bincount(leaf_ids)            # length = max id hit + 1
        touched = self._fill[: cnt.size]
        touched += cnt.astype(np.int32)
        # fills only grow between drains, so the max over the touched
        # prefix keeps the running max exact
        self._max_fill = max(self._max_fill, int(touched.max()))
        self._total += int(leaf_ids.size)

    @property
    def total(self) -> int:
        return self._total

    @property
    def max_fill(self) -> int:
        return self._max_fill

    def should_flush(self, force: bool = False) -> bool:
        if self._total == 0:
            return False
        return force or self._max_fill >= max(1, self.capacity // 2)

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._total == 0:
            return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
        leaf = np.concatenate(self._leaf)
        query = np.concatenate(self._query)
        self._leaf, self._query, self._total = [], [], 0
        self._fill[:] = 0
        self._max_fill = 0
        return leaf, query
