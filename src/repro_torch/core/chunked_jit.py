"""Chunk-resident bulk-synchronous LazySearch (the out-of-core fast path).

Counterpart of ``repro.core.chunked_jit``.  The host streams
leaf-structure chunks (``ChunkedLeafStore``) and reads one i32[m]
pending-leaf map per round; plan construction, the leaf scans, the top-k
merge, leaf exit and re-advance run on the device, one ``_chunk_round`` per
chunk visit:

  host                             device (per chunk visit)
  ----                             ------------------------
  stream chunk slab j   ------>    restrict to queries paused at a leaf of
  (double-buffered copy)           chunk j -> work plan (_build_plan) ->
                                   ONE leaf-scan kernel launch over every
                                   plan row -> stable-sort merge -> exit +
                                   advance
  read back leaf[m] once per round: schedule the next chunk visits

Key properties, as in the reference:

  * ONE device->host sync per round (the pending-leaf map).  The kernel is
    launched over all W_max+1 plan rows and skips rows >= n_units, which it
    reads from device memory, where the reference ran a ``while_loop`` over
    unit blocks; ``n_units`` stays on the device and is summed once at the
    end.
  * The neighbor state ``knn_d``/``knn_i`` is updated in place (JAX donated
    it).  The pending-leaf map is NOT updated in place: each round makes a
    new one, so the previous round's map can still be copied to the host
    while the next round runs.
  * The paper's B/2 rule is the chunk-visit admission policy; eligible
    chunks go in pending-count-descending order, and a chunk skipped for
    ``starvation_deadline`` rounds is force-visited.
  * Compaction ladder: when the live-query count falls onto a rung (m/4,
    then m/16), live queries and their state are gathered into the smaller
    shape.
  * Double-buffered schedule sync: after dispatching a round the host
    starts a non-blocking copy of the new map into pinned memory (plus an
    event) and schedules from the previous round's map, a one-round-stale
    superset of the live set.

A quantized store (fp16/int8 codes) runs the same round: the leaf scan
reads the chunk's codes and the store's resident dequantize metadata
itself (no fp32 copy of the chunk is made), selected dead rows are dropped
before the merge, and the traversal radius is inflated by the store's
reconstruction bound ``quant_eps``, as in the reference.

Torch has no jit cache; ``chunk_round_cache_size`` counts the distinct
round shapes ``(m, tq, chunk shape, k, code dtype)`` that have run, which
keeps the ladder's "shapes are bounded" property testable.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from repro_torch.core import traversal
from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.jitsearch import _build_plan, _merge
from repro_torch.kernels import ops as kops

__all__ = [
    "ChunkResidentEngine",
    "scan_merge",
    "chunk_round_cache_size",
    "compaction_ladder",
]

DEFAULT_STARVATION_DEADLINE = 4

COMPACTION_DIVISORS = (4, 16)
COMPACTION_MIN = 32
_RUNG_MULTIPLE = 16

# distinct round shapes run so far (process-wide, like the reference's
# jit cache)
_ROUND_SHAPES: Set[Tuple] = set()

# one thread issues a CUDA chunk round at a time.  The device slots of the
# ``sharded`` engine (and the shards of the mutable index) run their round
# loops from threads of one process; a round is hundreds of small torch
# ops, each of which drops and retakes the interpreter lock, so rounds
# issued at once pass that lock from thread to thread at every op.  Under
# this lock a round is issued without that contention; its device work
# still overlaps the other slots', and the readback waits are outside it.
_ISSUE_LOCK = threading.Lock()


def compaction_ladder(m: int) -> Tuple[int, ...]:
    """Descending compacted-shape rungs for a full query batch of ``m``
    (a function of m only, never of the live count)."""
    rungs: List[int] = []
    for div in COMPACTION_DIVISORS:
        r = max(COMPACTION_MIN, -(-m // div))
        r = -(-r // _RUNG_MULTIPLE) * _RUNG_MULTIPLE
        if r < m and (not rungs or r < rungs[-1]):
            rungs.append(r)
    return tuple(rungs)


def chunk_round_cache_size() -> int:
    """Distinct round shapes (m, tq, chunk shape, k, code dtype) run in this
    process."""
    return len(_ROUND_SHAPES)


def _compact_state(sel, qpad, leaf, node, fromc, knn_d, knn_i, *, mc: int):
    """Gather live rows ``sel`` (i32[mc], -1 padding) into the compacted
    shape mc; padding rows become retired queries (leaf=-1, node=0)."""
    pad = sel < 0
    safe = sel.clamp(min=0).long()
    return (
        qpad[safe],
        torch.where(pad, -1, leaf[safe]),
        torch.where(pad, 0, node[safe]),
        torch.where(pad, 0, fromc[safe]),
        torch.cat([knn_d[safe], knn_d[-1:]], dim=0),
        torch.cat([knn_i[safe], knn_i[-1:]], dim=0),
    )


def _initial_advance(qpad, split_dim, split_val, *, first_leaf_heap):
    """Round 0: descend every query to its home leaf (no chunk needed)."""
    m = qpad.shape[0]
    st = traversal.init_state(m, qpad.device)
    radius = torch.full((m,), float("inf"), device=qpad.device)
    leaf, st = traversal.advance(
        st, qpad, radius, split_dim, split_val, first_leaf_heap=first_leaf_heap
    )
    return leaf, st.node, st.fromc


def _chunk_round(
    node,          # i32[m]   traversal heap position      (updated in place)
    fromc,         # i32[m]   traversal arrival direction  (updated in place)
    leaf,          # i32[m]   pending leaf per query, -1 done (read only)
    knn_d,         # f32[m+1, k] running top-k sq-dists    (updated in place)
    knn_i,         # i32[m+1, k] reordered-global indices  (updated in place)
    qpad,          # f32[m, d] queries
    dev_slab,      # f32[C, L_pad, d] resident chunk slab
    lo: int,       # first leaf id of the chunk
    leaf_start,    # i32[n_leaves]
    leaf_size,     # i32[n_leaves]
    split_dim,     # i64[2**h]
    split_val,     # f32[2**h]
    meta=(None, None, None),  # quantized store: (scale, offset, dead) of every leaf
    qeps: float = 0.0,        # traversal-radius inflation (quantization bound)
    *,
    k: int,
    tq: int,
    first_leaf_heap: int,
    backend: str,
):
    """One bulk-synchronous round over the resident chunk: scan every query
    paused at a leaf of this chunk, merge its candidates, exit its leaf and
    advance it to its next pending leaf.  ``dev_slab`` may hold fp16/int8
    codes, with ``meta`` the store's device metadata (int8 scale and
    offset, f32[L, d], None for fp16; the packed dead mask u8[L,
    ceil(L_pad/8)]) over all leaves.  Returns the new pending-leaf map and
    the device scalar n_units."""
    m = leaf.shape[0]
    c = dev_slab.shape[0]
    _ROUND_SHAPES.add((m, tq, tuple(dev_slab.shape), k, dev_slab.dtype))

    in_chunk = (leaf >= lo) & (leaf < lo + c)
    local = torch.where(in_chunk, leaf - lo, -1)
    unit_leaf, unit_query, n_units = _build_plan(local, tq, c)
    # rows >= n_units hold unit_query == -1: they land on the dump row m
    # together with the empty slots, whatever the kernel left there
    scan_merge(knn_d, knn_i, qpad, dev_slab, lo, unit_leaf, unit_query, n_units,
               leaf_start, leaf_size, meta, k=k, backend=backend)

    # exit the just-scanned leaves (only this chunk's queries move) and
    # advance them; everyone else is frozen by advance's pause predicate
    ex = traversal.exit_leaf(traversal.TraversalState(node, fromc), first_leaf_heap)
    st = traversal.TraversalState(
        node=torch.where(in_chunk, ex.node, node),
        fromc=torch.where(in_chunk, ex.fromc, fromc),
    )
    radius = kops.sqrt(knn_d[:m, k - 1]) + qeps
    new_leaf, st = traversal.advance(
        st, qpad, radius, split_dim, split_val, first_leaf_heap=first_leaf_heap
    )
    node.copy_(st.node)
    fromc.copy_(st.fromc)
    return new_leaf, n_units


def scan_merge(knn_d, knn_i, qpad, dev_slab, lo: int, unit_leaf, unit_query, n_units,
               leaf_start, leaf_size, meta=(None, None, None), *, k: int,
               backend: str) -> None:
    """ProcessAllBuffers on one resident chunk: the leaf scan of a work
    plan's units (``unit_leaf`` i32[W], leaves of ``dev_slab``, which starts
    at global leaf ``lo``; ``unit_query`` i32[W, TQ] rows of ``qpad``, -1 =
    empty; ``n_units`` the device scalar of units to scan), then the merge
    of their candidates into the running top-k ``knn_d`` / ``knn_i`` [m+1,
    k], in place (empty slots land on the dump row m).  ``meta`` is a
    quantized store's (scale, offset, dead) over every leaf."""
    c = dev_slab.shape[0]
    # one leaf holds at most L_pad candidates
    kl = min(k, dev_slab.shape[1])
    # the slab is indexed by the chunk's leaf, the metadata by the global one
    scale, offset, dead = (None if t is None else t[lo : lo + c] for t in meta)
    nd, nli = kops.leaf_scan_units(
        qpad, dev_slab, unit_leaf, unit_query, n_units, k=kl, backend=backend,
        scale=scale, offset=offset, dead=dead,
    )
    gl = unit_leaf.long() + lo
    valid = nli < leaf_size[gl][:, None, None]
    if dead is not None:
        # a dead row below the leaf size (a PAD_COORD row baked into the
        # slab, or a tombstone) can still be selected into a sparse leaf's
        # tail; the exact re-rank would rescore it at its true coordinates
        r = nli.clamp(0, dev_slab.shape[1] - 1).long()
        bits = dead[unit_leaf.long()[:, None, None], r >> 3].long()
        valid &= ((bits >> (7 - (r & 7))) & 1) == 0
    _merge(knn_d, knn_i, nd, nli, valid, leaf_start[gl], unit_query, k)


class _Readback:
    """A device->host copy in flight: a non-blocking copy into pinned
    memory plus an event on CUDA, a plain copy on the CPU."""

    def __init__(self, t: torch.Tensor):
        cuda = t.device.type == "cuda"
        self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        self.buf.copy_(t, non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


class ChunkResidentEngine:
    """Bulk-synchronous out-of-core query engine over a ``ChunkedLeafStore``
    (which must be uniform, so every chunk slab has one shape)."""

    def __init__(
        self,
        store: ChunkedLeafStore,
        split_dim: torch.Tensor,
        split_val: torch.Tensor,
        leaf_start: torch.Tensor,
        leaf_size: torch.Tensor,
        first_leaf_heap: int,
        *,
        backend: str = "auto",
        starvation_deadline: int = DEFAULT_STARVATION_DEADLINE,
    ):
        if store.n_chunks > 1 and not store.uniform:
            raise ValueError("ChunkResidentEngine needs ChunkedLeafStore(uniform=True)")
        self.store = store
        self._split_dim = split_dim.long()
        self._split_val = split_val
        self._leaf_start = leaf_start
        self._leaf_size = leaf_size
        self.first_leaf_heap = int(first_leaf_heap)
        # the kernel on a CUDA store, the plain version on a CPU store
        self.backend = kops.resolve_backend(backend, store.device)
        self.starvation_deadline = max(1, int(starvation_deadline))
        self._leaf_chunk = store.chunk_of_leaf(
            np.arange(store.n_leaves, dtype=np.int64)
        )
        # the dequantize metadata and radius inflation of a quantized store
        # (the reference's ``_quant_args``)
        self._meta = store.device_meta() if store.quantized else (None, None, None)
        self._qeps = float(store.quant_eps)

    def warm(self, m: int, k: int, tq: int) -> int:
        """Run the round once at the full batch shape and at every
        compaction-ladder rung (this builds the kernel and touches every
        shape a batch of ``m`` can reach).  Returns the number of shapes."""
        shapes = [int(m), *compaction_ladder(int(m))]
        dev = self.store.device
        d = self.store.host.shape[2]

        def state_at(ms: int):
            return (
                torch.zeros((ms,), dtype=torch.int32, device=dev),          # node
                torch.zeros((ms,), dtype=torch.int32, device=dev),          # fromc
                torch.full((ms,), -1, dtype=torch.int32, device=dev),       # leaf
                torch.full((ms + 1, k), kops.INVALID_DIST, device=dev),
                torch.full((ms + 1, k), -1, dtype=torch.int32, device=dev),
                torch.zeros((ms, d), device=dev),                           # qpad
            )

        for _cid, dev_slab, lo in self.store.stream([0]):
            for ms in shapes:
                node, fromc, leaf, knn_d, knn_i, qpad = state_at(ms)
                _chunk_round(
                    node, fromc, leaf, knn_d, knn_i, qpad, dev_slab, lo,
                    self._leaf_start, self._leaf_size, self._split_dim,
                    self._split_val, self._meta, self._qeps, k=k, tq=tq,
                    first_leaf_heap=self.first_leaf_heap, backend=self.backend,
                )
        return len(shapes)

    def _visit_order(
        self, counts: np.ndarray, threshold: int, starve: np.ndarray
    ) -> np.ndarray:
        """Chunk schedule for one round: the B/2 fill rule plus starved
        chunks; a forced flush of every pending chunk when none is
        admitted; pending-count-descending order.  Updates ``starve``."""
        eligible = (counts >= threshold) | (
            (counts > 0) & (starve >= self.starvation_deadline)
        )
        visit = np.nonzero(eligible)[0]
        if visit.size == 0:
            visit = np.nonzero(counts > 0)[0]
        visit = visit[np.argsort(-counts[visit], kind="stable")]
        starve[counts > 0] += 1
        starve[counts <= 0] = 0
        starve[visit] = 0
        return visit

    def run(
        self,
        qpad: torch.Tensor,     # f32[m, d] queries
        k: int,
        tq: int,
        buffer_size: int,
        on_retire=None,
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """Returns (sq-dists f32[m, k], reordered-global idx i32[m, k],
        info counters); distances are pre-rescoring.

        ``on_retire(rows, d2, gi)`` is called with original query rows whose
        traversal finished, their raw squared distances and reordered-global
        indices; every row is reported exactly once (the rest in one final
        call).  Detection rides the schedule readback, and the rows' values
        come from a non-blocking copy started at detection and completed
        before the next round is dispatched.
        """
        m = qpad.shape[0]
        store = self.store
        dev = store.device
        first_leaf = self.first_leaf_heap
        qpad = qpad.to(dev)

        knn_d = torch.full((m + 1, k), kops.INVALID_DIST, device=dev)
        knn_i = torch.full((m + 1, k), -1, dtype=torch.int32, device=dev)
        leaf, node, fromc = _initial_advance(
            qpad, self._split_dim, self._split_val, first_leaf_heap=first_leaf
        )

        out_d = np.full((m, k), kops.INVALID_DIST, np.float32)
        out_i = np.full((m, k), -1, np.int32)
        orig = np.arange(m)       # compacted row -> original query row
        ladder = list(compaction_ladder(m))
        m_cur = m

        info = {
            "rounds": 0, "chunk_rounds": 0, "units": 0,
            "queries_advanced": 0, "compactions": 0,
            "steady_rounds": 0, "tail_rounds": 0,
            "steady_s": 0.0, "tail_s": 0.0, "sync_wait_s": 0.0,
        }
        copies_before = store.copies
        unit_counts: List[torch.Tensor] = []
        starve = np.zeros(store.n_chunks, np.int32)

        reported = np.zeros(m, bool) if on_retire is not None else None
        pending_emit = None
        if reported is not None:
            info["early_retired"] = 0
            info["retire_emits"] = 0

        def flush_emit() -> None:
            nonlocal pending_emit
            if pending_emit is None:
                return
            rows, rc, d_rb, i_rb = pending_emit
            pending_emit = None
            t0 = time.perf_counter()
            d_rows = d_rb.wait()[rc]
            i_rows = i_rb.wait()[rc]
            info["sync_wait_s"] += time.perf_counter() - t0
            on_retire(rows, d_rows, i_rows)

        def note_retired() -> None:
            """Stage rows newly retired in ``sched`` for delivery (after
            delivering any earlier batch)."""
            nonlocal pending_emit
            if reported is None:
                return
            flush_emit()
            rc = np.nonzero(sched[: orig.size] < 0)[0]
            rc = rc[~reported[orig[rc]]]
            if rc.size == 0:
                return
            rows = orig[rc].copy()
            reported[rows] = True
            pending_emit = (rows, rc, _Readback(knn_d), _Readback(knn_i))
            info["early_retired"] += int(rc.size)
            info["retire_emits"] += 1

        issue = _ISSUE_LOCK if dev.type == "cuda" else contextlib.nullcontext()

        def dispatch_round(visit: np.ndarray) -> None:
            nonlocal leaf
            flush_emit()   # the round updates knn_d/knn_i: deliver first
            for _cid, dev_slab, lo in store.stream(visit.tolist()):
                with issue:
                    leaf, nu = _chunk_round(
                        node, fromc, leaf, knn_d, knn_i, qpad, dev_slab, lo,
                        self._leaf_start, self._leaf_size, self._split_dim,
                        self._split_val, self._meta, self._qeps, k=k, tq=tq,
                        first_leaf_heap=first_leaf, backend=self.backend,
                    )
                unit_counts.append(nu)
                info["chunk_rounds"] += 1
            info["rounds"] += 1
            info["queries_advanced"] += m_cur
            info["steady_rounds" if m_cur == m else "tail_rounds"] += 1

        def harvest(rb: _Readback) -> np.ndarray:
            """Blocking completion of a pending-leaf-map readback."""
            t0 = time.perf_counter()
            out = rb.wait().copy()
            info["sync_wait_s"] += time.perf_counter() - t0
            return out

        sched = harvest(_Readback(leaf))   # round 0: nothing to overlap yet
        inflight = None
        note_retired()

        while True:
            live_rows = np.nonzero(sched >= 0)[0]
            if live_rows.size == 0:
                if inflight is not None:
                    # stale map says done: drain and re-check
                    sched, inflight = harvest(inflight), None
                    note_retired()
                    continue
                break

            if ladder and live_rows.size <= ladder[0]:
                if inflight is not None:
                    sched, inflight = harvest(inflight), None
                    note_retired()
                    continue
                rung = ladder.pop(0)
                while ladder and live_rows.size <= ladder[0]:
                    rung = ladder.pop(0)
                t0 = time.perf_counter()
                out_d[orig] = knn_d[: orig.size].cpu().numpy()
                out_i[orig] = knn_i[: orig.size].cpu().numpy()
                info["sync_wait_s"] += time.perf_counter() - t0
                sel = np.full((rung,), -1, np.int32)
                sel[: live_rows.size] = live_rows
                qpad, leaf, node, fromc, knn_d, knn_i = _compact_state(
                    torch.from_numpy(sel).to(dev), qpad, leaf, node, fromc,
                    knn_d, knn_i, mc=rung,
                )
                orig = orig[live_rows]
                new_sched = np.full((rung,), -1, sched.dtype)
                new_sched[: live_rows.size] = sched[live_rows]
                sched = new_sched
                m_cur = rung
                info["compactions"] += 1
                continue

            threshold = max(1, min(int(buffer_size), m_cur) // 2)
            counts = np.bincount(
                self._leaf_chunk[sched[live_rows]], minlength=store.n_chunks
            )
            t0 = time.perf_counter()
            wait0 = info["sync_wait_s"]
            dispatch_round(self._visit_order(counts, threshold, starve))
            # overlap: complete the PREVIOUS round's readback while this
            # round computes, then start this round's
            if inflight is not None:
                sched = harvest(inflight)
                note_retired()
            inflight = _Readback(leaf)
            dt = time.perf_counter() - t0 - (info["sync_wait_s"] - wait0)
            info["steady_s" if m_cur == m else "tail_s"] += dt

        out_d[orig] = knn_d[: orig.size].cpu().numpy()
        out_i[orig] = knn_i[: orig.size].cpu().numpy()
        if reported is not None:
            flush_emit()
            rest = np.nonzero(~reported)[0]
            if rest.size:
                on_retire(rest, out_d[rest], out_i[rest])
                reported[rest] = True
        info["units"] = int(torch.stack(unit_counts).sum()) if unit_counts else 0
        info["chunk_copies"] = store.copies - copies_before
        return out_d, out_i, info
