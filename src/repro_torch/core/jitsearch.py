"""Device-resident bulk-synchronous LazySearch, and its work plan.

Counterpart of ``repro.core.jitsearch``.  LazySearch re-derived as a
bulk-synchronous fixed point that lives on the device:

  round = { advance all live queries to their next leaf        (FindLeafBatch)
            sort-by-leaf -> padded work plan                    (the buffers!)
            leaf-scan kernel over the plan -> top-k merge       (ProcessAll...)
            exit leaves }
  while any query live: round

The sort-by-leaf IS the buffer structure: queries bound for the same leaf
become adjacent after a stable sort, and each run of up to TQ of them
becomes one work unit, a dense [TQ x leaf] scan, expressed as sort +
cumsum + scatter on the device.  The plan width is fixed by the shapes: at
most ceil(m/TQ) full units plus one partial unit per leaf, so W_max =
ceil(m/TQ) + n_leaves, plus one dump row that every retired query
scatters into.

The reference runs the rounds in one ``lax.while_loop``.  Here every
round has fixed shapes and no host read (the leaf scan reads the plan's
``n_units`` on the device), so on CUDA one round is captured once into a
``torch.cuda.CUDAGraph`` after one eager round and then replayed; the host
reads the "any query live" flag back through a pinned, non-blocking copy
once every ``sync_every`` replays.  A round on a state where every query
has finished changes nothing (``advance`` and ``exit_leaf`` leave
``node == 0`` as it is, the plan is empty, and the merge writes only the
dump row), so the replays past the fixed point are harmless, and
``rounds`` counts, on the device, only the rounds in which a query was
live: the reference's count.  On the CPU the same round runs eagerly.

The round counts its own work on the device, in buffers the graph updates
on every replay: each round's leaf visits, (query, real row) pairs and plan
units (a row of the round log, ``kernels/ops.py::tally``), and the device
time of its four phases (advance, plan, scan, merge), measured by stamps on
the card's clock (``kernels/ops.py::stamp``; the host's clock on the CPU).
The tally runs after the round's last stamp, so the counting's own time is
in no phase.  One copy after the loop reads them back into
``JitRounds.last``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import traversal
from repro_torch.kernels import ops as kops

__all__ = [
    "TreeArrays",
    "JitRounds",
    "RoundWork",
    "RoundsCache",
    "lazy_knn_jit",
    "rescore",
    "tree_arrays_from",
    "_build_plan",
]

_BIG = 2**30
SYNC_EVERY = 8          # CUDA graph replays between two reads of the live flag
_RESCORE_ROWS = 1 << 16  # query rows per step of the final rescoring
CACHED_SHAPES = 4       # (m, k) states a RoundsCache keeps, most recent first
LOG_ROUNDS = 4096       # rounds the round log keeps; later ones count in the sums only
PHASES = ("advance", "plan", "scan", "merge")   # the stamped phases of a round, in order
_CAPTURE_LOCK = threading.Lock()


class TreeArrays(NamedTuple):
    """Device-side buffer k-d tree (small metadata + the leaf slabs)."""

    split_dim: torch.Tensor   # i64[2**h] (it indexes the feature axis)
    split_val: torch.Tensor   # f32[2**h]
    leaf_start: torch.Tensor  # i32[n_leaves]
    leaf_size: torch.Tensor   # i32[n_leaves]
    slabs: torch.Tensor       # f32[n_leaves, leaf_pad, d]
    orig_idx: torch.Tensor    # i64[n] reordered -> original


def tree_arrays_from(tree, device=None) -> TreeArrays:
    """Device arrays of a host ``TopTree``.  Slabs keep the points' own
    width d (the reference pads features to a multiple of 8; the leaf scan
    pads rows itself)."""
    dev = kops.resolve_device(device)

    def up(a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return TreeArrays(
        split_dim=up(tree.split_dim, torch.int64),
        split_val=up(tree.split_val, torch.float32),
        leaf_start=up(tree.leaf_start, torch.int32),
        leaf_size=up(tree.leaf_sizes(), torch.int32),
        slabs=up(tree.points_padded, torch.float32),
        orig_idx=up(tree.orig_idx, torch.int64),
    )


def _build_plan(
    leaf: torch.Tensor, tq: int, n_leaves: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """leaf: i32[m] target leaf per query, -1 for retired queries.

    Returns (unit_leaf i32[W+1], unit_query i32[W+1, TQ], n_units i32[]),
    dump row last.  Occupied units form the prefix [0, n_units); retired
    queries and empty slots hold -1 in ``unit_query``.
    """
    m = leaf.shape[0]
    dev = leaf.device
    w_max = (m + tq - 1) // tq + n_leaves

    key = torch.where(leaf < 0, _BIG, leaf.long())
    sl, order = torch.sort(key, stable=True)
    active = sl < _BIG
    ar = torch.arange(m, dtype=torch.int64, device=dev)
    prev = torch.cat([torch.full((1,), -7, dtype=sl.dtype, device=dev), sl[:-1]])
    newgrp = sl != prev
    group_start = torch.cummax(torch.where(newgrp, ar, 0), dim=0).values
    within = ar - group_start
    newunit = newgrp | (within % tq == 0)
    unit_id = torch.cumsum(newunit.to(torch.int64), dim=0) - 1
    unit_id = torch.where(active, torch.clamp(unit_id, max=w_max - 1), w_max)
    slot = within % tq
    n_units = torch.sum(active & newunit).to(torch.int32)

    # every query of one unit writes the same leaf id, and the dump row
    # only ever receives zeros / -1, so the duplicate writes are
    # deterministic
    unit_leaf = torch.zeros((w_max + 1,), dtype=torch.int32, device=dev)
    unit_leaf[unit_id] = torch.where(active, sl, 0).to(torch.int32)
    unit_query = torch.full((w_max + 1, tq), -1, dtype=torch.int32, device=dev)
    unit_query[unit_id, slot] = torch.where(active, order, -1).to(torch.int32)
    return unit_leaf, unit_query, n_units


def _merge(knn_d, knn_i, nd, nli, valid, ustart, unit_query, k: int) -> None:
    """Merge one plan's scan results into the running top-k, in place.

    ``nd`` / ``nli`` f32 / i32[W, TQ, kl] (slab-local rows), ``valid``
    bool[W, TQ, kl] (a real row of the unit's leaf), ``ustart`` i32[W]
    (global index of the leaf's first row).  Empty slots (``unit_query``
    -1, and every row past n_units) land on the dump row m whatever the
    kernel left there.  Old candidates come first, so a stable sort keeps
    them on ties (``lax.top_k``'s lowest-position order)."""
    m = knn_d.shape[0] - 1
    kl = nd.shape[-1]
    gidx = torch.where(valid, nli + ustart[:, None, None], -1).reshape(-1, kl)
    ndm = torch.where(valid, nd, kops.INVALID_DIST).reshape(-1, kl)
    flat_q = unit_query.reshape(-1)
    safe_q = torch.where(flat_q < 0, m, flat_q).long()
    cd = torch.cat([knn_d[safe_q], ndm], dim=1)
    ci = torch.cat([knn_i[safe_q], gidx], dim=1)
    sd, sel = torch.sort(cd, dim=1, stable=True)
    knn_d[safe_q] = sd[:, :k]
    knn_i[safe_q] = torch.gather(ci, 1, sel[:, :k])


class RoundWork(NamedTuple):
    """What one ``JitRounds.run`` counted on the device."""

    executed: int          # rounds run, the replays past the fixed point included
    leaf_visits: int       # queries placed into a plan, summed over the rounds
    useful_pairs: int      # (query, real row of its leaf) pairs of those visits
    units_scanned: int     # the plans' occupied units (``n_units``)
    phase_s: Tuple[Tuple[str, float], ...]   # (phase, device seconds), ``PHASES`` order
    log: np.ndarray        # i64[min(rounds, LOG_ROUNDS), 3]: each live round's
                           # visits, pairs and units


class JitRounds:
    """The fixed point's state for a batch of ``m`` queries at list width
    ``k``, in static buffers, and its round (captured on CUDA).

    ``run(queries, max_rounds)`` resets the state, copies the queries into
    their buffer and runs rounds until no query is live (or
    ``max_rounds``).  On CUDA the first ``run`` makes one eager round, then
    captures the round into a CUDA graph; later runs only replay it.  The
    leaf-scan wrapper counts its kernel launches once at the eager round
    and once at capture: a replay launches the captured kernel without the
    wrapper, so the kernel runs once per round executed
    (``eager_rounds + replays``).  What the rounds did is counted by the
    round itself, replays included: ``last`` holds the last run's
    ``RoundWork``."""

    def __init__(self, tree: TreeArrays, m: int, k: int, *, tq: int,
                 first_leaf_heap: int, backend: str = "auto",
                 sync_every: Optional[int] = None):
        dev = tree.slabs.device
        d = tree.slabs.shape[2]
        self.tree = tree
        self.m, self.k, self.tq = int(m), int(k), int(tq)
        self.first_leaf_heap = int(first_leaf_heap)
        self.backend = kops.resolve_backend(backend, dev)
        self.cuda = dev.type == "cuda"
        self.sync_every = int(sync_every or (SYNC_EVERY if self.cuda else 1))
        # one leaf holds at most L_pad candidates
        self.kl = min(self.k, tree.slabs.shape[1])
        self.queries = torch.zeros((self.m, d), device=dev)
        self.node = torch.ones((self.m,), dtype=torch.int32, device=dev)
        self.fromc = torch.zeros((self.m,), dtype=torch.int32, device=dev)
        self.knn_d = torch.full((self.m + 1, self.k), kops.INVALID_DIST, device=dev)
        self.knn_i = torch.full((self.m + 1, self.k), -1, dtype=torch.int32, device=dev)
        self.rounds = torch.zeros((), dtype=torch.int32, device=dev)
        self.live = torch.ones((), dtype=torch.bool, device=dev)
        # the device's counts, read back in one copy: the round log (row r
        # holds live round r's visits, pairs and units, row LOG_ROUNDS + 1
        # the sums of the rounds past it; row 0 stays 0), then the phase
        # clock (the last stamp, then each phase's nanoseconds)
        rows = LOG_ROUNDS + 2
        self.tally = torch.zeros((rows * 3 + 1 + len(PHASES),), dtype=torch.int64, device=dev)
        self._log = self.tally[: rows * 3].view(rows, 3)
        self._clock = self.tally[rows * 3:]
        self.last: Optional[RoundWork] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.eager_rounds = 0   # rounds run eagerly (lifetime)
        self.replays = 0        # graph replays (lifetime)

    def round(self) -> None:
        """One bulk-synchronous round over every query, in place, stamped
        at the start and at the end of each phase, then tallied (five
        stamps and one tally: the six launches the counts add)."""
        t, m, k, clock = self.tree, self.m, self.k, self._clock
        kops.stamp(clock, 0)
        self.rounds += (self.node != 0).any()
        radius = kops.sqrt(self.knn_d[:m, k - 1])
        leaf, st = traversal.advance(
            traversal.TraversalState(self.node, self.fromc), self.queries, radius,
            t.split_dim, t.split_val, first_leaf_heap=self.first_leaf_heap,
        )
        kops.stamp(clock, 1)
        unit_leaf, unit_query, n_units = _build_plan(leaf, self.tq, t.leaf_start.shape[0])
        kops.stamp(clock, 2)
        nd, nli = kops.leaf_scan_units(
            self.queries, t.slabs, unit_leaf, unit_query, n_units, k=self.kl,
            backend=self.backend,
        )
        kops.stamp(clock, 3)
        ul = unit_leaf.long()
        valid = nli < t.leaf_size[ul][:, None, None]
        _merge(self.knn_d, self.knn_i, nd, nli, valid, t.leaf_start[ul], unit_query, k)
        st = traversal.exit_leaf(st, self.first_leaf_heap)
        self.node.copy_(st.node)
        self.fromc.copy_(st.fromc)
        self.live.copy_((st.node != 0).any())
        kops.stamp(clock, 4)
        # the round's counts, after its last stamp: in no phase's time
        kops.tally(self._log, leaf, t.leaf_size, n_units, self.rounds)

    def _capture(self) -> None:
        # on a stream of its own (``torch.cuda.graph``'s default capture
        # stream is one for the process) and one capture at a time: the
        # forest captures each device slot's round from that slot's thread
        # while the other slots launch work
        graph = torch.cuda.CUDAGraph()
        with tracing.span("warm.capture"), _CAPTURE_LOCK, torch.cuda.graph(
                graph, stream=torch.cuda.Stream(self.queries.device),
                capture_error_mode="thread_local"):
            self.round()
        self.graph = graph

    def _step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
        else:
            self.round()
            self.eager_rounds += 1

    def release(self) -> None:
        """Free the captured graph and its memory pool; a later ``run``
        captures again."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None

    def reset(self, queries: torch.Tensor) -> None:
        self.queries.copy_(queries)
        self.node.fill_(1)
        self.fromc.zero_()
        self.knn_d.fill_(kops.INVALID_DIST)
        self.knn_i.fill_(-1)
        self.rounds.zero_()
        self.live.fill_(True)
        self.tally.zero_()

    def run(self, queries: torch.Tensor, max_rounds: int = 0) -> int:
        """Rounds to the fixed point (at most ``max_rounds`` when > 0);
        returns the rounds executed, live or not (the device count of live
        rounds is ``self.rounds``), and keeps their counts in ``last``."""
        self.reset(queries)
        done = 0
        if self.cuda and self.graph is None:
            self._step()          # the eager warm round, a real round
            done = 1
            self._capture()
        flag = torch.empty((), dtype=torch.bool, pin_memory=self.cuda)
        while not (max_rounds and done >= max_rounds):
            n = self.sync_every
            if max_rounds:
                n = min(n, max_rounds - done)
            for _ in range(n):
                self._step()
            done += n
            flag.copy_(self.live, non_blocking=self.cuda)
            if self.cuda:
                torch.cuda.current_stream(self.queries.device).synchronize()
            if not bool(flag):
                break
        self.last = self._read(done)
        return done

    def _read(self, executed: int) -> RoundWork:
        """The counts of the rounds just run, from one copy of ``tally``."""
        tally = self.tally.cpu().numpy()
        rows = LOG_ROUNDS + 2
        log = tally[: rows * 3].reshape(rows, 3)
        visits, pairs, units = (int(x) for x in log.sum(0))
        seconds = tally[rows * 3 + 1:] / 1e9
        return RoundWork(
            executed=executed, leaf_visits=visits, useful_pairs=pairs, units_scanned=units,
            phase_s=tuple(zip(PHASES, (float(s) for s in seconds))),
            log=log[1: 1 + min(int(self.rounds), LOG_ROUNDS)].copy(),
        )


class RoundsCache(OrderedDict):
    """(m, k) -> ``JitRounds``, the ``CACHED_SHAPES`` most recently used.
    Each entry holds m-sized buffers and, on CUDA, a graph with its own
    memory pool, so a caller whose batch sizes vary would otherwise grow
    device memory without bound; an evicted entry's graph is released."""

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > CACHED_SHAPES:
            _, old = self.popitem(last=False)
            old.release()


def rescore(queries: torch.Tensor, tree: TreeArrays, gi: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rescoring of the selected candidates (the reference's final
    step: direct (q - x)^2 from the slab rows, re-sorted, ties to the
    earlier position).  ``gi`` i32[m, k] reordered-global indices ->
    (f32[m, k] squared distances ascending, i64[m, k] original ids, -1 =
    none).  Runs over blocks of rows to bound the [rows, k, d] gather."""
    leaf_pad, d = tree.slabs.shape[1], tree.slabs.shape[2]
    flat = tree.slabs.reshape(-1, d)
    out_d, out_i = [], []
    for s in range(0, gi.shape[0], _RESCORE_ROWS):
        g = gi[s : s + _RESCORE_ROWS].long()
        safe = g.clamp(min=0)
        leaf = (torch.searchsorted(tree.leaf_start.long(), safe, right=True) - 1).clamp(min=0)
        rows = leaf * leaf_pad + (safe - tree.leaf_start.long()[leaf])
        diff = flat[rows] - queries[s : s + _RESCORE_ROWS, None, :]
        d2 = torch.sum(diff * diff, dim=-1)
        d2 = torch.where(g < 0, float("inf"), d2)
        d2, order = torch.sort(d2, dim=1, stable=True)
        g = torch.gather(g, 1, order)
        oi = torch.where(g >= 0, tree.orig_idx[g.clamp(min=0)], -1)
        out_d.append(d2)
        out_i.append(oi)
    return torch.cat(out_d), torch.cat(out_i)


def lazy_knn_jit(
    queries: torch.Tensor,          # f32[m, d]
    tree: TreeArrays,
    *,
    k: int,
    tq: int = 128,
    first_leaf_heap: int,
    backend: str = "auto",
    max_rounds: int = 0,            # 0 => run to the fixed point
    cache: Optional[Dict[Tuple[int, int], JitRounds]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Bulk-synchronous LazySearch over one reference set.

    Returns (sq_dists f32[m, k], original ids i64[m, k], rounds).  ``cache``
    (a ``RoundsCache``, or any dict) keeps each (m, k)'s ``JitRounds`` (and
    so its CUDA graph) across calls, the one just used last; its ``last``
    holds the rounds' device counts.  Host spans ``query.rounds`` (the
    replays and flag reads) and ``query.rescore`` (ending in a synchronize,
    so it holds the rescoring's device time, not only its launch).
    """
    dev = tree.slabs.device
    queries = queries.to(dev)
    r = _rounds_for(queries.shape[0], k, tree, tq, first_leaf_heap, backend, cache)
    with tracing.span("query.rounds"):
        r.run(queries, max_rounds)
        rounds = int(r.rounds)
    with tracing.span("query.rescore"):
        d2, oi = rescore(queries, tree, r.knn_i[: r.m])
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return d2, oi, rounds


def _rounds_for(m, k, tree, tq, first_leaf_heap, backend, cache) -> JitRounds:
    key = (int(m), int(k))
    r = cache.pop(key, None) if cache is not None else None
    if r is None:
        r = JitRounds(tree, m, k, tq=tq, first_leaf_heap=first_leaf_heap, backend=backend)
    if cache is not None:
        cache[key] = r
    return r
