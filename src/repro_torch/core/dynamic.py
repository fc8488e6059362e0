"""Batch-dynamic mutable index: a device-aware logarithmic-method forest.

Counterpart of ``repro.core.dynamic``.  The live point multiset is split
over a small forest of immutable shards whose capacities are ``B * 2**i``
(one shard per rung once merges settle, like the bits of a binary
counter); each shard is served by one of the port's static engines:

    rung capacity <= brute_cutoff   ->  tiled brute scan (``brute._tile_step``)
    rung capacity  > brute_cutoff   ->  ``BufferKDTree`` (chunked engine: its
                                        scans are the CUDA leaf scan)

  insert(points)   the batch becomes a new shard at the smallest fitting
                   rung; a rung collision MERGES the two shards one rung up
                   (the carry chain).  A batch at or beyond the
                   rebuild/merge crossover flattens the forest into one
                   shard instead.
  delete(ids)      tombstones: the row's ``live`` bit is cleared and the row
                   is reclaimed in the backing structure (PAD_COORD in a
                   brute shard's slab, ``ChunkedLeafStore.kill_rows`` plus
                   the leaf-ordered copies in a tree shard), so a dead row
                   ranks after every live one; a shard past ``tomb_limit``
                   tombstones is compacted, an empty one dropped.
  query(q, k)      fans out over the shards, one thread per device slot
                   (``DeviceFanout``), and folds the per-shard sorted lists
                   with ``kernels/knn_scan.py::_rank_merge`` on the lead
                   slot's device.

Devices are slots: ``devices=(cuda:0,) * 4`` places shards on four slots of
one card (``distributed/dynamic_shards.py``).  Tree rungs go to the
least-loaded slot, brute rungs to the lead slot.

Background carry merges (``merge_async=True``): a collision does not block
the insert; the colliding shards' live rows are snapshotted under the
mutation lock, the ``MergeWorker`` thread builds the merged shard off the
lock, waits on a CUDA event recorded after the build's uploads (so the
staging shard is complete on the device before any other thread can see
it), and swaps it in under the lock, re-applying deletes that landed on
the sources meanwhile.  A source that disappeared (compaction, flattening)
aborts the merge.  A failed build, a kernel that fails to build or launch
included, is retried with capped backoff and surfaces through ``drain``
as ``MergeRetryExhausted``; it never finishes on the CPU or on the plain
scan.

The reference's jitted ``_filter_sort`` and ``_merge_pair`` are torch
functions here; ``merge_cache_size`` and ``shard_scan_cache_size`` count
the distinct shapes they and the brute scan ran (nothing is compiled, the
counters keep the reference's shape discipline testable): a shape depends
on the rung and the padded batch, never on live or tombstone counts.

Exactness under tombstones: a shard fetches ``min(k, capacity)``
candidates, because a reclaimed row cannot outrank a live one, and the
fold masks dead and pad candidates by the ``live`` bits.  Tree shards keep
the port's own repairs (overfetch, the certificate, the refining pass and
fp32 brute force over ``tree.points``); the certificate bounds its rounding
by the live rows' norms (``BufferKDTree(live=...)``), so the PAD_COORD
rows a shard is padded with, or that a delete writes, do not leave every
row unproven.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.brute import _tile_step
from repro_torch.core.lazysearch import BufferKDTree, SearchStats
from repro_torch.core.quantize import BYTES_PER_ELEM, PRECISIONS, QuantizedSlabs
from repro_torch.core.toptree import (
    PAD_COORD,
    _round_up,
    suggest_height,
    tree_from_arrays,
    tree_to_arrays,
)
from repro_torch.distributed.dynamic_shards import (
    DeviceFanout,
    MergeRetryExhausted,
    MergeWorker,
    ShardPlacer,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.knn_scan import _rank_merge

faults.load_env()

__all__ = [
    "DynamicIndex",
    "DEFAULT_BASE_CAPACITY",
    "DEFAULT_TOMB_LIMIT",
    "DEFAULT_BRUTE_CUTOFF",
    "MERGE_MAX_RETRIES",
    "merge_cache_size",
    "shard_scan_cache_size",
]

DEFAULT_BASE_CAPACITY = 1024   # B: smallest shard rung
DEFAULT_TOMB_LIMIT = 32        # per-shard tombstones before compaction
DEFAULT_BRUTE_CUTOFF = 2048    # rungs above this get a BufferKDTree engine

# bounded retry of failed background merges (capped exponential backoff);
# a persistent failure surfaces as MergeRetryExhausted on drain()
MERGE_MAX_RETRIES = 4
_MERGE_RETRY_BASE_S = 0.05
_MERGE_RETRY_CAP_S = 1.0

_MIN_BATCH_PAD = 16            # smallest padded query-batch rung
_BRUTE_TILE_X = 2048           # reference tile for brute shards
_BRUTE_TILE_Q = 1024           # query tile for brute shards

# distinct shapes run by the fold and by the brute shard scan (process-wide,
# like the reference's jit caches)
_MERGE_SHAPES: Set[Tuple] = set()
_SCAN_SHAPES: Set[Tuple] = set()


def _pad_batch(m: int) -> int:
    """Next power-of-two batch rung >= m (floored at ``_MIN_BATCH_PAD``)."""
    p = _MIN_BATCH_PAD
    while p < m:
        p <<= 1
    return p


def _filter_sort(d: torch.Tensor, keep: torch.Tensor, code_base: int):
    """Mask dead candidates to +inf and sort ascending, stably (equal
    distances keep the engine's order): d f32[mp, w], keep bool[mp, w] ->
    (sorted dists, codes i32[mp, w] = code_base + original column)."""
    _MERGE_SHAPES.add(("filter_sort",) + tuple(d.shape))
    d = torch.where(keep, d, torch.inf)
    sd, order = torch.sort(d, dim=1, stable=True)
    return sd, order.to(torch.int32) + code_base


def _merge_pair(a_d, a_c, b_d, b_c, *, w: int):
    """Fold two sorted w-lists into their w smallest (the kernel's rank
    merge; ``a`` wins ties)."""
    _MERGE_SHAPES.add(("merge_pair",) + tuple(a_d.shape))
    return _rank_merge(a_d, a_c, b_d, b_c, w)


def merge_cache_size() -> int:
    """Distinct shapes the fan-out fold ran (filter/sort + pairwise merge):
    once per (padded batch, candidate width), never per shard count."""
    return len(_MERGE_SHAPES)


def shard_scan_cache_size() -> int:
    """Distinct shapes the brute shard scan ran: once per (query tile, shard
    tile, d, fetch width) per device."""
    return len(_SCAN_SHAPES)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class _Shard:
    """One immutable slab of the forest (mutated only through tombstone bits
    and the matching reclaim).  Identity semantics: the merge swap tracks
    shards by object, never by content."""

    rung: int                      # capacity = base << rung
    capacity: int
    points: np.ndarray             # f32[capacity, d]; PAD_COORD beyond n_rows
    ids: np.ndarray                # i64[capacity]; ascending, -1 pads
    live: np.ndarray               # bool[capacity]; False for pads/tombstones
    n_rows: int                    # occupied rows (live + tombstoned)
    n_tomb: int = 0
    engine: Optional[BufferKDTree] = None   # None => brute scan
    slot: int = 0                  # device slot (ordinal in the device list)
    device: Any = None             # that slot's device
    seq: int = 0                   # creation order: stable fan-out order
    merging: bool = False          # reserved by an in-flight background merge
    tomb_limit: int = DEFAULT_TOMB_LIMIT
    _dev_slab: Optional[torch.Tensor] = None   # brute: device copy, tile-padded

    @property
    def n_live(self) -> int:
        return self.n_rows - self.n_tomb

    @property
    def kind(self) -> str:
        return "brute" if self.engine is None else "tree"

    def fetch_width(self, k: int) -> int:
        """Candidates fetched per shard for a k-NN query: bare ``k``, since
        deletes reclaim the row in the backing structure (a dead row cannot
        outrank a live one)."""
        return min(k, self.capacity)

    def dev_slab(self) -> torch.Tensor:
        """Brute slab on this shard's device, tile-padded with PAD_COORD
        rows, made once; tombstones write into it in place."""
        if self._dev_slab is None:
            tx = min(self.capacity, _BRUTE_TILE_X)
            nx = _round_up(self.capacity, tx)
            slab = self.points
            if nx != self.capacity:
                pad = np.full((nx - self.capacity, slab.shape[1]), np.float32(PAD_COORD))
                slab = np.concatenate([slab, pad])
            self._dev_slab = kops.owned_tensor(slab, self.device)
        return self._dev_slab


class DynamicIndex:
    """Mutable exact-kNN index over a logarithmic-method shard forest.

    Global ids are assigned in insertion order (``from_points`` gives
    ``0..n-1``), never reused, and are what ``query`` returns.  ``devices``
    is a list of devices, one slot each (default: ``cuda:0``); the
    reference's arguments otherwise."""

    def __init__(
        self,
        d: int,
        *,
        base_capacity: int = DEFAULT_BASE_CAPACITY,
        tomb_limit: int = DEFAULT_TOMB_LIMIT,
        brute_cutoff: int = DEFAULT_BRUTE_CUTOFF,
        rebuild_crossover: Optional[int] = None,
        tile_q: int = 128,
        backend: str = "auto",
        devices: Optional[Sequence[Any]] = None,
        merge_async: bool = False,
        precision: str = "fp32",
        memory_budget: Optional[int] = None,
    ):
        if d < 1:
            raise ValueError(f"need d >= 1, got {d}")
        if base_capacity < 2:
            raise ValueError(f"base_capacity must be >= 2, got {base_capacity}")
        if tomb_limit < 1:
            raise ValueError(f"tomb_limit must be >= 1, got {tomb_limit}")
        if brute_cutoff < 4:
            raise ValueError(f"brute_cutoff must be >= 4, got {brute_cutoff}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision={precision!r} not in {PRECISIONS}")
        if memory_budget is not None and memory_budget < 1:
            raise ValueError(f"memory_budget must be >= 1, got {memory_budget}")
        self.d = int(d)
        self.base_capacity = int(base_capacity)
        self.tomb_limit = int(tomb_limit)
        self.brute_cutoff = int(brute_cutoff)
        self.rebuild_crossover = int(rebuild_crossover) if rebuild_crossover is not None else None
        self.tile_q = int(tile_q)
        self.backend = backend
        self.merge_async = bool(merge_async)
        self.precision = precision
        self.memory_budget = int(memory_budget) if memory_budget is not None else None
        devs = [kops.resolve_device(dv) for dv in (devices or [None])]
        self._placer = ShardPlacer(devs)
        # the device of every slot; placement drops lost slots, this never changes
        self._devices: Tuple[torch.device, ...] = tuple(devs)
        self._fanout = DeviceFanout()
        self._merger: Optional[MergeWorker] = None
        self._shards: List[_Shard] = []
        self._seq = itertools.count()
        self._next_id = 0
        self._n_live = 0
        self._last_stats = SearchStats()
        self._warm_shapes: set = set()
        # _mu guards the forest's topology and live bits against the merge
        # worker; user calls are serialized by the KNNIndex facade
        self._mu = threading.RLock()
        self._merge_stats = {
            "scheduled": 0, "completed": 0, "aborted": 0, "failed": 0,
            "inline": 0, "retried": 0, "device_loss": 0,
        }
        self._retry_streak = 0         # consecutive merge failures
        self._events: List[str] = []   # operational events -> SearchStats
        self._merge_test_hook = None   # tests: callable(phase, snaps)

    # ------------------------------------------------------------------
    @classmethod
    def from_points(cls, points: np.ndarray, **kw) -> "DynamicIndex":
        points = np.asarray(points, np.float32)
        if points.ndim != 2:
            raise ValueError(f"points must be [n, d], got {points.shape}")
        idx = cls(points.shape[1], **kw)
        idx.insert(points)
        return idx

    # ------------------------------------------------------------------
    @property
    def n_live(self) -> int:
        return self._n_live

    @property
    def stats(self) -> SearchStats:
        return self._last_stats

    @property
    def pending_merges(self) -> int:
        """Background carry merges still in flight (0 when inline)."""
        return self._merger.pending if self._merger is not None else 0

    def merge_stats(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._merge_stats)

    def drain_merges(self, timeout: Optional[float] = None) -> None:
        """Block until every background merge (and its carry chain, backoff
        retries included) has landed; no-op when inline.  Raises
        ``MergeRetryExhausted`` (with ``.rung``) when a merge kept failing,
        and ``DrainTimeout`` (with ``.rungs``) when ``timeout`` expires."""
        if self._merger is not None:
            self._merger.drain(timeout)

    def _sorted_shards(self) -> List[_Shard]:
        return sorted(self._shards, key=lambda s: (s.rung, s.seq))

    def shard_layout(self) -> List[Tuple[int, int, int, str]]:
        """(capacity, live, tombstones, kind) per shard, smallest rung first
        (duplicates at a rung: a background merge is pending)."""
        with self._mu:
            return [(s.capacity, s.n_live, s.n_tomb, s.kind) for s in self._sorted_shards()]

    def placement(self) -> List[Tuple[int, str, int]]:
        """(capacity, kind, slot) per shard: the live placement map."""
        with self._mu:
            return [(s.capacity, s.kind, s.slot) for s in self._sorted_shards()]

    def handle_device_loss(self, slot: int) -> str:
        """Degrade after device slot ``slot`` stops answering: drop it from
        placement and rebuild its shards on the survivors from the host
        arrays (the tree is kept, no median-split build; a code store's
        codes and dead mask are adopted).  Returns the event string, which
        also goes into the next ``SearchStats.events``; raises when ``slot``
        is the last one."""
        with self._mu:
            if slot not in self._placer.slots:
                return ""   # a concurrent loss already handled it
            self._placer.drop_device(slot)   # raises on the last slot
            moved = 0
            for s in self._shards:
                if s.slot == slot:
                    s.slot = self._placer.place(s.capacity, s.kind)
                    s.device = self._devices[s.slot]
                    s._dev_slab = None
                    if s.engine is not None:
                        s.engine = BufferKDTree(
                            s.points, tree=s.engine.tree, n_chunks=s.engine.store.n_chunks,
                            tile_q=self.tile_q, backend=self.backend, device=s.device,
                            precision=s.engine.precision,
                            store_state=(s.engine.store.quantized_state()
                                         if s.engine.store.quantized else None),
                            live=s.live,
                        )
                    moved += 1
            self._merge_stats["device_loss"] += 1
            event = (
                f"device loss: device {slot} ({self._devices[slot]}) dropped; "
                f"re-placed {moved} shard(s) across {self._placer.n_devices} "
                "surviving device(s); queries degrade to survivors, exactness "
                "preserved"
            )
            self._events.append(event)
        return event

    def live_ids(self) -> np.ndarray:
        """Sorted i64 ids of the live multiset."""
        with self._mu:
            parts = [s.ids[s.live] for s in self._shards]
        if not parts:
            return np.empty((0,), np.int64)
        return np.sort(np.concatenate(parts))

    def resident_bytes(self) -> int:
        """Largest per-slot byte footprint of the shards' device arrays."""
        with self._mu:
            per_slot: Dict[int, int] = {}
            for s in self._shards:
                b = (s.engine.store.resident_bytes() if s.engine is not None
                     else s.capacity * self.d * 4)
                per_slot[s.slot] = per_slot.get(s.slot, 0) + b
        return max(per_slot.values(), default=0)

    # ------------------------------------------------------------------
    # snapshots, in the reference's format (repro_torch.persist writes them)
    # ------------------------------------------------------------------
    def snapshot(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """Array map of the forest (per shard: slab, ids, live bits; tree
        shards also the tree arrays and a code store's codes and dead mask)
        and a JSON-able meta dict.  Taken under the mutation lock, so a
        pending merge's SOURCES are captured (the same live multiset) and
        ``restore`` schedules the collision again."""
        with self._mu:
            arrays: Dict[str, np.ndarray] = {}
            shard_meta: List[dict] = []
            for i, s in enumerate(self._sorted_shards()):
                arrays[f"shard{i}/points"] = s.points.copy()
                arrays[f"shard{i}/ids"] = s.ids.copy()
                arrays[f"shard{i}/live"] = s.live.copy()
                sm = dict(rung=s.rung, capacity=s.capacity, n_rows=s.n_rows,
                          n_tomb=s.n_tomb, kind=s.kind)
                if s.engine is not None:
                    t = s.engine.tree
                    for key, arr in tree_to_arrays(t, include_derived=True).items():
                        arrays[f"shard{i}/tree/{key}"] = arr.copy()
                    sm["tree"] = dict(height=t.height, leaf_pad=t.leaf_pad)
                    if s.engine.store.quantized:
                        qs = s.engine.store.quantized_state().reference_layout()
                        for key, arr in qs.to_arrays(prefix=f"shard{i}/quant").items():
                            arrays[key] = np.array(arr, copy=True)
                shard_meta.append(sm)
            meta = dict(
                d=self.d, base_capacity=self.base_capacity, tomb_limit=self.tomb_limit,
                brute_cutoff=self.brute_cutoff, rebuild_crossover=self.rebuild_crossover,
                # the backend follows the device a snapshot is restored on
                tile_q=self.tile_q, backend="auto", merge_async=self.merge_async,
                precision=self.precision, memory_budget=self.memory_budget,
                next_id=int(self._next_id), n_live=int(self._n_live),
                warm_shapes=sorted(list(t) for t in self._warm_shapes),
                shards=shard_meta,
            )
        return arrays, meta

    @classmethod
    def restore(cls, arrays: Dict[str, np.ndarray], meta: dict, *,
                devices: Optional[Sequence[Any]] = None) -> "DynamicIndex":
        """A forest from ``snapshot()`` output (the port's or the
        reference's) without any median-split build: tree shards take
        their ``TopTree`` from the split arrays and their code store's
        state as saved.  Shards are placed biggest first on ``devices``
        (snapshots hold no placement).  The backend is "auto", whatever the
        snapshot says (a name of the reference's kernels, or the saving
        host's): the device it is restored on decides it."""
        idx = cls(
            int(meta["d"]), base_capacity=int(meta["base_capacity"]),
            tomb_limit=int(meta["tomb_limit"]), brute_cutoff=int(meta["brute_cutoff"]),
            rebuild_crossover=meta.get("rebuild_crossover"), tile_q=int(meta["tile_q"]),
            backend="auto", devices=devices, merge_async=bool(meta["merge_async"]),
            precision=str(meta.get("precision", "fp32")),
            memory_budget=meta.get("memory_budget"),
        )
        idx._warm_shapes = {tuple(t) for t in meta.get("warm_shapes", [])}
        order = sorted(range(len(meta["shards"])),
                       key=lambda i: -int(meta["shards"][i]["capacity"]))
        with idx._mu:
            for i in order:
                sm = meta["shards"][i]
                pts = np.array(arrays[f"shard{i}/points"], np.float32)
                ids = np.array(arrays[f"shard{i}/ids"], np.int64)
                live = np.array(arrays[f"shard{i}/live"], bool)
                cap = int(sm["capacity"])
                slot = idx._placer.place(cap, sm["kind"])
                engine = None
                if sm["kind"] == "tree":
                    tm = sm["tree"]
                    prefix = f"shard{i}/tree/"
                    t_arr = {key[len(prefix):]: np.array(arr) for key, arr in arrays.items()
                             if key.startswith(prefix)}
                    reordered = t_arr.get("points")
                    if reordered is None:
                        reordered = pts[t_arr["orig_idx"]]
                    tree = tree_from_arrays(reordered, t_arr, height=int(tm["height"]),
                                            leaf_pad=int(tm["leaf_pad"]))
                    store_state = None
                    if f"shard{i}/quant/codes" in arrays:
                        store_state = QuantizedSlabs.from_arrays(
                            arrays, idx.precision, prefix=f"shard{i}/quant")
                        store_state.dead = np.array(store_state.dead, copy=True)
                    engine = BufferKDTree(
                        pts, tree=tree,
                        n_chunks=idx._tree_shard_chunks(cap, int(tm["height"])),
                        tile_q=idx.tile_q, backend=idx.backend, device=idx._devices[slot],
                        precision=idx.precision, store_state=store_state, live=live,
                    )
                shard = _Shard(
                    rung=int(sm["rung"]), capacity=cap, points=pts, ids=ids, live=live,
                    n_rows=int(sm["n_rows"]), n_tomb=int(sm["n_tomb"]), engine=engine,
                    slot=slot, device=idx._devices[slot], seq=next(idx._seq),
                    tomb_limit=idx.tomb_limit,
                )
                if engine is not None and shard.n_tomb:
                    # the reclaim again (idempotent): snapshots written before
                    # the tree-shard reclaim existed lack it
                    idx._reclaim_tree_rows(shard, np.nonzero(~live[: shard.n_rows])[0])
                idx._shards.append(shard)
            idx._next_id = int(meta["next_id"])
            idx._n_live = int(meta["n_live"])
            # a snapshot taken mid-merge holds the sources: resolve it now
            idx._schedule_carries()
        return idx

    # ------------------------------------------------------------------
    def _fit_rung(self, count: int) -> int:
        r = 0
        while (self.base_capacity << r) < count:
            r += 1
        return r

    def _tree_geom(self, cap: int, height: int) -> Tuple[int, int, int]:
        """(n_leaves, per-leaf slab bytes, dequantize meta bytes) of a
        rung-``cap`` tree shard at ``height`` (the port's leaves keep width
        d; rows padded to a multiple of 8 as ``build_top_tree`` does)."""
        n_leaves = 1 << height
        leaf_pad = max(_round_up(-(-cap // n_leaves), 8), 8)
        leaf_bytes = leaf_pad * self.d * BYTES_PER_ELEM[self.precision]
        if self.precision == "fp32":
            meta = 0
        elif self.precision == "fp16":
            meta = n_leaves * (-(-leaf_pad // 8))
        else:
            meta = n_leaves * (2 * self.d * 4 + -(-leaf_pad // 8))
        return n_leaves, leaf_bytes, meta

    def _tree_shard_height(self, cap: int) -> int:
        """The usual height for a rung-``cap`` shard, deepened under a
        ``memory_budget`` until two leaves (the streaming floor) fit."""
        height = suggest_height(cap)
        if self.memory_budget is None:
            return height
        max_h = max(height, (max(2, cap // 8)).bit_length() - 1)
        best_h, best_floor = height, None
        for h in range(height, max_h + 1):
            n_leaves, leaf_bytes, meta = self._tree_geom(cap, h)
            if (n_leaves * leaf_bytes + meta <= self.memory_budget
                    or 2 * leaf_bytes + meta <= self.memory_budget):
                return h
            floor = 2 * leaf_bytes + meta
            if best_floor is None or floor < best_floor:
                best_h, best_floor = h, floor
        return best_h

    def _tree_shard_chunks(self, cap: int, height: int) -> int:
        """Chunks of one tree shard's leaf store: resident when it fits the
        ``memory_budget``, else two streamed buffers; below the 2-leaf floor
        one leaf per chunk, recorded as an over-budget event."""
        if self.memory_budget is None:
            return 1
        n_leaves, leaf_bytes, meta = self._tree_geom(cap, height)
        if n_leaves * leaf_bytes + meta <= self.memory_budget:
            return 1
        chunk_leaves = (self.memory_budget - meta) // (2 * leaf_bytes)
        if chunk_leaves >= 1:
            return min(-(-n_leaves // int(chunk_leaves)), n_leaves)
        with self._mu:
            self._events.append(
                f"over budget: memory_budget={self.memory_budget}B is below the "
                f"rung-{cap} tree shard's 2-leaf streaming floor "
                f"{2 * leaf_bytes + meta}B at precision {self.precision}; "
                "streaming one leaf per chunk"
            )
        return n_leaves

    def _make_shard(self, pts: np.ndarray, ids: np.ndarray) -> _Shard:
        """Build one immutable shard from live rows, place it and run its
        scan for every registered warm shape.  Runs without the mutation
        lock from the merge worker (its inputs are snapshots; the placer
        has its own lock).  On CUDA the shard's uploads are complete when it
        returns: an event recorded after them is waited on, so another
        thread never sees a staging shard whose slabs are still in
        flight."""
        order = np.argsort(ids, kind="stable")
        pts, ids = pts[order], ids[order]
        n = pts.shape[0]
        rung = self._fit_rung(n)
        cap = self.base_capacity << rung
        slab = np.full((cap, self.d), np.float32(PAD_COORD))
        slab[:n] = pts
        id_arr = np.full((cap,), -1, np.int64)
        id_arr[:n] = ids
        live = np.zeros((cap,), bool)
        live[:n] = True
        kind = "brute" if cap <= self.brute_cutoff else "tree"
        slot = self._placer.place(cap, kind)
        device = self._devices[slot]
        try:
            engine = None
            if kind == "tree":
                # a chunked-engine shard over the whole padded slab: the rung,
                # not the live count, sets its shapes
                height = self._tree_shard_height(cap)
                engine = BufferKDTree(
                    slab, height=height, n_chunks=self._tree_shard_chunks(cap, height),
                    tile_q=self.tile_q, backend=self.backend, device=device,
                    precision=self.precision, live=live,
                )
            shard = _Shard(
                rung=rung, capacity=cap, points=slab, ids=id_arr, live=live, n_rows=n,
                engine=engine, slot=slot, device=device, seq=next(self._seq),
                tomb_limit=self.tomb_limit,
            )
            self._warm_shard(shard)
            if device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
                ready.synchronize()
        except BaseException:
            self._placer.release(cap, slot)
            raise
        return shard

    def _warm_shard(self, shard: _Shard) -> None:
        """Run the shard's scan for every registered (batch, k) shape, at
        construction: in the merge worker for staging shards, never on the
        query path."""
        with self._mu:
            shapes = sorted(self._warm_shapes)
        for mp, k in shapes:
            kq = shard.fetch_width(k)
            if shard.engine is not None:
                shard.engine.warm(mp, kq)
            else:
                qz = torch.zeros((mp, self.d), dtype=torch.float32, device=shard.device)
                self._brute_scan(shard, qz, kq)

    def _drop_shard(self, shard: _Shard) -> None:
        """Remove from the forest and return its capacity to the placer
        (caller holds ``_mu``)."""
        self._shards.remove(shard)
        self._placer.release(shard.capacity, shard.slot)

    # ------------------------------------------------------------------
    # carry chain: inline (merge_async=False) or background staging swap
    # ------------------------------------------------------------------
    def _collisions(self) -> Dict[int, List[_Shard]]:
        by: Dict[int, List[_Shard]] = {}
        for s in self._sorted_shards():
            if not s.merging:
                by.setdefault(s.rung, []).append(s)
        return {r: ss for r, ss in by.items() if len(ss) >= 2}

    def _schedule_carries(self) -> None:
        """Resolve rung collisions (caller holds ``_mu``): fuse inline, or
        snapshot the sources and hand the merge to the background worker."""
        if not self.merge_async:
            while True:
                coll = self._collisions()
                if not coll:
                    return
                a, b = coll[min(coll)][:2]
                pts = np.concatenate([a.points[a.live], b.points[b.live]])
                ids = np.concatenate([a.ids[a.live], b.ids[b.live]])
                self._drop_shard(a)
                self._drop_shard(b)
                self._shards.append(self._make_shard(pts, ids))
                self._merge_stats["inline"] += 1
        if self._merger is None:
            self._merger = MergeWorker()
        while True:   # a rung may hold > 2 free shards after an abort
            coll = self._collisions()
            if not coll:
                return
            for _, ss in sorted(coll.items()):
                a, b = ss[0], ss[1]
                a.merging = b.merging = True
                # the live rows NOW, under the lock: the worker must never
                # read arrays a concurrent delete overwrites
                snaps = [(s, s.points[s.live].copy(), s.ids[s.live].copy()) for s in (a, b)]
                self._merge_stats["scheduled"] += 1
                self._merger.submit(functools.partial(self._merge_task, snaps), meta=a.rung)

    def _merge_task(self, snaps) -> None:
        """Background carry merge: build the staging shard off the lock from
        the snapshots, then swap it in atomically, re-applying the deletes
        that landed on the sources meanwhile; an over-tombstoned result is
        compacted off the lock and the swap tried again.  On any failure the
        sources are released and the merge is retried with capped backoff;
        after ``MERGE_MAX_RETRIES`` consecutive failures
        ``MergeRetryExhausted`` surfaces on the next ``drain()``.  The
        sources stay untouched until the swap, so a failed merge loses
        nothing."""
        staged: List[_Shard] = []   # placed but not yet swapped or released
        hook = self._merge_test_hook

        def _discard(shard: _Shard) -> None:
            self._placer.release(shard.capacity, shard.slot)
            staged.remove(shard)

        try:
            pts = np.concatenate([p for _, p, _ in snaps])
            ids = np.concatenate([i for _, _, i in snaps])
            while True:
                if hook is not None:
                    hook("build", snaps)
                faults.fire("merge.build", rung=snaps[0][0].rung)
                merged = self._make_shard(pts, ids)   # off the lock
                staged.append(merged)
                if hook is not None:
                    hook("swap", snaps)
                faults.fire("merge.swap", rung=snaps[0][0].rung)
                with self._mu:
                    sources = [s for s, _, _ in snaps]
                    if not all(any(s is t for t in self._shards) for s in sources):
                        # a source was compacted or flattened away: its points
                        # live elsewhere now
                        for s in sources:
                            if any(s is t for t in self._shards):
                                s.merging = False
                        _discard(merged)
                        self._merge_stats["aborted"] += 1
                        self._schedule_carries()
                        return
                    for src, _, snap_ids in snaps:
                        # rows of the snapshot deleted since (idempotent)
                        pos = np.searchsorted(src.ids[: src.n_rows], snap_ids)
                        dead = snap_ids[~src.live[: src.n_rows][pos]]
                        if dead.size:
                            self._tombstone_rows(merged, dead)
                    if merged.n_tomb <= self.tomb_limit or merged.n_live == 0:
                        # the swap: the only point where the forest mutates
                        for src in sources:
                            self._drop_shard(src)
                        if merged.n_live == 0:
                            _discard(merged)
                        else:
                            self._shards.append(merged)
                            staged.remove(merged)
                        self._merge_stats["completed"] += 1
                        self._retry_streak = 0
                        self._schedule_carries()
                        return
                    # deletes landed mid-merge: compact off the lock and retry
                    pts = merged.points[merged.live]
                    ids = merged.ids[merged.live]
                    _discard(merged)
        except BaseException as err:
            with self._mu:
                for s, _, _ in snaps:
                    if any(s is t for t in self._shards):
                        s.merging = False
                for sh in staged:
                    if not any(sh is t for t in self._shards):
                        self._placer.release(sh.capacity, sh.slot)
                self._merge_stats["failed"] += 1
                self._retry_streak += 1
                streak = self._retry_streak
            rung = snaps[0][0].rung
            if isinstance(err, Exception) and streak <= MERGE_MAX_RETRIES:
                delay = min(_MERGE_RETRY_BASE_S * (2 ** (streak - 1)), _MERGE_RETRY_CAP_S)
                with self._mu:
                    self._merge_stats["retried"] += 1
                self._merger.submit_after(delay, self._retry_carries, meta=rung)
                return
            raise MergeRetryExhausted(
                f"carry merge at rung {rung} failed {streak} consecutive time(s); "
                f"bounded backoff exhausted (MERGE_MAX_RETRIES={MERGE_MAX_RETRIES})",
                rung=rung,
            ) from err

    def _retry_carries(self) -> None:
        """Backoff retry: the collision is still visible, so scheduling again
        snapshots the sources afresh and resubmits the merge."""
        with self._mu:
            self._schedule_carries()

    # ------------------------------------------------------------------
    def insert(self, points: np.ndarray) -> np.ndarray:
        """Insert a batch; returns the assigned global ids (i64[b])."""
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2 or pts.shape[1] != self.d:
            raise ValueError(f"points must be [b, {self.d}], got {pts.shape}")
        b = pts.shape[0]
        with self._mu:
            ids = np.arange(self._next_id, self._next_id + b, dtype=np.int64)
            self._next_id += b
            if b == 0:
                return ids
            # rebuild-vs-merge: a batch at or above the crossover flattens the
            # forest; the planner's value was taken at build-time n and acts
            # as a floor as the index grows (the model's n / levels takes over)
            if self.rebuild_crossover is not None:
                levels = max(1, math.ceil(math.log2(
                    max(2.0, max(1, self._n_live) / self.base_capacity))))
                crossover = max(self.rebuild_crossover, self._n_live // levels)
            else:
                crossover = max(1, self._n_live)
            if self._shards and b >= crossover:
                all_pts = [s.points[s.live] for s in self._shards]
                all_ids = [s.ids[s.live] for s in self._shards]
                for s in list(self._shards):
                    self._drop_shard(s)   # in-flight merges abort at the swap
                self._shards.append(self._make_shard(
                    np.concatenate(all_pts + [pts]), np.concatenate(all_ids + [ids])))
            else:
                self._shards.append(self._make_shard(pts, ids))
            self._n_live += b
            self._schedule_carries()
            return ids

    # ------------------------------------------------------------------
    def _tombstone_rows(self, shard: _Shard, dead_ids: np.ndarray) -> None:
        """Clear the live bits of the ``dead_ids`` present and live in the
        shard (idempotent) and reclaim the rows (caller holds ``_mu``):
        brute shards get PAD_COORD in the host slab and, in place, in the
        device slab; tree shards through ``_reclaim_tree_rows``."""
        sid = shard.ids[: shard.n_rows]
        pos = np.searchsorted(sid, dead_ids)
        safe = np.clip(pos, 0, max(0, shard.n_rows - 1))
        hit = (pos < shard.n_rows) & (sid[safe] == dead_ids) & shard.live[safe]
        rows = safe[hit]
        if rows.size == 0:
            return
        shard.live[rows] = False
        shard.n_tomb += int(rows.size)
        if shard.engine is None:
            shard.points[rows] = np.float32(PAD_COORD)
            if shard._dev_slab is not None:
                shard._dev_slab[torch.from_numpy(rows).to(shard.device)] = float(PAD_COORD)
        else:
            self._reclaim_tree_rows(shard, rows)

    @staticmethod
    def _reclaim_tree_rows(shard: _Shard, rows: np.ndarray) -> None:
        """Kill tombstoned rows inside a tree shard's leaf structure: slab
        rows -> leaf-ordered positions -> (leaf, row), killed in the
        ``ChunkedLeafStore`` (fp32: PAD_COORD in place on the device; codes:
        the dead mask), and PAD_COORD into the leaf-ordered fp32 copies
        (``tree.points`` / ``points_padded``), which the exact re-rank, the
        certificate and the fp32 brute force read: no path can bring a
        deleted point back.  Idempotent."""
        tree = shard.engine.tree
        n = tree.points.shape[0]
        inv = np.empty((n,), np.int64)
        inv[tree.orig_idx] = np.arange(n)
        p = inv[rows]                                      # leaf-ordered positions
        leaf = np.searchsorted(tree.leaf_start, p, side="right").astype(np.int64) - 1
        lrow = p - tree.leaf_start[leaf]
        shard.engine.store.kill_rows(leaf, lrow)
        tree.points[p] = np.float32(PAD_COORD)
        tree.points_padded[leaf, lrow, :] = np.float32(PAD_COORD)

    def delete(self, ids) -> int:
        """Tombstone the given live ids; returns the count removed.  Raises
        ``KeyError`` if any id is unknown, already deleted or repeated
        within the request, and then removes nothing."""
        req = np.asarray(ids, np.int64).ravel()
        if req.size == 0:
            return 0
        if np.unique(req).size != req.size:
            raise KeyError("delete request contains duplicate ids")
        with self._mu:
            found = np.zeros(req.shape, bool)
            hits: List[Tuple[_Shard, np.ndarray]] = []
            for shard in self._shards:
                sid = shard.ids[: shard.n_rows]
                pos = np.searchsorted(sid, req)
                safe = np.clip(pos, 0, max(0, shard.n_rows - 1))
                hit = (pos < shard.n_rows) & (sid[safe] == req) & shard.live[safe]
                if hit.any():
                    hits.append((shard, req[hit]))
                    found |= hit
            if not found.all():
                raise KeyError(f"ids not live in index: {req[~found].tolist()}")
            for shard, dead in hits:
                self._tombstone_rows(shard, dead)
            self._n_live -= int(req.size)
            # compaction restores n_tomb <= tomb_limit; empty shards go (a
            # shard reserved by a merge likewise: the merge aborts at swap)
            for shard in list(self._sorted_shards()):
                if shard.n_live == 0:
                    self._drop_shard(shard)
                elif shard.n_tomb > self.tomb_limit:
                    pts = shard.points[shard.live]
                    sids = shard.ids[shard.live]
                    self._drop_shard(shard)
                    self._shards.append(self._make_shard(pts, sids))
            self._schedule_carries()
        return int(req.size)

    # ------------------------------------------------------------------
    def _brute_scan(self, shard: _Shard, qp_dev: torch.Tensor,
                    kq: int) -> Tuple[np.ndarray, np.ndarray]:
        """Tiled brute scan of one shard's device slab with ``knn_brute``'s
        tile step (direct (q - x)^2, a stable merge into the running
        top-k): (Euclidean dists f32[mp, kq], slab rows i64[mp, kq])."""
        slab = shard.dev_slab()
        nx = slab.shape[0]
        tx = min(shard.capacity, _BRUTE_TILE_X)
        mp = qp_dev.shape[0]
        tq = min(mp, _BRUTE_TILE_Q)   # both powers of two: tq divides mp
        _SCAN_SHAPES.add((tq, tx, self.d, kq, str(shard.device)))
        out_d = np.empty((mp, kq), np.float32)
        out_i = np.empty((mp, kq), np.int64)
        for qs in range(0, mp, tq):
            q = qp_dev[qs:qs + tq]
            best_d = torch.full((tq, kq), torch.inf, device=shard.device)
            best_i = torch.full((tq, kq), -1, dtype=torch.int64, device=shard.device)
            for xs in range(0, nx, tx):
                best_d, best_i = _tile_step(q, slab[xs:xs + tx], xs, best_d, best_i, kq)
            out_d[qs:qs + tq] = kops.sqrt(best_d.clamp_min(0.0)).cpu().numpy()
            out_i[qs:qs + tq] = best_i.cpu().numpy()
        return out_d, out_i

    def _shard_candidates(self, shard: _Shard, qp: np.ndarray, qp_dev, k: int, w: int,
                          sb: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One shard's nearest candidates (dists, global ids, keep), the
        list padded out to the uniform merge width ``w``."""
        mp = qp.shape[0]
        kq = shard.fetch_width(k)
        if shard.engine is not None:
            dd, rows = shard.engine.query(qp, k=kq)
            st = shard.engine.stats
            sb["points_scanned"] += st.points_scanned
            sb["units_scanned"] += st.units_scanned
            sb["flushes"] += st.flushes
            sb["refined_rows"] += st.refined_rows
            sb["exact_rows"] += st.exact_rows
            sb["iterations"] = max(sb["iterations"], st.iterations)
        else:
            dd, rows = self._brute_scan(shard, qp_dev, kq)
            sb["points_scanned"] += mp * shard.capacity
            sb["iterations"] = max(sb["iterations"], 1)
        rows = np.asarray(rows)
        valid = (rows >= 0) & (rows < shard.capacity)
        safe = np.clip(rows, 0, shard.capacity - 1)
        gids = shard.ids[safe]
        keep = valid & shard.live[safe] & (gids >= 0)
        dd = np.asarray(dd, np.float32)
        if kq < w:
            pad = ((0, 0), (0, w - kq))
            dd = np.pad(dd, pad, constant_values=np.inf)
            gids = np.pad(gids, pad, constant_values=-1)
            keep = np.pad(keep, pad, constant_values=False)
        return dd, gids, keep

    def query(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Exact kNN of the live multiset: (dists f32[m, k] ascending
        Euclidean, ids i64[m, k] global insertion ids, SearchStats).

        One thread per device slot scans that slot's shards in order; a
        ``faults.DeviceLost`` from a slot re-places its shards on the
        survivors and the fan-out runs again (bounded by the slot count);
        any other error propagates.  A pending merge never blocks: both
        sides of its swap hold the same live multiset."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries must be [m, {self.d}], got {q.shape}")
        if not 1 <= k <= self._n_live:
            raise ValueError(f"k={k} not in [1, n_live={self._n_live}]")
        m = q.shape[0]
        mp = _pad_batch(m)
        qp = np.zeros((mp, self.d), np.float32)
        qp[:m] = q
        w = k + self.tomb_limit

        for _attempt in range(len(self._devices) + 1):
            with self._mu:
                shards = self._sorted_shards()
            results: List = [None] * len(shards)
            by_slot: Dict[int, List[int]] = {}
            for i, s in enumerate(shards):
                by_slot.setdefault(s.slot, []).append(i)
            boards: List[dict] = []

            def group_thunk(slot, members, shards=shards, results=results, boards=boards):
                def run():
                    device = self._devices[slot]
                    faults.fire("device.scan", device=device, device_index=slot)
                    sb = dict(points_scanned=0, units_scanned=0, flushes=0, iterations=0,
                              refined_rows=0, exact_rows=0)
                    qp_dev = kops.owned_tensor(qp, device)
                    for i in members:
                        results[i] = self._shard_candidates(shards[i], qp, qp_dev, k, w, sb)
                    boards.append(sb)
                return run

            try:
                self._fanout.run({slot: group_thunk(slot, members)
                                  for slot, members in by_slot.items()})
                break
            except faults.DeviceLost as e:
                self.handle_device_loss(e.device_index)
        else:  # pragma: no cover - handle_device_loss raises first
            raise RuntimeError("query fan-out kept losing devices")

        lead = self._devices[self._placer.slots[0]]
        acc_d = acc_c = None
        gid_lists: List[np.ndarray] = []
        for i, (dd, gids, keep) in enumerate(results):
            gid_lists.append(gids)
            sd, sc = _filter_sort(kops.owned_tensor(dd, lead),
                                  torch.from_numpy(keep).to(lead), i * w)
            if acc_d is None:
                acc_d, acc_c = sd, sc
            else:
                acc_d, acc_c = _merge_pair(acc_d, acc_c, sd, sc, w=w)

        out_d = acc_d[:m, :k].cpu().numpy()
        codes = acc_c[:m, :k].cpu().numpy().astype(np.int64)
        gids_all = np.stack(gid_lists)                      # [S, mp, w]
        rows = np.arange(m)[:, None]
        out_i = gids_all[codes // w, rows, codes % w].astype(np.int64)
        out_i[~np.isfinite(out_d)] = -1
        with self._mu:
            events = tuple(self._events)
            self._events.clear()
        self._last_stats = SearchStats(
            iterations=max((sb["iterations"] for sb in boards), default=0),
            flushes=sum(sb["flushes"] for sb in boards),
            units_scanned=sum(sb["units_scanned"] for sb in boards),
            points_scanned=sum(sb["points_scanned"] for sb in boards),
            queries_advanced=m,
            refined_rows=sum(sb["refined_rows"] for sb in boards),
            exact_rows=sum(sb["exact_rows"] for sb in boards),
            events=events,
        )
        return out_d, out_i, self._last_stats

    # ------------------------------------------------------------------
    def warm(self, m: int, k: int) -> None:
        """Register the (batch, k) shape, so every later shard (background
        staging shards included) runs its scan at that shape when it is
        built, and run one query of zeros through the current forest (no-op
        while the index holds < k points)."""
        with self._mu:
            self._warm_shapes.add((_pad_batch(int(m)), int(k)))
        if 1 <= k <= self._n_live:
            self.query(np.zeros((m, self.d), np.float32), k)
