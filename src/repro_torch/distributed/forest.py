"""Forest kNN: one buffer k-d tree per device slot over its shard of the
reference set, and a merge of the shards' lists on the lead slot.

Counterpart of ``repro.distributed.forest``.  The reference set is split
into P equal contiguous shards; each slot holds a complete tree over its
shard (its top tree and leaf slabs, ``tree_arrays_from`` on the slot's
device) and answers every query against it with the device-resident fixed
point (``lazysearch.JitTree``: the ``jit`` engine's rounds, its own CUDA
graphs, ``FP32_OVERFETCH`` candidates rescored and certified, unproven rows
by brute force), so each shard's list is exact.  Ids are shifted by the
shard's offset.  The reference's all-gather of the [m, k] lists becomes a
copy of each slot's lists to the lead slot (from the host, where each
slot's certificate left them) and one selection over the [m, P k]
candidates, shard-major, so equal distances go to the lower shard, then to
the lower rank (``lax.top_k``'s order).

Device memory per slot is its shard's slabs, n / P (the paper's constraint,
removed by sharding instead of streaming); cross-shard pruning is given up
for no coordination, the same trade as the paper's query chunking (§3.2).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lazysearch import JitTree, SearchStats
from repro_torch.core.toptree import TopTree, build_top_tree, suggest_height
from repro_torch.distributed.dynamic_shards import DeviceFanout
from repro_torch.distributed.slots import on_slot, run_on_slots, slot_streams
from repro_torch.kernels.ref import smallest_k

__all__ = ["Forest", "build_forest", "stack_forest", "forest_knn"]


def build_forest(points: np.ndarray, n_shards: int,
                 height: Optional[int] = None) -> Tuple[List[TopTree], np.ndarray]:
    """Partition ``points`` into ``n_shards`` equal contiguous shards and
    build one tree per shard (height ``suggest_height(n / n_shards)`` unless
    given).  Returns (host trees, shard_offsets i64[n_shards]): each tree's
    ``orig_idx`` is local to its shard, and ``shard_offsets[s]`` turns it
    into the caller's ids."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} must divide into {n_shards} equal shards")
    per = n // n_shards
    h = height if height is not None else suggest_height(per)
    trees = [build_top_tree(points[s * per:(s + 1) * per], h) for s in range(n_shards)]
    return trees, np.arange(n_shards, dtype=np.int64) * per


@dataclasses.dataclass
class Forest:
    """The shards on their slots: shard ``s``'s ``JitTree`` (its tree arrays
    and ``RoundsCache`` on ``devices[s]``), the id offsets, a stream per
    slot and the fan-out pool.  ``slot_seconds`` holds each slot's seconds
    in the last query; ``lock`` serializes queries (the rounds' buffers are
    reused)."""

    shards: List[JitTree]
    offsets: np.ndarray
    devices: List[torch.device]
    streams: list
    fanout: DeviceFanout = dataclasses.field(default_factory=DeviceFanout)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    slot_seconds: Dict[int, float] = dataclasses.field(default_factory=dict)


def stack_forest(trees: Sequence[TopTree], offsets: np.ndarray, devices: Sequence,
                 *, tile_q: int = 128, backend: str = "auto") -> Forest:
    """Put shard ``s``'s tree on slot ``s`` (the port's counterpart of the
    reference's stacking for ``shard_map``: one ``TreeArrays`` per slot).
    All shards must share (height, leaf_pad, d), as ``build_forest``'s
    equal partition gives them."""
    devs = [torch.device(d) for d in devices]
    if len(devs) < len(trees):
        raise ValueError(f"need {len(trees)} device slots, have {len(devs)}")
    shapes = {(t.height, t.leaf_pad, t.d) for t in trees}
    if len(shapes) != 1:
        raise ValueError(f"shards differ in (height, leaf_pad, d): {sorted(shapes)}")
    devs = devs[:len(trees)]
    streams = slot_streams(devs)
    shards = []
    for s, tree in enumerate(trees):
        with on_slot(streams[s]):
            shards.append(JitTree(tree, devs[s], tile_q=tile_q, backend=backend))
    for st in streams:
        if st is not None:
            st.synchronize()
    return Forest(shards=shards, offsets=np.asarray(offsets, np.int64), devices=devs,
                  streams=streams)


def warm_forest(forest: Forest, m: int, k: int) -> None:
    """Run each slot's round once for a batch of ``m`` at ``k`` and capture
    it (on CUDA), so the first query only replays."""
    with forest.lock:
        run_on_slots(forest.fanout, forest.streams,
                     {s: (lambda sh=sh: sh.warm(m, k)) for s, sh in enumerate(forest.shards)})


def forest_knn(queries: np.ndarray, forest: Forest, *, k: int
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Sharded-forest kNN: every slot answers every query against its
    shard at once, then one selection merges the lists on the lead slot.
    Returns (dists f32[m, k] ascending Euclidean, ids i64[m, k], stats:
    the largest round count of a shard, ``exact_rows`` summed)."""
    queries = np.asarray(queries, np.float32)
    m = queries.shape[0]
    p = len(forest.shards)
    with forest.lock:
        lists: List = [None] * p

        def run(s: int) -> None:
            d, i, st = forest.shards[s].query(queries, k)
            lists[s] = (d, np.where(i >= 0, i + forest.offsets[s], -1), st)

        forest.slot_seconds = run_on_slots(forest.fanout, forest.streams,
                                           {s: (lambda s=s: run(s)) for s in range(p)})
        with on_slot(forest.streams[0]):
            lead = forest.devices[0]
            cd = torch.from_numpy(np.concatenate([l[0] for l in lists], axis=1)).to(lead)
            ci = torch.from_numpy(np.concatenate([l[1] for l in lists], axis=1)).to(lead)
            sd, sel = smallest_k(cd, k)
            dists = sd.cpu().numpy()
            idx = torch.gather(ci, 1, sel).cpu().numpy()
    stats = SearchStats(iterations=max(l[2].iterations for l in lists), queries_advanced=m,
                        exact_rows=sum(l[2].exact_rows for l in lists))
    return dists, idx, stats
