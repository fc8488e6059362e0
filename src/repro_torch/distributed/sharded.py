"""Paper-faithful multi-device querying (§3.2 "Multi-Many-Core Querying").

Counterpart of ``repro.distributed.sharded``.  "One can make use of
multiple many-core devices by splitting all queries into 'big' chunks
according to the devices that are available.  These chunks ... can be
processed independently from each other."

Each device slot gets its own ``BufferKDTree`` (sharing the first one's
host top tree, and its quantized codes, built once) and a contiguous query
chunk.  The slots run at once: one thread per slot on a persistent pool
(``DeviceFanout``) and, on CUDA, one stream per slot (``slots.py``), where
the reference issues each device's work from a ``ThreadPoolExecutor``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunked_jit import DEFAULT_STARVATION_DEADLINE
from repro_torch.core.lazysearch import BufferKDTree
from repro_torch.distributed.dynamic_shards import DeviceFanout
from repro_torch.distributed.slots import on_slot, run_on_slots, slot_streams
from repro_torch.kernels import ops as kops

__all__ = ["MultiDeviceTrees", "multi_device_query"]


class MultiDeviceTrees:
    """One ``BufferKDTree`` per device slot, built once, queried many times.

    The paper's multi-GPU deployment as persistent state (the ``sharded``
    engine of ``repro_torch.api``): the host top tree is shared, each slot
    holds its own leaf store, and every query batch is split into
    contiguous "big" chunks, one per slot.  ``devices`` is the slot list
    (default: every visible CUDA device); ``(cuda:0,) * 4`` gives four
    slots on one card, ``(cpu,) * 4`` four on the CPU.
    ``slot_seconds`` holds each active slot's seconds in the last query."""

    def __init__(
        self,
        points: np.ndarray,
        *,
        devices: Optional[List] = None,
        height: Optional[int] = None,
        n_chunks: int = 1,
        backend: str = "auto",
        tile_q: int = 128,
        buffer_size: Optional[int] = None,
        starvation_deadline: int = DEFAULT_STARVATION_DEADLINE,
        precision: str = "fp32",
    ):
        self.devices = [torch.device(d) for d in (devices or kops.visible_devices())]
        self.active: List[int] = []   # slots used by the last query
        self.slot_seconds: Dict[int, float] = {}
        # one batch at a time: the slots' engines and their chunk stores are
        # stateful during a query, so callers of one instance serialize
        self._lock = threading.Lock()
        self._streams = slot_streams(self.devices)
        self._fanout = DeviceFanout()
        kw = dict(n_chunks=n_chunks, backend=backend, tile_q=tile_q, buffer_size=buffer_size,
                  starvation_deadline=starvation_deadline, precision=precision)
        # each slot's arrays are made on its own stream, the stream its
        # queries run on
        with on_slot(self._streams[0]):
            first = BufferKDTree(points, height=height, device=self.devices[0], **kw)
        # replicas reuse the first engine's quantized codes (quantization is
        # deterministic, so this only skips the refit)
        codes = first.store.quantized_state() if first.store.quantized else None
        self.engines = [first]
        for s in range(1, len(self.devices)):
            with on_slot(self._streams[s]):
                self.engines.append(BufferKDTree(points, device=self.devices[s], tree=first.tree,
                                                 store_state=codes, **kw))
        for st in self._streams:
            if st is not None:
                st.synchronize()

    @property
    def tree(self):
        return self.engines[0].tree

    def resident_bytes(self) -> int:
        """Per-slot leaf-structure bytes (each slot holds one store)."""
        return self.engines[0].store.resident_bytes()

    def warm(self, m: int, k: int) -> None:
        """Run each slot's chunk round at the shape of its chunk of a batch
        of ``m`` (``BufferKDTree.warm``)."""
        with self._lock:
            bounds = self._bounds(m)
            run_on_slots(self._fanout, self._streams, {
                s: (lambda s=s: self.engines[s].warm(int(bounds[s + 1] - bounds[s]), k))
                for s in range(len(self.engines)) if bounds[s + 1] > bounds[s]})

    def _bounds(self, m: int) -> np.ndarray:
        # "big" contiguous chunks, one per slot (the paper's uniform split)
        p = len(self.engines)
        return np.ceil(np.arange(p + 1) * m / p).astype(np.int64)

    def query(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        d, i, _, _ = self.query_with_active(queries, k)
        return d, i

    def query_with_active(self, queries: np.ndarray, k: int):
        """Like ``query`` but also returns which slots received a chunk and
        their stats snapshots, taken under the lock (an idle slot's
        ``.stats`` is stale, and a later batch would overwrite it)."""
        with self._lock:
            m = queries.shape[0]
            bounds = self._bounds(m)
            out_d = np.empty((m, k), np.float32)
            out_i = np.empty((m, k), np.int64)
            active = [s for s in range(len(self.engines)) if bounds[s + 1] > bounds[s]]
            self.active = active

            def run(s: int) -> None:
                lo, hi = int(bounds[s]), int(bounds[s + 1])
                out_d[lo:hi], out_i[lo:hi] = self.engines[s].query(queries[lo:hi], k=k)

            self.slot_seconds = run_on_slots(self._fanout, self._streams,
                                             {s: (lambda s=s: run(s)) for s in active})
            stats = [self.engines[s].stats for s in active]
            return out_d, out_i, active, stats


def multi_device_query(
    points: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    devices: Optional[List] = None,
    height: Optional[int] = None,
    n_chunks: int = 1,
    backend: str = "auto",
    tile_q: int = 128,
    buffer_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot kNN with query chunks over ``devices`` (paper Fig. 4):
    (dists f32[m, k], ids i64[m, k]).  Builds the per-slot engines, queries
    once and discards them; hold a ``MultiDeviceTrees`` (or a
    ``KNNIndex``) to amortize the build."""
    mdt = MultiDeviceTrees(points, devices=devices, height=height, n_chunks=n_chunks,
                           backend=backend, tile_q=tile_q, buffer_size=buffer_size)
    return mdt.query(queries, k)
