"""Device placement + background merge machinery for the mutable forest.

Counterpart of ``repro.distributed.dynamic_shards``.  Logarithmic-method
shards are immutable, so once built a rung's slabs can live on any device
and be queried there on their own; this module holds the pieces that place
them and run the forest's background work, apart from the forest logic
(``core/dynamic.py``) so the planner can consult them without it:

``ShardPlacer``
    Greedy least-loaded placement of shard rungs over a device list.  Tree
    rungs go to the slot with the least assigned capacity; brute rungs
    (small, short-lived under the carry chain) stay on the lead slot.
    Slots are keyed by their ORDINAL in the device list, never by device
    equality: ``torch.device("cuda:0")`` compares equal to every other
    ``cuda:0``, so ``devices=(cuda:0,) * 4`` gives four slots on one card
    (and ``(cpu,) * 4`` four on the CPU), the port's counterpart of the
    reference's ``--xla_force_host_platform_device_count=4``.
    ``preview_rung_placement`` is the same policy as a pure function, for
    ``Plan.reasons``.

``MergeWorker``
    One background thread running carry-chain merges off the query path,
    with the pending count ``drain`` waits on, and the typed
    ``MergeRetryExhausted`` / ``DrainTimeout``.

``DeviceFanout``
    A persistent thread pool running one task per slot group of a query
    fan-out; a ``faults.DeviceLost`` from any group wins over other errors
    so the forest can degrade, everything else propagates as it is.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import faults

__all__ = [
    "ShardPlacer",
    "MergeWorker",
    "DeviceFanout",
    "MergeRetryExhausted",
    "DrainTimeout",
    "preview_rung_placement",
]


class MergeRetryExhausted(RuntimeError):
    """A background carry merge kept failing through its bounded
    exponential-backoff retries (``core.dynamic.MERGE_MAX_RETRIES``).
    Raised by ``drain()``; ``rung`` identifies the wedged rung."""

    def __init__(self, msg: str, rung: Optional[int] = None):
        super().__init__(msg)
        self.rung = rung


class DrainTimeout(TimeoutError):
    """``drain(timeout=...)`` expired with merges still in flight.

    ``rungs`` lists the rungs of the stuck merges (``rung`` is the first);
    the worker keeps running: the timeout bounds the wait, it does not
    cancel the merge."""

    def __init__(self, msg: str, rungs: Tuple[int, ...] = ()):
        super().__init__(msg)
        self.rungs = tuple(rungs)
        self.rung = self.rungs[0] if self.rungs else None


def preview_rung_placement(
    n: int,
    *,
    base_capacity: int,
    brute_cutoff: int,
    n_devices: int,
    max_rungs: int = 48,
) -> List[Tuple[int, int]]:
    """Steady-state rung placement preview: [(capacity, slot)].

    Decomposes ``n`` binary-counter style over ``base_capacity`` (one shard
    per set bit of ``ceil(n / base_capacity)``) and assigns each rung as
    ``ShardPlacer`` does: tree rungs (capacity > ``brute_cutoff``)
    least-loaded over ``n_devices`` slots, brute rungs to slot 0."""
    units = max(1, -(-n // max(1, base_capacity)))
    caps = [base_capacity << r for r in range(min(max_rungs, units.bit_length()))
            if (units >> r) & 1]
    load = [0] * max(1, n_devices)
    out: List[Tuple[int, int]] = []
    for cap in sorted(caps, reverse=True):   # biggest first, as bin packing does
        if cap > brute_cutoff and n_devices > 1:
            slot = min(range(len(load)), key=load.__getitem__)
            load[slot] += cap
        else:
            slot = 0
        out.append((cap, slot))
    return out


class ShardPlacer:
    """Greedy least-loaded placement of forest shards over device slots.

    ``devices`` is the device list (None or empty: one slot, the default
    device); ``place`` returns a slot ORDINAL into it.  Thread-safe: the
    merge worker places staging shards while the foreground inserts.  Load
    is counted in shard capacity (rows)."""

    def __init__(self, devices: Optional[Sequence[Any]] = None):
        self._alive: List[int] = list(range(len(devices) if devices else 1))
        self._load: Dict[int, int] = {s: 0 for s in self._alive}
        self._mu = threading.Lock()

    @property
    def slots(self) -> List[int]:
        """Surviving slot ordinals, in order."""
        with self._mu:
            return list(self._alive)

    @property
    def n_devices(self) -> int:
        with self._mu:
            return len(self._alive)

    def place(self, capacity: int, kind: str) -> int:
        """Pick a slot for a new shard and charge its capacity."""
        with self._mu:
            if len(self._alive) == 1 or kind == "brute":
                slot = self._alive[0]
            else:
                slot = min(self._alive, key=self._load.__getitem__)
            self._load[slot] += capacity
            return slot

    def release(self, capacity: int, slot: int) -> None:
        """Return a dropped shard's capacity to its slot's budget."""
        with self._mu:
            if slot in self._load:
                self._load[slot] = max(0, self._load[slot] - capacity)

    def drop_device(self, slot: int) -> None:
        """Remove a lost slot from placement (device-loss degradation):
        later ``place`` calls only see the survivors; the caller re-places
        the slot's shards.  Raises ``RuntimeError`` for the last slot and
        ``KeyError`` for a slot not in the pool."""
        with self._mu:
            if slot not in self._alive:
                raise KeyError(f"slot {slot!r} not in placement pool")
            if len(self._alive) == 1:
                raise RuntimeError(
                    "cannot drop the last device: no surviving device to "
                    "re-place shards onto"
                )
            self._alive.remove(slot)
            del self._load[slot]


class MergeWorker:
    """Single background thread running carry merges off the query path."""

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="dyn-merge")
        self._mu = threading.Lock()
        self._idle = threading.Condition(self._mu)
        self._pending = 0
        self._metas: List[Any] = []     # one entry per outstanding task
        self._error: Optional[BaseException] = None

    @property
    def pending(self) -> int:
        with self._mu:
            return self._pending

    def _runner(self, fn: Callable[[], None], meta: Any) -> Callable[[], None]:
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - surfaced in drain()
                with self._mu:
                    self._error = e
            finally:
                with self._mu:
                    self._metas.remove(meta)
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.notify_all()

        return run

    def submit(self, fn: Callable[[], None], meta: Any = None) -> None:
        """Queue one merge.  ``fn`` may submit follow-up merges (the carry
        chain) before its pending count drops, so ``drain`` waits for the
        whole chain; ``meta`` (the merge's rung) is what ``DrainTimeout``
        reports while the task is outstanding."""
        with self._mu:
            self._pending += 1
            self._metas.append(meta)
        self._ex.submit(self._runner(fn, meta))

    def submit_after(self, delay: float, fn: Callable[[], None], meta: Any = None) -> None:
        """Queue one merge after ``delay`` seconds (the backoff of a retry).
        The pending count rises at once, so ``drain`` waits through the
        backoff instead of racing the timer."""
        with self._mu:
            self._pending += 1
            self._metas.append(meta)
        t = threading.Timer(delay, lambda: self._ex.submit(self._runner(fn, meta)))
        t.daemon = True
        t.start()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued merge (and its chain, retries included)
        has completed; re-raise the first background exception
        (``MergeRetryExhausted`` as itself, anything else wrapped).  A
        ``timeout`` raises ``DrainTimeout`` naming the stuck rungs."""
        with self._idle:
            if not self._idle.wait_for(lambda: self._pending == 0, timeout=timeout):
                rungs = tuple(sorted({m for m in self._metas if m is not None}))
                raise DrainTimeout(
                    f"{self._pending} background merge(s) still running after {timeout}s"
                    + (f" (stuck rung(s): {list(rungs)})" if rungs else ""),
                    rungs=rungs,
                )
            if self._error is not None:
                err, self._error = self._error, None
                if isinstance(err, MergeRetryExhausted):
                    raise err
                raise RuntimeError("background carry merge failed") from err


class DeviceFanout:
    """Persistent pool running one query task per slot group.

    ``run(groups)`` runs each thunk on its own thread (so each slot's work
    is issued while the others' runs) and returns when all have finished;
    one group runs inline.  It waits for every group before raising: a
    ``faults.DeviceLost`` wins, so the forest can re-place that slot's
    shards, anything else propagates as it is."""

    def __init__(self):
        self._ex: Optional[ThreadPoolExecutor] = None
        self._workers = 0

    def run(self, groups: Dict[Any, Callable[[], None]]) -> None:
        thunks = list(groups.values())
        if len(thunks) <= 1:
            for t in thunks:
                t()
            return
        if self._ex is None or self._workers < len(thunks):
            if self._ex is not None:
                self._ex.shutdown(wait=False)
            self._workers = len(thunks)
            self._ex = ThreadPoolExecutor(max_workers=self._workers,
                                          thread_name_prefix="dyn-fanout")
        futures = [self._ex.submit(t) for t in thunks]
        errors: list = []
        for f in futures:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 - collected, re-raised
                errors.append(e)
        if errors:
            for e in errors:
                if isinstance(e, faults.DeviceLost):
                    raise e
            raise errors[0]
