"""KNNServer: the online serving front door (admission queue, rung-shaped
micro-batching, SLA-aware batch close, overload and fault hardening).

Counterpart of ``repro.serving.knn_server``, over the port's indexes: the
``streaming`` engine (a ticket resolves the round its row retires) and the
mutable ``dynamic`` forest (``caps.batch_stream``: the whole batch at the
end).  The policy is the reference's, decision for decision, so the same
trace gives the same ``server.reasons``:

  * ADMISSION QUEUE: ``submit()`` returns a ``Ticket``; with ``max_queue``
    the queue is bounded and a full one sheds with the typed ``Overloaded``
    (queue depth and an estimated wait).
  * DEADLINE PURGING: a queued request past its deadline fails with
    ``DeadlineExceeded`` before it takes a batch slot, most late first
    (``purge_expired=False`` serves it late instead).
  * RUNG-SHAPED MICRO-BATCHING: the batch buckets are ``{max_batch} ∪
    compaction_ladder(max_batch)`` (``core/chunked_jit.py``), the shapes
    ``KNNIndex.warm(max_batch)`` runs, all warmed at construction.
  * SLA-AWARE BATCH CLOSE: a batch launches when the top bucket fills
    (``close=rung_full``) or when the oldest request's slack (deadline -
    now - estimated service time) runs out (``close=deadline``).  The
    estimate is seeded from ``calibration`` (duck-typed: any object with
    ``round_s`` and ``source``, e.g. seconds per round measured on the
    card) and EWMA-corrected by clean batches; faulted, retried or
    degraded batches never feed it, and a clean outlier is clamped.
  * CRASH ISOLATION: a poisoned batch fails only its own tickets;
    ``faults.FaultError`` retries the unresolved rows with capped backoff;
    a watchdog fails every pending ticket with ``SchedulerDied`` if the
    scheduler thread dies.
  * DEGRADED SERVING: a device slot lost mid-traffic (``faults.DeviceLost``
    in a multi-slot dynamic index) shrinks the fan-out to the survivors;
    the events reach ``Ticket.info["degraded"]`` and ``server.reasons``
    while answers stay exact.

Fault points ``serve.launch``, ``serve.stream`` and ``serve.stall``
(``repro_torch.faults``) are wired here.  Scheduling runs on a background
thread by default; ``start=False`` + ``pump_once()`` with an injected
``clock`` and ``sleep`` drive the same policy deterministically.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.api.engine import StreamingUnsupported, get_engine
from repro_torch.core.chunked_jit import compaction_ladder

__all__ = [
    "KNNServer",
    "Ticket",
    "ServingError",
    "Overloaded",
    "DeadlineExceeded",
    "SchedulerDied",
    "Cancelled",
    "DEFAULT_DEADLINE_MS",
]

DEFAULT_DEADLINE_MS = 50.0

# Service-time seed when no calibration is supplied: a conservative CPU-ish
# guess, immediately corrected by the first observed batch.
_DEFAULT_EST_SERVICE_S = 0.02

# Rounds a serving-sized batch typically runs — multiplies the calibration's
# measured per-round cost into a service-time seed.
_EST_ROUNDS_GUESS = 8

# EWMA weight of the newest observed batch service time.
_EST_ALPHA = 0.4

# A clean service-time sample may move the estimate by at most this factor:
# one GC pause / page-in storm must not inflate the SLA-close slack forever.
_EST_CLAMP = 8.0


class ServingError(RuntimeError):
    """Base class for typed serving-path errors."""


class Overloaded(ServingError):
    """``submit()`` rejected: the admission queue is at ``max_queue``.

    Carries ``queue_depth`` (live queued requests at rejection time) and
    ``est_wait_s`` (estimated time until the queue would drain enough to
    accept, from the current per-bucket service estimate) so callers can
    back off proportionally instead of hammering the front door.
    """

    def __init__(self, msg: str, *, queue_depth: int = 0,
                 est_wait_s: float = 0.0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s


class DeadlineExceeded(ServingError):
    """A queued request's SLA deadline passed before its batch launched.

    Purged requests never waste a batch slot; ``late_s`` is how far past
    the deadline the purge ran.
    """

    def __init__(self, msg: str, *, rid: int = -1, late_s: float = 0.0):
        super().__init__(msg)
        self.rid = rid
        self.late_s = late_s


class SchedulerDied(ServingError):
    """The scheduler thread died; every pending ticket was fail-fasted.

    Raised from ``Ticket.result()`` of the failed tickets and from any
    later ``submit()`` — the server must be recreated.
    """


class Cancelled(ServingError):
    """The request was cancelled via ``Ticket.cancel()``."""

    def __init__(self, msg: str, *, rid: int = -1):
        super().__init__(msg)
        self.rid = rid


class Ticket:
    """Handle for one submitted request (an event-backed future).

    Exactly one terminal transition ever wins: a result (``result()``
    returns), a typed error (``result()`` raises it, ``exception()``
    returns it) or a cancellation (``cancel()``; ``result()`` raises
    ``Cancelled``).  ``info`` carries serving metadata (batch id, bucket
    shape, close reason, queue wait and total latency in seconds, plus
    ``degraded`` events when the batch served through a device loss).
    """

    __slots__ = ("rid", "info", "_event", "_lock", "_dists", "_idx",
                 "_exc", "_state", "_server", "_pending")

    def __init__(self, rid: int, server: Optional["KNNServer"] = None):
        self.rid = rid
        self.info: dict = {}
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._dists: Optional[np.ndarray] = None
        self._idx: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None
        self._state = "pending"
        self._server = server
        self._pending = None

    def done(self) -> bool:
        """True once resolved (result, error, or cancellation)."""
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._state == "cancelled"

    def cancel(self) -> bool:
        """Cancel the request; True if this call won the resolution.

        A queued request is dropped before ever occupying a batch slot; a
        request already launched keeps computing but its result is
        discarded on arrival (the in-flight batch cannot be recalled).
        False when the ticket already resolved (served, failed, or
        cancelled earlier).
        """
        if self._server is None:
            return self._resolve_exc(
                Cancelled(f"request {self.rid} cancelled", rid=self.rid),
                "cancelled",
            )
        return self._server._cancel(self)

    def result(
        self, timeout: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(dists f32[k], idx i64[k]) — blocks until resolved.

        Raises the ticket's typed error (``DeadlineExceeded``,
        ``SchedulerDied``, the batch's exception, ...) or ``Cancelled``
        when the request did not complete normally; ``TimeoutError`` if
        nothing resolved it within ``timeout``.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not served within {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self._dists, self._idx

    def exception(
        self, timeout: Optional[float] = None
    ) -> Optional[BaseException]:
        """The resolving exception (``Cancelled`` for cancellations), or
        None for a normal result.  Blocks like ``result``; raises
        ``TimeoutError`` if unresolved within ``timeout``."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not resolved within {timeout}s"
            )
        return self._exc

    # first terminal transition wins; every later attempt is discarded
    def _resolve_result(self, dists: np.ndarray, idx: np.ndarray) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._dists = dists
            self._idx = idx
            self._state = "done"
            self._event.set()
            return True

    def _resolve_exc(self, exc: BaseException, state: str) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._exc = exc
            self._state = state
            self._event.set()
            return True


class _Pending:
    __slots__ = ("ticket", "query", "k", "arrival_s", "deadline_s", "taken")

    def __init__(self, ticket, query, k, arrival_s, deadline_s):
        self.ticket = ticket
        self.query = query
        self.k = k
        self.arrival_s = arrival_s
        self.deadline_s = deadline_s
        self.taken = False


class KNNServer:
    """Admission queue + rung-bucket micro-batching over a streaming index.

    ``index`` must stream — ``caps.streaming`` (per-row retirement) or
    ``caps.batch_stream`` (whole-batch delivery, e.g. the mutable
    ``dynamic`` forest); anything else raises the typed
    ``StreamingUnsupported``.  ``max_batch`` fixes the top bucket; the
    full bucket set is its compaction ladder, all precompiled at
    construction.  ``max_queue`` bounds admission (None = unbounded);
    ``purge_expired`` fails already-late queued requests instead of
    serving them; ``batch_retries``/``retry_backoff_s`` cap the transient-
    fault retry ladder.  ``clock`` and ``sleep`` are injectable for
    deterministic tests; ``start=False`` disables the scheduler thread
    (drive with ``pump_once``).
    """

    def __init__(
        self,
        index,
        *,
        k: Optional[int] = None,
        max_batch: int = 256,
        max_queue: Optional[int] = None,
        default_deadline_ms: float = DEFAULT_DEADLINE_MS,
        purge_expired: bool = True,
        batch_retries: int = 2,
        retry_backoff_s: float = 0.05,
        calibration=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        start: bool = True,
    ):
        caps = get_engine(index.engine_name).caps
        if not (caps.streaming or getattr(caps, "batch_stream", False)):
            raise StreamingUnsupported(
                f"KNNServer needs a streaming-capable engine, got "
                f"{index.engine_name!r} (caps.streaming=False, "
                "caps.batch_stream=False); build the index with "
                "IndexSpec(engine='streaming') or a mutable dynamic index"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if batch_retries < 0:
            raise ValueError(f"batch_retries must be >= 0, got {batch_retries}")
        self._index = index
        self.k = int(k) if k is not None else index.spec.k_hint
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue) if max_queue is not None else None
        self.default_deadline_s = float(default_deadline_ms) / 1e3
        self.purge_expired = bool(purge_expired)
        self.batch_retries = int(batch_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._clock = clock
        self._sleep = sleep
        # rungs double as batch buckets: the EXACT shape set warm() compiles
        self.buckets: Tuple[int, ...] = tuple(sorted(
            set(compaction_ladder(self.max_batch)) | {self.max_batch}
        ))
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._inflight: list = []
        self._reasons: collections.deque = collections.deque(maxlen=512)
        self._next_rid = 0
        self._queued_live = 0
        self._batches = 0
        self._by_close: dict = {}
        self._completed = 0
        self._outstanding = 0
        self._shed = 0
        self._purged = 0
        self._cancelled = 0
        self._failed = 0
        self._retries = 0
        self._degraded_batches = 0
        self._stop = False
        self._draining = False
        self._dead = False
        self._dead_exc: Optional[BaseException] = None

        # service-time estimate per bucket, seeded from a measured round
        # cost when the calibration has one, EWMA-updated from observed
        # batches either way
        if calibration is not None and getattr(calibration, "round_s", None):
            seed = float(calibration.round_s) * _EST_ROUNDS_GUESS
            src = f"calibrated round ~{calibration.round_s * 1e3:.2f}ms " \
                  f"x {_EST_ROUNDS_GUESS} rounds ({calibration.source})"
        else:
            seed = _DEFAULT_EST_SERVICE_S
            src = "uncalibrated default"
        self._est_s = {b: seed for b in self.buckets}
        self._reasons.append(
            f"serving buckets {list(self.buckets)} = compaction ladder of "
            f"m={self.max_batch}; service estimate seeded "
            f"{seed * 1e3:.2f}ms ({src})"
        )

        # the recompile-free guarantee: every bucket shape is compiled
        # before the first request.  A per-row streaming engine's warm(m)
        # covers m's whole compaction ladder; batch_stream engines (the
        # dynamic forest) warm one padded shape per call, so each bucket
        # is warmed explicitly.
        if caps.streaming:
            index.warm(self.max_batch, self.k)
        else:
            for b in self.buckets:
                index.warm(b, self.k)

        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="knn-server", daemon=True
            )
            self._thread.start()

    # -- client side ----------------------------------------------------
    def submit(
        self,
        query: np.ndarray,
        k: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ) -> Ticket:
        """Enqueue one query (f32[d]); returns its ``Ticket``.

        ``deadline_ms`` is the request's SLA budget from now (default: the
        server's); the batch-close policy guarantees the request's batch
        LAUNCHES no later than deadline minus the current service estimate,
        even if its rung never fills.  Raises the typed ``Overloaded``
        (back off and retry) when ``max_queue`` requests are already
        waiting, ``SchedulerDied`` if the scheduler is gone, and a plain
        ``RuntimeError`` after ``close()``.
        """
        q = np.asarray(query, np.float32).reshape(-1)
        if q.shape[0] != self._index.d:
            raise ValueError(
                f"query must have dim {self._index.d}, got {q.shape[0]}"
            )
        kk = int(k) if k is not None else self.k
        if kk > self.k:
            raise ValueError(
                f"per-request k={kk} exceeds the server's batch k={self.k}"
            )
        dl = (
            float(deadline_ms) / 1e3
            if deadline_ms is not None else self.default_deadline_s
        )
        with self._cv:
            if self._dead:
                raise SchedulerDied(
                    "KNNServer scheduler is dead "
                    f"({type(self._dead_exc).__name__}: {self._dead_exc}); "
                    "recreate the server"
                )
            if self._stop:
                raise RuntimeError("KNNServer is closed")
            if (self.max_queue is not None
                    and self._queued_live >= self.max_queue):
                depth = self._queued_live
                # batches needed to drain the backlog x the top bucket's
                # current service estimate = the soonest a retry could land
                est_wait = (
                    (depth // self.max_batch + 1)
                    * self._est_s[self.buckets[-1]]
                )
                self._shed += 1
                self._reasons.append(
                    f"shed: queue full ({depth}/{self.max_queue}); "
                    f"est_wait_ms={est_wait * 1e3:.2f}"
                )
                raise Overloaded(
                    f"admission queue full ({depth}/{self.max_queue} "
                    f"queued); estimated wait {est_wait * 1e3:.2f}ms — "
                    "back off and retry",
                    queue_depth=depth, est_wait_s=est_wait,
                )
            now = self._clock()
            t = Ticket(self._next_rid, server=self)
            self._next_rid += 1
            p = _Pending(t, q, kk, now, now + dl)
            t._pending = p
            self._queue.append(p)
            self._queued_live += 1
            self._outstanding += 1
            self._cv.notify_all()
        return t

    def submit_many(
        self,
        queries: np.ndarray,
        k: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ) -> List[Ticket]:
        """Enqueue each row of ``queries`` as its own request."""
        qs = np.asarray(queries, np.float32)
        if qs.ndim != 2:
            raise ValueError(f"queries must be [m, d], got {qs.shape}")
        return [self.submit(row, k=k, deadline_ms=deadline_ms) for row in qs]

    def _cancel(self, ticket: Ticket) -> bool:
        with self._cv:
            ok = ticket._resolve_exc(
                Cancelled(f"request {ticket.rid} cancelled by caller",
                          rid=ticket.rid),
                "cancelled",
            )
            if not ok:
                return False
            self._cancelled += 1
            self._outstanding -= 1
            p = ticket._pending
            if p is not None and p.taken:
                where = "mid-batch; in-flight result will be discarded"
            else:
                where = "before launch"
                if self._queued_live > 0:
                    self._queued_live -= 1
            self._reasons.append(f"cancel rid={ticket.rid}: {where}")
            self._cv.notify_all()
            return True

    # -- batching policy ------------------------------------------------
    def _bucket_for(self, size: int) -> int:
        for b in self.buckets:
            if size <= b:
                return b
        return self.max_batch

    def _close_decision_locked(
        self, now: float
    ) -> Tuple[Optional[str], str, Optional[float]]:
        """(close kind, detail, seconds until re-check) under ``_cv``.

        kind None = keep waiting (wait the returned slack); "rung_full" =
        the top bucket is full; "deadline" = the oldest request's slack
        (deadline - now - service estimate for the CURRENT bucket) ran out.
        """
        qlen = len(self._queue)
        if qlen == 0:
            return None, "", None
        if qlen >= self.max_batch:
            return "rung_full", f"queued={qlen}", None
        shape = self._bucket_for(qlen)
        est = self._est_s[shape]
        head = min(self._queue, key=lambda p: p.deadline_s)
        slack = head.deadline_s - now - est
        if slack <= 0.0:
            return "deadline", (
                f"rid={head.ticket.rid} slack_ms={slack * 1e3:.2f} "
                f"est_service_ms={est * 1e3:.2f}"
            ), None
        return None, "", slack

    def _policy_locked(self, force: bool):
        """One scheduler policy step under ``_cv``: prune cancellations,
        purge expired requests, then apply the close decision.  Returns
        ``((batch, reason, bid) | None, re-check slack | None)``."""
        faults.fire("serve.stall")
        now = self._clock()
        if self._queue:
            keep: collections.deque = collections.deque()
            expired: list = []
            for p in self._queue:
                if p.ticket.done():        # cancelled while queued
                    continue
                if self.purge_expired and now >= p.deadline_s:
                    expired.append(p)
                else:
                    keep.append(p)
            self._queue = keep
            self._queued_live = len(keep)
            # oldest-expired first: the most-late request is failed first
            for p in sorted(expired, key=lambda p: p.deadline_s):
                late = now - p.deadline_s
                exc = DeadlineExceeded(
                    f"request {p.ticket.rid} missed its deadline by "
                    f"{late * 1e3:.2f}ms before launch",
                    rid=p.ticket.rid, late_s=late,
                )
                if p.ticket._resolve_exc(exc, "error"):
                    p.ticket.info.update(purged=True, late_s=late)
                    self._purged += 1
                    self._outstanding -= 1
                    self._reasons.append(
                        f"purge rid={p.ticket.rid}: deadline exceeded "
                        f"{late * 1e3:.2f}ms before launch"
                    )
            if expired:
                self._cv.notify_all()
        if not self._queue:
            return None, None
        kind, detail, slack = self._close_decision_locked(now)
        if kind is None and force:
            kind, detail = "drain", ""
        if kind is None:
            return None, slack
        return self._take_locked(kind, detail), None

    def _take_locked(self, kind: str, detail: str):
        batch = []
        while self._queue and len(batch) < self.max_batch:
            p = self._queue.popleft()
            if p.ticket.done():
                continue
            p.taken = True
            batch.append(p)
        self._queued_live = len(self._queue)
        if not batch:
            return None
        bid = self._batches
        self._batches += 1
        self._by_close[kind] = self._by_close.get(kind, 0) + 1
        shape = self._bucket_for(len(batch))
        reason = (
            f"batch {bid}: close={kind} size={len(batch)}/{shape}"
            + (f" {detail}" if detail else "")
        )
        self._reasons.append(reason)
        return batch, reason, bid

    # -- serving side ---------------------------------------------------
    def _serve_batch(
        self, live: list, reason: str, bid: int, tainted: bool
    ) -> None:
        s = len(live)
        shape = self._bucket_for(s)
        faults.fire("serve.launch", batch=bid, size=s)
        qs = np.zeros((shape, self._index.d), np.float32)
        for r, p in enumerate(live):
            qs[r] = p.query
        t0 = self._clock()

        def on_complete(rows, dists, idx):
            faults.fire("serve.stream", batch=bid)
            tnow = self._clock()
            resolved = 0
            for j, row in enumerate(rows):
                row = int(row)
                if row >= s:        # zero-padding rows up to the bucket
                    continue
                p = live[row]
                p.ticket.info.update(
                    batch=bid, shape=shape, reason=reason,
                    wait_s=t0 - p.arrival_s,
                    latency_s=tnow - p.arrival_s,
                )
                if p.ticket._resolve_result(
                    dists[j, : p.k].copy(), idx[j, : p.k].copy()
                ):
                    resolved += 1
                # else: cancelled mid-batch — result discarded
            if resolved:
                with self._cv:
                    self._completed += resolved
                    self._outstanding -= resolved
                    self._cv.notify_all()

        res = self._index.query_stream(qs, self.k, on_complete=on_complete)
        dt = max(self._clock() - t0, 0.0)
        # device-loss degradation inside the index (fan-out shrunk to the
        # survivors, answers still exact) is surfaced per ticket and in
        # the server's reason log.  Tickets may already be resolved by the
        # stream above — ``info`` is enriched after the fact; readers
        # synchronize via result()/drain().
        events = tuple(getattr(res.stats, "events", ()) or ())
        if events:
            with self._cv:
                self._degraded_batches += 1
                for ev in events:
                    self._reasons.append(f"batch {bid}: degraded — {ev}")
            for p in live:
                p.ticket.info["degraded"] = list(events)
        self._observe_service_time(
            shape, dt, tainted=tainted or bool(events), bid=bid
        )

    def _observe_service_time(
        self, shape: int, dt: float, tainted: bool, bid: int
    ) -> None:
        """EWMA update, guarded against poisoning: faulted/retried/degraded
        batches measure the incident, not the service — skip them; clean
        outliers are clamped to ``_EST_CLAMP`` x the current estimate."""
        with self._cv:
            if tainted:
                self._reasons.append(
                    f"batch {bid}: service sample {dt * 1e3:.2f}ms SKIPPED "
                    "(faulted/degraded batch; estimate unchanged)"
                )
                return
            est = self._est_s[shape]
            sample = dt
            if est > 0.0 and sample > _EST_CLAMP * est:
                self._reasons.append(
                    f"batch {bid}: service sample {dt * 1e3:.2f}ms clamped "
                    f"to {_EST_CLAMP:g}x estimate ({est * 1e3:.2f}ms)"
                )
                sample = _EST_CLAMP * est
            self._est_s[shape] = (1 - _EST_ALPHA) * est + _EST_ALPHA * sample

    def _serve_batch_guarded(self, batch: list, reason: str, bid: int) -> None:
        """Serve ``batch`` with crash isolation: transient faults
        (``faults.FaultError``) retry the still-unresolved rows with capped
        exponential backoff; anything else — or retry exhaustion — resolves
        the remaining tickets with the error.  The scheduler loop survives
        either way."""
        try:
            attempt = 0
            while True:
                live = [p for p in batch if not p.ticket.done()]
                if not live:
                    break
                try:
                    self._serve_batch(live, reason, bid,
                                      tainted=attempt > 0)
                    break
                except Exception as e:
                    attempt += 1
                    transient = isinstance(e, faults.FaultError)
                    remaining = [
                        p for p in batch if not p.ticket.done()
                    ]
                    if (not transient or attempt > self.batch_retries
                            or not remaining):
                        self._fail_batch(remaining, e, bid, attempt)
                        break
                    backoff = min(
                        self.retry_backoff_s * (2 ** (attempt - 1)), 1.0
                    )
                    with self._cv:
                        self._retries += 1
                        self._reasons.append(
                            f"batch {bid}: attempt {attempt} failed "
                            f"({type(e).__name__}: {e}); retrying "
                            f"{len(remaining)} request(s) in "
                            f"{backoff * 1e3:.0f}ms"
                        )
                    self._sleep(backoff)
        finally:
            with self._cv:
                self._inflight = []
                self._cv.notify_all()

    def _fail_batch(
        self, remaining: list, exc: BaseException, bid: int, attempt: int
    ) -> None:
        n = 0
        with self._cv:
            for p in remaining:
                p.ticket.info.update(batch=bid, error=type(exc).__name__)
                if p.ticket._resolve_exc(exc, "error"):
                    n += 1
                    self._outstanding -= 1
            self._failed += n
            self._reasons.append(
                f"batch {bid}: FAILED after {attempt} attempt(s) "
                f"({type(exc).__name__}: {exc}); resolved {n} ticket(s) "
                "with the error"
            )
            self._cv.notify_all()

    def _scheduler_died(self, exc: BaseException) -> None:
        """Watchdog: the scheduler itself died (not just one batch) —
        fail-fast every pending ticket so no caller blocks forever."""
        with self._cv:
            if self._dead:
                return
            self._dead = True
            self._dead_exc = exc
            victims = [p for p in self._queue if not p.ticket.done()]
            victims += [p for p in self._inflight if not p.ticket.done()]
            self._queue.clear()
            self._queued_live = 0
            self._inflight = []
            died = SchedulerDied(
                f"scheduler died: {type(exc).__name__}: {exc}"
            )
            n = 0
            for p in victims:
                if p.ticket._resolve_exc(died, "error"):
                    n += 1
                    self._outstanding -= 1
                    self._failed += 1
            self._reasons.append(
                f"watchdog: scheduler died ({type(exc).__name__}: {exc}); "
                f"failed {n} pending ticket(s)"
            )
            self._cv.notify_all()

    def _loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while not (self._stop or self._draining or self._queue):
                        self._cv.wait()
                    if not self._queue:
                        if self._stop:
                            return
                        # draining, queue empty: in-flight work settles
                        self._cv.wait(timeout=0.01)
                        continue
                    taken, slack = self._policy_locked(
                        force=self._draining or self._stop
                    )
                    if taken is None:
                        if not self._queue:
                            continue
                        # sleep until the oldest request's slack would
                        # expire (capped so estimate drift re-evaluates
                        # promptly); submits notify and wake this
                        self._cv.wait(
                            timeout=min(slack, 0.05) if slack else 0.05
                        )
                        continue
                    batch, reason, bid = taken
                    self._inflight = batch
                self._serve_batch_guarded(batch, reason, bid)
        except BaseException as e:  # watchdog: never die silently
            self._scheduler_died(e)

    def pump_once(self, force: bool = False) -> int:
        """Manual scheduler step (tests / ``start=False`` servers): apply
        the purge + batch-close policy once and serve the batch it closes,
        if any.  Returns the number of requests taken into a batch (purged
        requests resolve but do not count).  ``force=True`` closes a
        non-empty queue regardless of policy (drain semantics)."""
        try:
            with self._cv:
                if self._dead:
                    raise SchedulerDied(
                        "KNNServer scheduler is dead "
                        f"({type(self._dead_exc).__name__}: "
                        f"{self._dead_exc}); recreate the server"
                    )
                taken, _slack = self._policy_locked(force=force)
                if taken is None:
                    return 0
                batch, reason, bid = taken
                self._inflight = batch
        except SchedulerDied:
            raise
        except BaseException as e:
            self._scheduler_died(e)
            raise
        self._serve_batch_guarded(batch, reason, bid)
        return len(batch)

    # -- lifecycle ------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every accepted request has RESOLVED (served, failed,
        purged, or cancelled).

        With a scheduler thread, pending batches are force-closed
        (``close=drain``); without one, pumps inline."""
        if self._thread is None or self._dead:
            while not self._dead and self.pump_once(force=True):
                pass
            return
        deadline = (time.monotonic() + timeout) if timeout else None
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._outstanding > 0 and not self._dead:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._draining = False
                        raise TimeoutError(
                            f"{self._outstanding} request(s) still pending "
                            f"after {timeout}s"
                        )
                self._cv.wait(timeout=remaining if remaining else 0.05)
            self._draining = False

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop the scheduler thread.  Idempotent."""
        if self._stop and self._thread is None:
            return
        self.drain(timeout)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "KNNServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection --------------------------------------------------
    @property
    def reasons(self) -> Tuple[str, ...]:
        """Recent scheduling decisions as testable strings (newest last;
        bounded window, same auditability contract as ``Plan.reasons``)."""
        with self._cv:
            return tuple(self._reasons)

    def stats(self) -> dict:
        with self._cv:
            return {
                "queued": self._queued_live,
                "outstanding": self._outstanding,
                "completed": self._completed,
                "batches": self._batches,
                "batches_by_close": dict(self._by_close),
                "shed": self._shed,
                "purged": self._purged,
                "cancelled": self._cancelled,
                "failed": self._failed,
                "retries": self._retries,
                "degraded_batches": self._degraded_batches,
                "dead": self._dead,
                "max_queue": self.max_queue,
                "buckets": list(self.buckets),
                "est_service_ms": {
                    b: round(self._est_s[b] * 1e3, 3) for b in self.buckets
                },
            }
