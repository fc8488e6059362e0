"""repro_torch's ``KNNServer`` (``serving/knn_server.py``) vs the JAX
reference, on the CPU.

Mirrors ``tests/test_knn_server.py`` and ``tests/test_serving_faults.py``.
Where a test scripts a trace (``start=False``, ``pump_once()`` and a fake
clock) it drives BOTH packages' servers, each over a ``streaming`` index
of its own package built on the same points (or over the same stub), and
asserts equal ``server.reasons`` sequences, equal batch buckets and equal
answers: distances within rtol = atol = 1e-5, ids equal up to ties, each
against ``knn_brute`` within the reference test's 1e-4.  The threaded
tests, the chaos sweep (the no-hung-ticket invariant) and the degraded
drill (a device slot lost under a server fronting the mutable forest, on
four CPU slots in-process) run on the port.
"""

import os
import threading
import types

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.serving import knn_server as jax_server
from repro_torch import faults
from repro_torch.api import IndexSpec, KNNIndex, StreamingUnsupported, knn_brute
from repro_torch.serving import (
    Cancelled,
    DeadlineExceeded,
    KNNServer,
    Overloaded,
    SchedulerDied,
)

SEED = int(os.environ.get("REPRO_FAULT_SEED", "0"))
N, D, K = 4000, 8, 10
CPU = torch.device("cpu")
CPUS = (CPU,)
TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_faults():
    from repro import faults as jax_faults

    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def index(data):
    idx = KNNIndex.build(data, IndexSpec(engine="streaming", height=4, k_hint=K, devices=CPUS))
    return data, idx


@pytest.fixture(scope="module")
def both(data):
    """{package: (KNNServer class, streaming index)} on the same points."""
    ref = jax_api.KNNIndex.build(data, jax_api.IndexSpec(engine="streaming", height=4,
                                                         k_hint=K))
    port = KNNIndex.build(data, IndexSpec(engine="streaming", height=4, k_hint=K,
                                          devices=CPUS))
    return {"repro": (jax_server.KNNServer, ref), "repro_torch": (KNNServer, port)}


def _queries(m, seed=1):
    return np.random.default_rng(seed).normal(size=(m, D)).astype(np.float32)


def _same_answers(a, b, q, pts):
    """Two packages' (dists, idx) rows: equal up to ties, both exact."""
    (ad, ai), (bd, bi) = a, b
    np.testing.assert_allclose(bd, ad, **REF_TOL)
    off = ai != bi
    if off.any():
        np.testing.assert_allclose(bd[off], ad[off], **REF_TOL)
    exact, _ = knn_brute(q[None], pts, K, device=CPU)
    np.testing.assert_allclose(bd, exact[0], **TOL)


def _in_both(both, script):
    """Run ``script(server_cls, index)`` for each package; returns
    {package: what it returned}."""
    return {name: script(cls, idx) for name, (cls, idx) in both.items()}


def _results(tickets):
    return [t.result(timeout=0) for t in tickets]


class TestBatchClosePolicy:
    def test_rung_full_close(self, both, data):
        q = _queries(32)

        def script(cls, idx):
            srv = cls(idx, k=K, max_batch=32, clock=FakeClock(), start=False)
            tickets = srv.submit_many(q, deadline_ms=10_000.0)
            assert srv.pump_once() == 32
            out = (srv.reasons, srv.buckets, _results(tickets))
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"][:2] == got["repro_torch"][:2]
        assert " close=rung_full " in got["repro_torch"][0][-1]
        for r in range(32):
            _same_answers(got["repro"][2][r], got["repro_torch"][2][r], q[r], data)

    def test_deadline_forces_short_batch(self, both):
        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=32, clock=clock, start=False)
            t = srv.submit(_queries(1)[0], deadline_ms=30.0)
            served = [srv.pump_once()]
            clock.advance(0.005)
            served.append(srv.pump_once())
            clock.advance(0.006)
            served.append(srv.pump_once())
            assert t.done()
            out = (served, srv.reasons)
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        served, reasons = got["repro_torch"]
        assert served == [0, 0, 1]
        assert " close=deadline " in reasons[-1] and "size=1/32" in reasons[-1]
        assert "slack_ms=" in reasons[-1] and "est_service_ms=" in reasons[-1]

    def test_bucket_is_smallest_rung_that_fits(self, both):
        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=64, clock=clock, start=False)
            srv.submit_many(_queries(40), deadline_ms=1000.0)
            clock.advance(0.99)
            out = (srv.buckets, srv.pump_once(), srv.reasons, srv.stats()["batches_by_close"])
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        buckets, served, reasons, by_close = got["repro_torch"]
        assert buckets == (32, 64) and served == 40
        assert "size=40/64" in reasons[-1] and by_close == {"deadline": 1}

    def test_seeded_trace_replay_is_deterministic(self, both, data):
        rng = np.random.default_rng(42)
        arrivals = np.cumsum(rng.exponential(0.004, size=24))
        queries = _queries(24, seed=42)
        deadlines = rng.choice([25.0, 60.0], size=24)

        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=32, clock=clock, start=False)
            results, log, nxt = {}, [], 0
            for tick in np.arange(0.0, 0.25, 0.002):
                clock.t = float(tick)
                while nxt < 24 and arrivals[nxt] <= tick:
                    results[nxt] = srv.submit(queries[nxt], deadline_ms=float(deadlines[nxt]))
                    nxt += 1
                if srv.pump_once():
                    log.append(srv.reasons[-1])
            while srv.pump_once(force=True):
                log.append(srv.reasons[-1])
            out = (log, srv.reasons, {r: t.result(timeout=0) for r, t in results.items()})
            srv.close()
            return out

        got = _in_both(both, script)
        port = script(*both["repro_torch"])
        assert port[0] == got["repro_torch"][0] and len(port[0]) > 1   # deterministic
        assert got["repro"][:2] == got["repro_torch"][:2]
        for r in range(24):
            _same_answers(got["repro"][2][r], got["repro_torch"][2][r], queries[r], data)


class _StubIndex:
    """An index standing in for engine behaviour: a registered engine name
    (the caps gate passes in either package), an injectable
    ``query_stream``."""

    engine_name = "streaming"
    d = D
    spec = types.SimpleNamespace(k_hint=K)

    def __init__(self, behavior):
        self._behavior = behavior

    def warm(self, m, k):
        pass

    def query_stream(self, qs, k, *, on_complete):
        return self._behavior(qs, k, on_complete)


def _stub_serve_all(qs, k, emit):
    m = qs.shape[0]
    emit(np.arange(m), np.zeros((m, k), np.float32), np.zeros((m, k), np.int64))
    return types.SimpleNamespace(stats=types.SimpleNamespace(events=()))


STUB_SERVERS = {"repro": jax_server.KNNServer, "repro_torch": KNNServer}


class TestAdmissionControl:
    def test_queue_full_sheds_at_exact_max_queue(self, both):
        def script(cls, idx):
            srv = cls(idx, k=K, max_batch=32, max_queue=4, clock=FakeClock(), start=False)
            tickets = [srv.submit(q, deadline_ms=10_000.0) for q in _queries(4)]
            with pytest.raises(Exception) as ei:
                srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            assert type(ei.value).__name__ == "Overloaded"
            assert ei.value.queue_depth == 4 and ei.value.est_wait_s > 0.0
            shed_reason = srv.reasons[-1]
            assert srv.pump_once(force=True) == 4
            assert all(t.done() for t in tickets)
            t = srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            assert not t.done()
            out = (shed_reason, srv.reasons, srv.stats()["shed"])
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        assert got["repro_torch"][0] == "shed: queue full (4/4); est_wait_ms=20.00"
        with pytest.raises(Overloaded):
            srv = KNNServer(both["repro_torch"][1], k=K, max_batch=32, max_queue=1,
                            start=False)
            srv.submit(_queries(1)[0])
            srv.submit(_queries(1)[0])

    def test_purge_expired_oldest_first(self, both):
        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=32, clock=clock, start=False)
            ta = srv.submit(_queries(1)[0], deadline_ms=10.0)
            tb = srv.submit(_queries(1)[0], deadline_ms=5.0)
            tc = srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            clock.advance(0.02)
            srv.pump_once()
            excs = [(type(t.exception(timeout=0)).__name__, t.exception(timeout=0).rid,
                     round(t.exception(timeout=0).late_s, 9)) for t in (ta, tb)]
            assert not tc.done()
            stats = (srv.stats()["purged"], srv.stats()["outstanding"])
            srv.drain()
            assert tc.done() and tc.exception(timeout=0) is None
            out = (excs, stats, srv.reasons)
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        excs, stats, reasons = got["repro_torch"]
        assert [r for r in reasons if r.startswith("purge ")] == [
            "purge rid=1: deadline exceeded 15.00ms before launch",
            "purge rid=0: deadline exceeded 10.00ms before launch",
        ]
        assert excs == [("DeadlineExceeded", 0, 0.01), ("DeadlineExceeded", 1, 0.015)]
        assert stats == (2, 1)
        srv = KNNServer(both["repro_torch"][1], k=K, max_batch=32, clock=FakeClock(),
                        start=False)
        t = srv.submit(_queries(1)[0], deadline_ms=1.0)
        srv._clock.advance(0.01)
        srv.pump_once()
        with pytest.raises(DeadlineExceeded):
            t.result(timeout=0)
        srv.close()

    def test_purge_can_be_disabled(self, both):
        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=32, clock=clock, start=False, purge_expired=False)
            t = srv.submit(_queries(1)[0], deadline_ms=1.0)
            clock.advance(5.0)
            served = srv.pump_once()
            d, _ = t.result(timeout=0)
            out = (served, d.shape, srv.stats()["purged"], srv.reasons)
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        assert got["repro_torch"][:3] == (1, (K,), 0)

    def test_trace_replay_pins_reason_strings(self, both):
        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=32, max_queue=2, clock=clock, start=False)
            srv.submit(_queries(1)[0], deadline_ms=10.0)
            srv.submit(_queries(1)[0], deadline_ms=5.0)
            with pytest.raises(Exception, match="queue full"):
                srv.submit(_queries(1)[0], deadline_ms=5.0)
            clock.advance(0.02)
            assert srv.pump_once() == 0
            srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            t3 = srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            assert t3.cancel()
            assert srv.pump_once(force=True) == 1
            reasons = srv.reasons
            srv.close()
            return reasons

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        assert list(got["repro_torch"][-5:]) == [
            "shed: queue full (2/2); est_wait_ms=20.00",
            "purge rid=1: deadline exceeded 15.00ms before launch",
            "purge rid=0: deadline exceeded 10.00ms before launch",
            "cancel rid=3: before launch",
            "batch 0: close=drain size=1/32",
        ]


class TestTicketLifecycle:
    def test_cancel_before_launch(self, both):
        def script(cls, idx):
            srv = cls(idx, k=K, max_batch=32, clock=FakeClock(), start=False)
            t0 = srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            t1 = srv.submit(_queries(1)[0], deadline_ms=10_000.0)
            assert t0.cancel() is True and t0.cancel() is False
            assert t0.cancelled() and t0.done()
            assert type(t0.exception(timeout=0)).__name__ == "Cancelled"
            assert srv.pump_once(force=True) == 1
            assert t1.done() and t1.exception(timeout=0) is None
            st = srv.stats()
            out = ((st["cancelled"], st["completed"], st["outstanding"]), srv.reasons)
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        assert got["repro_torch"][0] == (1, 1, 0)
        assert "cancel rid=0: before launch" in got["repro_torch"][1]
        srv = KNNServer(both["repro_torch"][1], k=K, max_batch=32, start=False)
        t = srv.submit(_queries(1)[0])
        t.cancel()
        with pytest.raises(Cancelled):
            t.result(timeout=0)
        srv.close()

    def test_cancel_mid_batch_discards_result(self):
        def script(cls):
            holder = {}

            def behavior(qs, k, emit):
                holder["t0"].cancel()
                return _stub_serve_all(qs, k, emit)

            srv = cls(_StubIndex(behavior), k=K, max_batch=32, clock=FakeClock(), start=False)
            holder["t0"] = srv.submit(np.zeros(D), deadline_ms=10_000.0)
            t1 = srv.submit(np.ones(D), deadline_ms=10_000.0)
            assert srv.pump_once(force=True) == 2
            assert holder["t0"].cancelled() and t1.exception(timeout=0) is None
            st = srv.stats()
            out = ((st["cancelled"], st["completed"], st["outstanding"]), srv.reasons)
            srv.close()
            return out

        got = {name: script(cls) for name, cls in STUB_SERVERS.items()}
        assert got["repro"] == got["repro_torch"]
        assert got["repro_torch"][0] == (1, 1, 0)
        assert ("cancel rid=0: mid-batch; in-flight result will be discarded"
                in got["repro_torch"][1])

    def test_exception_returns_none_for_success(self, index):
        _, idx = index
        srv = KNNServer(idx, k=K, max_batch=32, clock=FakeClock(), start=False)
        t = srv.submit(_queries(1)[0], deadline_ms=10_000.0)
        with pytest.raises(TimeoutError):
            t.exception(timeout=0)
        srv.pump_once(force=True)
        assert t.exception(timeout=0) is None
        srv.close()


class TestThreadedServer:
    def test_out_of_order_completion_parity(self, index):
        pts, idx = index
        q = _queries(100, seed=9)
        with KNNServer(idx, k=K, max_batch=32, default_deadline_ms=20.0,
                       purge_expired=False) as srv:
            pairs = [t.result(timeout=60.0) for t in srv.submit_many(q)]
            stats = srv.stats()
        bd, bi = knn_brute(q, pts, K, device=CPU)
        np.testing.assert_allclose(np.stack([p[0] for p in pairs]), bd, **TOL)
        assert (np.stack([p[1] for p in pairs]) == bi).mean() > 0.99
        assert stats["completed"] == 100 and stats["outstanding"] == 0
        assert stats["batches"] >= 4

    def test_single_request_never_starves(self, index):
        _, idx = index
        # a deadline far above a loaded CPU's scheduling delay: the request
        # must be served by the slack close, not purged
        with KNNServer(idx, k=K, max_batch=256, default_deadline_ms=1000.0) as srv:
            t = srv.submit(_queries(1, seed=13)[0])
            d, i = t.result(timeout=30.0)
        assert d.shape == (K,) and i.shape == (K,)
        assert t.info["shape"] == 32 and " close=" in t.info["reason"]

    def test_ticket_info_records_serving_metadata(self, index):
        _, idx = index
        with KNNServer(idx, k=K, max_batch=32, default_deadline_ms=1000.0) as srv:
            t = srv.submit(_queries(1, seed=17)[0])
            t.result(timeout=30.0)
        assert t.info["latency_s"] >= t.info["wait_s"] >= 0.0
        assert t.info["batch"] == 0


class TestValidationAndLifecycle:
    def test_non_streaming_index_rejected(self, index):
        pts, _ = index
        chunked = KNNIndex.build(pts, IndexSpec(engine="chunked", height=4, k_hint=K,
                                                devices=CPUS))
        with pytest.raises(StreamingUnsupported, match="streaming"):
            KNNServer(chunked, k=K)

    def test_submit_validation(self, index):
        _, idx = index
        srv = KNNServer(idx, k=K, max_batch=32, start=False)
        with pytest.raises(ValueError, match="dim"):
            srv.submit(np.zeros(D + 1, np.float32))
        with pytest.raises(ValueError, match="exceeds"):
            srv.submit(np.zeros(D, np.float32), k=K + 1)
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(np.zeros(D, np.float32))

    def test_drain_serves_everything_queued(self, index):
        _, idx = index
        srv = KNNServer(idx, k=K, max_batch=32, clock=FakeClock(), start=False)
        tickets = srv.submit_many(_queries(5, seed=23), deadline_ms=10_000.0)
        srv.drain()
        assert all(t.done() for t in tickets)
        assert " close=drain " in srv.reasons[-1]
        srv.close()

    def test_estimate_seeded_from_calibration(self, both):
        class Cal:
            round_s = 0.004
            source = "seconds per round measured on the card"

        def script(cls, idx):
            srv = cls(idx, k=K, max_batch=32, calibration=Cal(), start=False)
            out = (srv.stats()["est_service_ms"], srv.reasons)
            srv.close()
            return out

        got = _in_both(both, script)
        assert got["repro"] == got["repro_torch"]
        assert got["repro_torch"][0][32] == pytest.approx(32.0)
        assert any("measured on the card" in r for r in got["repro_torch"][1])


class TestMutableIndexServing:
    """The server fronting the mutable forest (``caps.batch_stream``): the
    same trace through both packages' servers, each over its own dynamic
    index holding the same points, gives the same reasons and answers."""

    def test_dynamic_index_trace_matches_reference(self, data):
        rng = np.random.default_rng(5)
        extra = rng.normal(size=(300, D)).astype(np.float32)
        q = _queries(40, seed=31)
        ref = jax_api.KNNIndex.build(data[:3000], jax_api.IndexSpec(
            mutable=True, buffer_size=256, k_hint=K, merge_async=False))
        port = KNNIndex.build(data[:3000], IndexSpec(mutable=True, buffer_size=256, k_hint=K,
                                                     merge_async=False, devices=CPUS))
        for idx in (ref, port):
            idx.insert(extra)
            idx.delete(np.arange(0, 3000, 7))
        assert ref._state.shard_layout() == port._state.shard_layout()
        live = np.concatenate([np.delete(data[:3000], np.arange(0, 3000, 7), 0), extra])

        def script(cls, idx):
            clock = FakeClock()
            srv = cls(idx, k=K, max_batch=32, clock=clock, start=False)
            tickets = srv.submit_many(q[:32], deadline_ms=10_000.0)
            assert srv.pump_once() == 32
            more = srv.submit_many(q[32:], deadline_ms=40.0)
            clock.advance(0.03)   # past the slack, before the deadline
            assert srv.pump_once() == 8
            out = (srv.reasons, srv.buckets, _results(tickets + more))
            srv.close()
            return out

        got = {name: script(cls, idx) for name, cls, idx in (
            ("repro", jax_server.KNNServer, ref), ("repro_torch", KNNServer, port))}
        assert got["repro"][:2] == got["repro_torch"][:2]
        for r in range(40):
            _same_answers(got["repro"][2][r], got["repro_torch"][2][r], q[r], live)
        # the port's answers are its index's query
        dd, di = port.query(q, K)
        np.testing.assert_array_equal(np.stack([a[0] for a in got["repro_torch"][2]]), dd)
        np.testing.assert_array_equal(np.stack([a[1] for a in got["repro_torch"][2]]), di)


# ---------------------------------------------------------------------------
# tests/test_serving_faults.py
# ---------------------------------------------------------------------------
def _policy_server(idx, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("start", False)
    kw.setdefault("retry_backoff_s", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return KNNServer(idx, k=K, max_batch=32, **kw)


class TestCrashIsolation:
    def test_transient_launch_fault_retries_and_serves(self, index):
        pts, idx = index
        srv = _policy_server(idx)
        q = _queries(4, seed=3)
        tickets = srv.submit_many(q, deadline_ms=10_000.0)
        faults.arm("serve.launch", after=1)
        assert srv.pump_once(force=True) == 4
        bd, _ = knn_brute(q, pts, K, device=CPU)
        for r, t in enumerate(tickets):
            np.testing.assert_allclose(t.result(timeout=0)[0], bd[r], **TOL)
        stats = srv.stats()
        assert stats["retries"] == 1 and stats["failed"] == 0
        assert any("attempt 1 failed" in r and "retrying 4 request(s)" in r
                   for r in srv.reasons)
        srv.close()

    def test_sticky_launch_fault_fails_batch_not_server(self, index):
        _, idx = index
        srv = _policy_server(idx)
        tickets = srv.submit_many(_queries(3, seed=4), deadline_ms=10_000.0)
        faults.arm("serve.launch", sticky=True)
        assert srv.pump_once(force=True) == 3
        for t in tickets:
            assert isinstance(t.exception(timeout=0), faults.FaultError)
            assert t.info["error"] == "FaultError"
        stats = srv.stats()
        assert stats["failed"] == 3 and stats["outstanding"] == 0
        assert stats["retries"] == srv.batch_retries
        assert any("FAILED after 3 attempt(s)" in r for r in srv.reasons)
        faults.reset()
        t = srv.submit(_queries(1, seed=5)[0], deadline_ms=10_000.0)
        assert srv.pump_once(force=True) == 1
        assert t.exception(timeout=0) is None
        srv.close()

    def test_mid_stream_fault_retries_unresolved_rows(self, index):
        pts, idx = index
        srv = _policy_server(idx)
        q = _queries(8, seed=6)
        tickets = srv.submit_many(q, deadline_ms=10_000.0)
        faults.arm("serve.stream", after=1)
        assert srv.pump_once(force=True) == 8
        bd, _ = knn_brute(q, pts, K, device=CPU)
        for r, t in enumerate(tickets):
            np.testing.assert_allclose(t.result(timeout=0)[0], bd[r], **TOL)
        assert srv.stats()["retries"] >= 1
        srv.close()

    def test_partial_delivery_retries_only_remainder(self):
        tickets, done_at_entry = [], []

        def behavior(qs, k, emit):
            done_at_entry.append([t.done() for t in tickets])
            emit(np.arange(4), np.full((4, k), 1.0, np.float32), np.zeros((4, k), np.int64))
            m = qs.shape[0]
            emit(np.arange(4, m), np.full((m - 4, k), 2.0, np.float32),
                 np.zeros((m - 4, k), np.int64))
            return types.SimpleNamespace(stats=types.SimpleNamespace(events=()))

        srv = _policy_server(_StubIndex(behavior))
        tickets.extend(srv.submit(np.zeros(D), deadline_ms=10_000.0) for _ in range(8))
        faults.arm("serve.stream", after=2)
        assert srv.pump_once(force=True) == 8
        assert all(t.done() and t.exception(timeout=0) is None for t in tickets)
        assert done_at_entry[0] == [False] * 8
        assert done_at_entry[1] == [True] * 4 + [False] * 4
        assert all(float(t.result(timeout=0)[0][0]) == 1.0 for t in tickets[4:])
        stats = srv.stats()
        assert stats["completed"] == 8 and stats["retries"] == 1
        srv.close()

    def test_raising_engine_resolves_tickets_not_hangs(self):
        broken = {"on": True}

        def behavior(qs, k, emit):
            if broken["on"]:
                raise ValueError("engine exploded")
            return _stub_serve_all(qs, k, emit)

        with KNNServer(_StubIndex(behavior), k=K, max_batch=32, default_deadline_ms=30.0,
                       retry_backoff_s=0.001) as srv:
            exc = srv.submit(np.zeros(D)).exception(timeout=30.0)
            assert isinstance(exc, ValueError) and srv.stats()["retries"] == 0
            broken["on"] = False
            assert srv.submit(np.ones(D)).exception(timeout=30.0) is None
            stats = srv.stats()
            assert stats["failed"] == 1 and stats["completed"] == 1 and not stats["dead"]

    def test_scheduler_stall_watchdog_fail_fasts(self, index):
        _, idx = index
        srv = _policy_server(idx)
        tickets = srv.submit_many(_queries(3, seed=7), deadline_ms=10_000.0)
        faults.arm("serve.stall")
        with pytest.raises(faults.FaultError):
            srv.pump_once(force=True)
        for t in tickets:
            assert isinstance(t.exception(timeout=0), SchedulerDied)
        stats = srv.stats()
        assert stats["dead"] and stats["outstanding"] == 0
        assert any(r.startswith("watchdog: scheduler died") for r in srv.reasons)
        with pytest.raises(SchedulerDied):
            srv.submit(_queries(1)[0])
        with pytest.raises(SchedulerDied):
            srv.pump_once()
        srv.close()

    def test_scheduler_stall_threaded_watchdog(self, index):
        _, idx = index
        faults.arm("serve.stall", sticky=True)
        with KNNServer(idx, k=K, max_batch=32, default_deadline_ms=30.0) as srv:
            exc = srv.submit(_queries(1, seed=8)[0]).exception(timeout=30.0)
            assert isinstance(exc, SchedulerDied) and srv.stats()["dead"]
            with pytest.raises(SchedulerDied):
                srv.submit(_queries(1)[0])


class TestEstimatorGuards:
    def test_faulted_batch_never_feeds_estimate(self):
        def script(cls, arm):
            clock = FakeClock()
            calls = {"n": 0}

            def behavior(qs, k, emit):
                calls["n"] += 1
                clock.advance(10.0)
                if calls["n"] == 1:
                    raise arm("transient blip")
                return _stub_serve_all(qs, k, emit)

            srv = cls(_StubIndex(behavior), k=K, max_batch=32, clock=clock, start=False,
                      retry_backoff_s=0.0, sleep=lambda s: None)
            srv.submit(np.zeros(D), deadline_ms=1e9)
            assert srv.pump_once(force=True) == 1
            out = (srv.stats()["est_service_ms"], srv.reasons)
            srv.close()
            return out

        from repro import faults as jax_faults

        ref = script(jax_server.KNNServer, jax_faults.FaultError)
        port = script(KNNServer, faults.FaultError)
        assert port == ref
        assert port[0][32] == pytest.approx(20.0)
        assert any("SKIPPED" in r for r in port[1])

    def test_clean_outlier_sample_is_clamped(self):
        def script(cls):
            clock = FakeClock()

            def behavior(qs, k, emit):
                clock.advance(10.0)
                return _stub_serve_all(qs, k, emit)

            srv = cls(_StubIndex(behavior), k=K, max_batch=32, clock=clock, start=False)
            srv.submit(np.zeros(D), deadline_ms=1e9)
            assert srv.pump_once(force=True) == 1
            out = (srv.stats()["est_service_ms"], srv.reasons)
            srv.close()
            return out

        got = {name: script(cls) for name, cls in STUB_SERVERS.items()}
        assert got["repro"] == got["repro_torch"]
        assert got["repro_torch"][0][32] == pytest.approx(76.0)
        assert any("clamped" in r for r in got["repro_torch"][1])

    def test_aborted_stream_leaves_index_usable(self, index):
        pts, idx = index
        q = _queries(8, seed=9)

        def bad_emit(rows, dists, ix):
            raise RuntimeError("consumer exploded")

        with pytest.raises(RuntimeError, match="consumer exploded"):
            idx.query_stream(q, K, on_complete=bad_emit)
        d, _ = idx.query(q, k=K)
        bd, _ = knn_brute(q, pts, K, device=CPU)
        np.testing.assert_allclose(d, bd, **TOL)


class TestServeChaosSweep:
    """Every serve.* point armed in turn under live threaded traffic, with
    shedding and cancellation mixed in: every ticket resolves."""

    @pytest.mark.parametrize("sticky", [False, True])
    @pytest.mark.parametrize("point", ["serve.launch", "serve.stream", "serve.stall"])
    def test_no_ticket_ever_hangs(self, index, point, sticky):
        _, idx = index
        case = faults.INJECTION_POINTS.index(point) * 2 + int(sticky)
        rng = np.random.default_rng([SEED, case])
        nreq = 40
        queries = rng.normal(size=(nreq, D)).astype(np.float32)
        faults.arm(point, after=int(rng.integers(1, 6)), sticky=sticky)
        srv = KNNServer(idx, k=K, max_batch=32, max_queue=16,
                        default_deadline_ms=float(rng.choice([15.0, 60.0])),
                        retry_backoff_s=0.001)
        submitted, shed = [], 0
        for i in range(nreq):
            try:
                t = srv.submit(queries[i])
            except Overloaded:
                shed += 1
                continue
            except SchedulerDied:
                break
            submitted.append(t)
            if rng.random() < 0.1:
                t.cancel()
        for t in submitted:
            t.exception(timeout=60.0)   # a TimeoutError here is a hung ticket
        assert all(t.done() for t in submitted)
        stats = srv.stats()
        assert stats["outstanding"] == 0
        assert (stats["completed"] + stats["failed"] + stats["purged"]
                + stats["cancelled"]) == len(submitted)
        assert shed + len(submitted) <= nreq
        srv.close()


def degraded_serving_drill(devices, *, threaded: bool, timeout: float = 120.0) -> dict:
    """``tests/test_serving_faults.py``'s degraded-serving script on the
    port: a mutable index over four device slots, a ``KNNServer`` in
    front, ``device.scan`` armed sticky on a shard-bearing slot; every
    ticket resolves exactly, the event reaches ``Ticket.info`` and
    ``server.reasons``, and the shrunken fan-out keeps serving.  Returns
    the server's stats and the victim slot."""
    rng = np.random.default_rng(0)
    d, k = 5, 5
    pts = rng.normal(size=(12288, d)).astype(np.float32)
    idx = KNNIndex.build(pts[:8192], IndexSpec(mutable=True, buffer_size=1024, k_hint=k,
                                               devices=tuple(devices)))
    for lo in range(8192, 12288, 1024):
        idx.insert(pts[lo:lo + 1024])
    idx.drain(timeout=timeout)
    st = idx._state
    slots = {s.slot for s in st._shards}
    assert len(slots) >= 2, "forest never spread over slots"
    victim = max(slots)
    srv = KNNServer(idx, k=k, max_batch=32,
                    default_deadline_ms=5_000.0 if threaded else 10_000.0, start=threaded)
    q = rng.normal(size=(16, d)).astype(np.float32)
    t0 = srv.submit(q[0])
    if not threaded:
        srv.pump_once(force=True)
    t0.result(timeout=timeout)
    faults.arm("device.scan", device_index=victim, sticky=True)
    tickets = [srv.submit(row) for row in q]
    if not threaded:
        srv.pump_once(force=True)
    srv.drain(timeout=timeout)
    faults.reset()
    bd, _ = knn_brute(q, pts, k, device=devices[0])
    for r, t in enumerate(tickets):
        dd, _ = t.result(timeout=0.1)
        np.testing.assert_allclose(dd, bd[r], **TOL)
        ev = t.info.get("degraded")
        assert ev and any("device loss" in e for e in ev), t.info
    assert any("degraded" in r and "device loss" in r for r in srv.reasons)
    assert srv.stats()["degraded_batches"] >= 1
    assert not any(s.slot == victim for s in st._shards)
    t2 = srv.submit(q[0])
    if not threaded:
        srv.pump_once(force=True)
    dd, _ = t2.result(timeout=timeout)
    np.testing.assert_allclose(dd, bd[0], **TOL)
    assert "degraded" not in t2.info
    stats = srv.stats()
    srv.close()
    return dict(stats=stats, victim=victim, reasons=srv.reasons)


@pytest.mark.parametrize("threaded", [False, True])
def test_device_loss_degraded_serving(threaded):
    """The degraded-serving drill in-process on four CPU slots (the
    reference runs it in a subprocess with four forced XLA devices)."""
    out = degraded_serving_drill([CPU] * 4, threaded=threaded)
    assert out["stats"]["degraded_batches"] >= 1 and out["stats"]["outstanding"] == 0


def test_server_threads_share_the_index(index):
    """Two threaded servers over one streaming index: the facade's lock
    serializes the index's stateful queries, and every answer is exact."""
    pts, idx = index
    q = _queries(64, seed=41)
    results = {}

    def client(name, rows):
        with KNNServer(idx, k=K, max_batch=32, purge_expired=False) as srv:
            results[name] = [t.result(timeout=60) for t in srv.submit_many(q[rows])]

    threads = [threading.Thread(target=client, args=(n, slice(n * 32, n * 32 + 32)))
               for n in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    bd, _ = knn_brute(q, pts, K, device=CPU)
    got = np.stack([r[0] for n in range(2) for r in results[n]])
    np.testing.assert_allclose(got, bd, **TOL)
