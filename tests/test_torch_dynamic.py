"""repro_torch's mutable index (``core/dynamic.py``, ``distributed/
dynamic_shards.py``, ``ChunkedLeafStore.kill_rows``) vs the JAX reference,
on the CPU.

Mirrors ``tests/test_dynamic.py`` (the generative interleavings, the
targeted edges, the carry chain's shape counters, the background merges,
the tombstone overwrites), the merge drills of ``tests/test_faults.py``
and the four-device replays of ``tests/test_dynamic_multidevice.py`` and
``tests/test_faults.py``'s device-loss drills, which run here in-process on
four CPU slots (``devices=(cpu,) * 4``; the reference forces four XLA host
devices in a subprocess).

The oracles: after any interleaving of insert / delete / query, a query
equals ``knn_brute`` over the live multiset (a shadow model replays every
mutation): distances within rtol = atol = 1e-4 (the reference's), every id
live and scoring its distance; and the same script through ``repro``'s
``DynamicIndex`` gives the same shard layout and the same answers, ids
equal up to ties (distances within rtol = atol = 1e-5).
"""

import os
import threading

import numpy as np
import pytest
import torch

from repro.core.dynamic import DynamicIndex as JaxDynamicIndex
from repro_torch import faults
from repro_torch.core.brute import knn_brute
from repro_torch.core.chunked_jit import chunk_round_cache_size
from repro_torch.core.dynamic import (
    MERGE_MAX_RETRIES,
    DynamicIndex,
    merge_cache_size,
    shard_scan_cache_size,
)
from repro_torch.core.toptree import PAD_COORD
from repro_torch.distributed import DrainTimeout, MergeRetryExhausted, ShardPlacer

SEED = int(os.environ.get("REPRO_DYNAMIC_SEED", "0"))
N_SCRIPTS = 200
N_BLOCKS = 8
N_REF_SCRIPTS = 48

D = 4
K_CHOICES = (1, 3, 6)
M_CHOICES = (1, 3, 8, 16)
CFG = dict(base_capacity=24, tomb_limit=6, brute_cutoff=96)
CPU = torch.device("cpu")
CPUS = [CPU]
SLOTS = [CPU] * 4
TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _index(**kw) -> DynamicIndex:
    kw.setdefault("devices", CPUS)
    return DynamicIndex(D, **kw)


def _live_arrays(model):
    ids = np.fromiter(sorted(model), np.int64, len(model))
    pts = np.stack([model[int(g)] for g in ids])
    return ids, pts


def _check_parity(idx, model, q, k):
    """The oracle: the index's answer is knn_brute's over the live set."""
    assert idx.n_live == len(model)
    ids, pts = _live_arrays(model)
    dd, di, stats = idx.query(q, k)
    bd, _ = knn_brute(q, pts, k, device=CPU)
    np.testing.assert_allclose(dd, bd, **TOL)
    assert np.isin(di, ids).all(), "query returned a dead or unknown id"
    pos = np.searchsorted(ids, di)
    diff = pts[pos].astype(np.float64) - q[:, None, :].astype(np.float64)
    np.testing.assert_allclose(dd, np.sqrt((diff * diff).sum(-1)), **TOL)
    assert stats.queries_advanced == q.shape[0]
    return stats


def _apply_insert(idx, model, pts):
    ids = idx.insert(pts)
    for i, g in enumerate(ids):
        model[int(g)] = pts[i]
    return ids


def _script_ops(rng, n_ops=12, max_points=240):
    """One random interleaving as a list of ops (the reference test's
    generator), made before either index runs so both see the same one."""
    ops, n_live, next_id, live = [], 0, 0, []
    for _ in range(n_ops):
        r = float(rng.random())
        if (r < 0.45 and n_live < max_points) or not n_live:
            b = int(rng.integers(1, 33))
            if n_live and rng.random() < 0.3:
                src = rng.integers(0, n_live, size=b)
                ops.append(("dup", src))
            else:
                ops.append(("insert", rng.normal(size=(b, D)).astype(np.float32)))
            live += list(range(next_id, next_id + b))
            next_id += b
            n_live += b
        elif r < 0.70 and n_live:
            ndel = int(rng.integers(1, n_live + 1))
            dels = rng.choice(np.asarray(live, np.int64), size=ndel, replace=False)
            ops.append(("delete", dels))
            live = sorted(set(live) - set(dels.tolist()))
            n_live -= ndel
        else:
            ks = [k for k in K_CHOICES if k <= n_live]
            if not ks:
                continue
            k = int(rng.choice(ks))
            m = int(rng.choice(M_CHOICES))
            ops.append(("query", k, rng.normal(size=(m, D)).astype(np.float32)))
    if not n_live:
        ops.append(("insert", rng.normal(size=(8, D)).astype(np.float32)))
        n_live = 8
    ops.append(("query", min(K_CHOICES[-1], n_live),
                rng.normal(size=(4, D)).astype(np.float32)))
    return ops


def _run_ops(idx, ops, model, on_query):
    for op in ops:
        if op[0] == "insert":
            _apply_insert(idx, model, op[1])
        elif op[0] == "dup":
            _, src = _live_arrays(model)
            _apply_insert(idx, model, src[op[1]])
        elif op[0] == "delete":
            idx.delete(op[1])
            for g in op[1]:
                del model[int(g)]
        else:
            on_query(op[1], op[2])


def _run_script(rng, **extra_cfg):
    idx = _index(**CFG, **extra_cfg)
    model = {}
    ops = _script_ops(rng)
    _run_ops(idx, ops, model, lambda k, q: _check_parity(idx, model, q, k))
    if extra_cfg.get("merge_async"):
        idx.drain_merges(timeout=60)
        caps = [cap for cap, *_ in idx.shard_layout()]
        assert len(caps) == len(set(caps)), "binary counter must settle"
        _check_parity(idx, model, rng.normal(size=(4, D)).astype(np.float32),
                      min(K_CHOICES[-1], len(model)))


# ---------------------------------------------------------------------------
class TestGenerativeParity:
    """``N_SCRIPTS`` seeded interleavings against knn_brute over the live
    set, in blocks (tests/test_dynamic.py::TestGenerativeParity)."""

    @pytest.mark.parametrize("block", range(N_BLOCKS))
    def test_interleaving_block(self, block):
        per_block = -(-N_SCRIPTS // N_BLOCKS)
        for j in range(per_block):
            script = block * per_block + j
            try:
                _run_script(np.random.default_rng(SEED * 1_000_003 + script))
            except AssertionError as e:  # pragma: no cover - diagnosis aid
                raise AssertionError(f"script {script} (seed base {SEED}) failed: {e}") from e


class TestAgainstReference:
    """The same scripts through ``repro.core.dynamic.DynamicIndex``: the
    same shard layout after every op (the carry chain, compaction and
    flattening decide alike) and the same answers, ids up to ties."""

    @pytest.mark.parametrize("block", range(4))
    def test_same_script_as_repro(self, block):
        per_block = N_REF_SCRIPTS // 4
        for j in range(per_block):
            script = block * per_block + j
            ops = _script_ops(np.random.default_rng(7_000 + script))
            ref, port = JaxDynamicIndex(D, **CFG), _index(**CFG)
            answers = {}
            for name, idx in (("ref", ref), ("port", port)):
                model, got = {}, []
                layouts = []

                def on_query(k, q, idx=idx, got=got):
                    dd, di, _ = idx.query(q, k)
                    got.append((q, np.asarray(dd), np.asarray(di)))

                for op in ops:
                    _run_ops(idx, [op], model, on_query)
                    layouts.append(idx.shard_layout())
                answers[name] = (got, layouts, model)
            (rg, rl, model), (pg, pl, _) = answers["ref"], answers["port"]
            assert pl == rl, f"script {script}: shard layouts differ"
            ids, pts = _live_arrays(model)
            for (q, rd, ri), (_, pd, pi) in zip(rg, pg):
                np.testing.assert_allclose(pd, rd, **REF_TOL)
                # a differing id is a tie: it scores the same distance
                off = pi != ri
                if off.any():
                    np.testing.assert_allclose(pd[off], rd[off], **REF_TOL)


class TestTargetedEdges:
    def test_k_exceeds_small_shard_live_and_capacity(self):
        rng = np.random.default_rng(5)
        idx, model = _index(**CFG), {}
        _apply_insert(idx, model, rng.normal(size=(150, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(3, D)).astype(np.float32))
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 20)

    def test_duplicates_across_shards_tie_exact(self):
        rng = np.random.default_rng(6)
        idx, model = _index(**CFG), {}
        base = rng.normal(size=(40, D)).astype(np.float32)
        _apply_insert(idx, model, base)
        _apply_insert(idx, model, base[:10])
        _apply_insert(idx, model, np.tile(base[:1], (5, 1)))
        _check_parity(idx, model, base[:4], 6)

    def test_delete_all_then_reinsert(self):
        rng = np.random.default_rng(7)
        idx, model = _index(**CFG), {}
        _apply_insert(idx, model, rng.normal(size=(120, D)).astype(np.float32))
        ids, _ = _live_arrays(model)
        idx.delete(ids)
        model.clear()
        assert idx.n_live == 0 and idx.shard_layout() == []
        with pytest.raises(ValueError, match="n_live=0"):
            idx.query(np.zeros((1, D), np.float32), 1)
        _apply_insert(idx, model, rng.normal(size=(30, D)).astype(np.float32))
        _check_parity(idx, model, rng.normal(size=(5, D)).astype(np.float32), 3)
        assert _live_arrays(model)[0].min() >= 120

    def test_tombstone_invariant_after_compaction(self):
        rng = np.random.default_rng(8)
        idx, model = _index(**CFG), {}
        _apply_insert(idx, model, rng.normal(size=(200, D)).astype(np.float32))
        ids, _ = _live_arrays(model)
        dels = rng.choice(ids, size=90, replace=False)
        idx.delete(dels)
        for g in dels:
            del model[int(g)]
        assert all(t <= CFG["tomb_limit"] for _, _, t, _ in idx.shard_layout())
        _check_parity(idx, model, rng.normal(size=(8, D)).astype(np.float32), 6)

    def test_delete_unknown_or_duplicate_raises(self):
        rng = np.random.default_rng(9)
        idx = _index(**CFG)
        idx.insert(rng.normal(size=(10, D)).astype(np.float32))
        with pytest.raises(KeyError, match="not live"):
            idx.delete([999])
        with pytest.raises(KeyError, match="duplicate"):
            idx.delete([1, 1])
        idx.delete([3])
        with pytest.raises(KeyError, match="not live"):
            idx.delete([3])
        with pytest.raises(KeyError, match="not live"):
            idx.delete([4, 999])
        assert idx.n_live == 9
        idx.delete([4])
        assert idx.n_live == 8

    def test_tree_shard_interleavings(self):
        rng = np.random.default_rng(SEED + 11)
        cfg = dict(base_capacity=32, tomb_limit=6, brute_cutoff=32)
        for _script in range(3):
            idx, model = _index(**cfg), {}
            for _ in range(8):
                r = float(rng.random())
                if r < 0.5 or not model:
                    _apply_insert(idx, model, rng.normal(
                        size=(int(rng.integers(8, 65)), D)).astype(np.float32))
                elif r < 0.7 and len(model) > 8:
                    ids, _ = _live_arrays(model)
                    dels = rng.choice(ids, size=int(rng.integers(1, 9)), replace=False)
                    idx.delete(dels)
                    for g in dels:
                        del model[int(g)]
                else:
                    _check_parity(idx, model, rng.normal(size=(8, D)).astype(np.float32),
                                  min(6, len(model)))
            assert any(kind == "tree" for *_, kind in idx.shard_layout())
            _check_parity(idx, model, rng.normal(size=(8, D)).astype(np.float32),
                          min(6, len(model)))


# ---------------------------------------------------------------------------
class TestCarryChainShapes:
    """The carry chain's shape counters (the reference's compile counts):
    each brute rung adds at most one scan shape, the fold two shapes in
    all, whatever the shard count; tree rungs one chunk-round shape each."""

    def test_brute_rungs_compile_once_each(self):
        rng = np.random.default_rng(13)
        idx = _index(base_capacity=32, tomb_limit=4, brute_cutoff=1 << 30)
        q = rng.normal(size=(16, D)).astype(np.float32)
        tiles0, merges0 = shard_scan_cache_size(), merge_cache_size()
        seen_caps = set()
        for _ in range(16):
            idx.insert(rng.normal(size=(32, D)).astype(np.float32))
            idx.query(q, 5)
            seen_caps |= {cap for cap, *_ in idx.shard_layout()}
        assert len(seen_caps) >= 4
        assert shard_scan_cache_size() - tiles0 <= len(seen_caps)
        assert merge_cache_size() - merges0 <= 2
        tiles1, merges1 = shard_scan_cache_size(), merge_cache_size()
        for _ in range(3):
            idx.query(rng.normal(size=(16, D)).astype(np.float32), 5)
        assert (shard_scan_cache_size(), merge_cache_size()) == (tiles1, merges1)

    def test_tree_rungs_compile_once_each(self):
        rng = np.random.default_rng(17)
        idx = _index(base_capacity=32, tomb_limit=4, brute_cutoff=32)
        q = rng.normal(size=(16, D)).astype(np.float32)
        rounds0 = chunk_round_cache_size()
        tree_caps = set()
        for _ in range(12):
            idx.insert(rng.normal(size=(32, D)).astype(np.float32))
            idx.query(q, 3)
            tree_caps |= {cap for cap, *_, kind in idx.shard_layout() if kind == "tree"}
        assert len(tree_caps) >= 2
        # a round shape is (batch, tile, chunk shape, k, dtype): one per rung
        # at the engine's k, one more per rung for the ladder's tail shapes
        grew = chunk_round_cache_size() - rounds0
        assert grew <= 3 * len(tree_caps), (grew, tree_caps)
        rounds1 = chunk_round_cache_size()
        for _ in range(3):
            idx.query(rng.normal(size=(16, D)).astype(np.float32), 3)
        assert chunk_round_cache_size() == rounds1


# ---------------------------------------------------------------------------
class TestBackgroundMerges:
    def test_async_interleavings_parity(self):
        for script in range(10):
            _run_script(np.random.default_rng(SEED * 7_000_003 + script), merge_async=True)

    def _held_merge(self):
        """Index with one background merge parked before its swap."""
        rng = np.random.default_rng(31)
        idx = _index(**CFG, merge_async=True)
        release, swapping = threading.Event(), threading.Event()

        def hook(phase, snaps):
            if phase == "swap":
                swapping.set()
                assert release.wait(30), "test forgot to release the merge"

        idx._merge_test_hook = hook
        model = {}
        _apply_insert(idx, model, rng.normal(size=(20, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(12, D)).astype(np.float32))
        assert swapping.wait(30), "merge was never scheduled"
        assert idx.pending_merges >= 1
        return idx, model, release, rng

    def test_queries_exact_while_merge_in_flight(self):
        idx, model, release, rng = self._held_merge()
        try:
            _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)
            caps = [cap for cap, *_ in idx.shard_layout()]
            assert len(caps) != len(set(caps)), "expected the transient collision"
        finally:
            release.set()
        idx._merge_test_hook = None
        idx.drain_merges(timeout=60)
        assert idx.merge_stats()["completed"] >= 1
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    def test_delete_during_merge_reapplied_at_swap(self):
        idx, model, release, rng = self._held_merge()
        try:
            ids, _ = _live_arrays(model)
            dels = rng.choice(ids, size=4, replace=False)
            idx.delete(dels)
            for g in dels:
                del model[int(g)]
            _check_parity(idx, model, rng.normal(size=(4, D)).astype(np.float32), 3)
        finally:
            release.set()
        idx._merge_test_hook = None
        idx.drain_merges(timeout=60)
        assert not np.isin(dels, idx.live_ids()).any()
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    def test_compaction_mid_merge_aborts_staging(self):
        idx, model, release, rng = self._held_merge()
        try:
            ids, _ = _live_arrays(model)
            dels = ids[: CFG["tomb_limit"] + 3]
            idx.delete(dels)
            for g in dels:
                del model[int(g)]
            assert all(t <= CFG["tomb_limit"] for _, _, t, _ in idx.shard_layout())
            _check_parity(idx, model, rng.normal(size=(4, D)).astype(np.float32), 3)
        finally:
            release.set()
        idx._merge_test_hook = None
        idx.drain_merges(timeout=60)
        assert idx.merge_stats()["aborted"] >= 1
        assert not np.isin(dels, idx.live_ids()).any()
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    def test_failed_merge_retries_in_background_and_recovers(self):
        rng = np.random.default_rng(53)
        idx = _index(**CFG, merge_async=True)
        boom = {"armed": True}

        def hook(phase, snaps):
            if phase == "build" and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected staging failure")

        idx._merge_test_hook = hook
        model = {}
        _apply_insert(idx, model, rng.normal(size=(20, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(12, D)).astype(np.float32))
        idx.drain_merges(timeout=60)
        stats = idx.merge_stats()
        assert stats["failed"] == 1 and stats["retried"] >= 1 and stats["completed"] >= 1
        assert not any(s.merging for s in idx._shards)
        caps = [cap for cap, *_ in idx.shard_layout()]
        assert len(caps) == len(set(caps))
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    def test_persistently_failing_merge_exhausts_retries(self):
        rng = np.random.default_rng(54)
        idx = _index(**CFG, merge_async=True)

        def hook(phase, snaps):
            if phase == "build":
                raise RuntimeError("injected persistent staging failure")

        idx._merge_test_hook = hook
        model = {}
        _apply_insert(idx, model, rng.normal(size=(20, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(12, D)).astype(np.float32))
        with pytest.raises(MergeRetryExhausted) as ei:
            idx.drain_merges(timeout=60)
        assert ei.value.rung == 0
        assert idx.merge_stats()["failed"] == MERGE_MAX_RETRIES + 1
        assert not any(s.merging for s in idx._shards)
        _check_parity(idx, model, rng.normal(size=(4, D)).astype(np.float32), 3)
        idx._merge_test_hook = None
        _apply_insert(idx, model, rng.normal(size=(2, D)).astype(np.float32))
        idx.drain_merges(timeout=60)
        assert idx.merge_stats()["completed"] >= 1
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    def test_failed_compaction_retry_loses_nothing(self):
        rng = np.random.default_rng(59)
        idx = _index(**CFG, merge_async=True)
        release, swapping = threading.Event(), threading.Event()
        state = {"builds": 0}

        def hook(phase, snaps):
            if phase == "build":
                state["builds"] += 1
                if state["builds"] == 2:
                    raise RuntimeError("injected compaction-rebuild failure")
            if phase == "swap" and state["builds"] == 1:
                swapping.set()
                assert release.wait(30)

        idx._merge_test_hook = hook
        model = {}
        _apply_insert(idx, model, rng.normal(size=(20, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(12, D)).astype(np.float32))
        assert swapping.wait(30)
        ids, _ = _live_arrays(model)
        dels = np.concatenate([ids[:4], ids[20:23]])
        idx.delete(dels)
        for g in dels:
            del model[int(g)]
        release.set()
        idx.drain_merges(timeout=60)
        stats = idx.merge_stats()
        assert stats["failed"] == 1 and stats["retried"] >= 1 and stats["completed"] >= 1
        assert idx.n_live == len(model) == idx.live_ids().size
        assert not any(s.merging for s in idx._shards)
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    def test_flatten_rebuild_aborts_in_flight_merge(self):
        idx, model, release, rng = self._held_merge()
        try:
            _apply_insert(idx, model,
                          rng.normal(size=(len(model) + 8, D)).astype(np.float32))
        finally:
            release.set()
        idx._merge_test_hook = None
        idx.drain_merges(timeout=60)
        assert idx.merge_stats()["aborted"] >= 1
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 5)

    def test_staging_shard_is_complete_before_it_is_visible(self):
        """The staging shard a merge swaps in answers from the first query
        on another thread (on the card: its uploads waited on by an event);
        the swap happens while the foreground queries."""
        rng = np.random.default_rng(61)
        idx = _index(base_capacity=32, tomb_limit=6, brute_cutoff=32, merge_async=True)
        model = {}
        stop = threading.Event()
        errors = []

        def reader():
            qrng = np.random.default_rng(62)
            while not stop.is_set():
                try:
                    q = qrng.normal(size=(4, D)).astype(np.float32)
                    dd, di, _ = idx.query(q, 3)
                    assert np.isfinite(dd).all() and (di >= 0).all()
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return

        for _ in range(3):
            _apply_insert(idx, model, rng.normal(size=(40, D)).astype(np.float32))
        t = threading.Thread(target=reader)
        t.start()
        for _ in range(6):
            _apply_insert(idx, model, rng.normal(size=(40, D)).astype(np.float32))
        idx.drain_merges(timeout=60)
        stop.set()
        t.join(30)
        assert not errors, errors
        assert idx.merge_stats()["completed"] >= 2
        _check_parity(idx, model, rng.normal(size=(8, D)).astype(np.float32), 5)


class TestMergeFaults:
    """tests/test_faults.py's merge drills, through the production
    injection points ``merge.build`` and ``merge.swap``."""

    CFG = dict(base_capacity=16, tomb_limit=6, brute_cutoff=16)

    def _two_batches(self, seed):
        rng = np.random.default_rng(seed)
        idx, model = _index(**self.CFG, merge_async=True), {}
        _apply_insert(idx, model, rng.normal(size=(10, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(8, D)).astype(np.float32))
        return idx, model, rng

    def test_transient_build_fault_is_retried(self):
        faults.arm("merge.build")
        idx, model, rng = self._two_batches(7)
        idx.drain_merges(timeout=60)
        stats = idx.merge_stats()
        assert stats["failed"] == 1 and stats["retried"] >= 1 and stats["completed"] >= 1
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 3)

    def test_swap_fault_is_retried(self):
        faults.arm("merge.swap")
        idx, model, rng = self._two_batches(8)
        idx.drain_merges(timeout=60)
        assert idx.merge_stats()["completed"] >= 1
        assert not any(s.merging for s in idx._shards)
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 3)

    def test_sticky_fault_exhausts_bounded_retries(self):
        faults.arm("merge.build", sticky=True)
        idx, model, rng = self._two_batches(9)
        with pytest.raises(MergeRetryExhausted) as ei:
            idx.drain_merges(timeout=60)
        assert ei.value.rung == 0
        assert idx.merge_stats()["failed"] == MERGE_MAX_RETRIES + 1
        _check_parity(idx, model, rng.normal(size=(4, D)).astype(np.float32), 3)

    def test_failed_kernel_build_surfaces_not_falls_back(self, monkeypatch):
        """A staging shard whose scan fails (a kernel that does not build or
        launch) surfaces through drain as MergeRetryExhausted: the merge is
        not finished another way, and the forest still answers exactly."""
        from repro_torch.core import dynamic

        warm = dynamic.DynamicIndex._warm_shard

        def broken_warm(self, shard):
            # the staging shard's scan, on the merge worker's thread
            if threading.current_thread().name.startswith("dyn-merge"):
                raise RuntimeError("leaf_scan kernel launch failed (injected)")
            return warm(self, shard)

        idx, model, rng = self._two_batches(12)
        idx.drain_merges(timeout=60)
        monkeypatch.setattr(dynamic.DynamicIndex, "_warm_shard", broken_warm)
        _apply_insert(idx, model, rng.normal(size=(10, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(8, D)).astype(np.float32))
        with pytest.raises(MergeRetryExhausted) as ei:
            idx.drain_merges(timeout=60)
        assert "kernel launch failed" in str(ei.value.__cause__)
        monkeypatch.undo()
        _check_parity(idx, model, rng.normal(size=(4, D)).astype(np.float32), 3)

    def test_drain_timeout_names_the_stuck_rung(self):
        rng = np.random.default_rng(10)
        idx = _index(**self.CFG, merge_async=True)
        release = threading.Event()

        def hook(phase, snaps):
            if phase == "build":
                assert release.wait(30)

        idx._merge_test_hook = hook
        model = {}
        _apply_insert(idx, model, rng.normal(size=(10, D)).astype(np.float32))
        _apply_insert(idx, model, rng.normal(size=(8, D)).astype(np.float32))
        try:
            with pytest.raises(DrainTimeout) as ei:
                idx.drain_merges(timeout=0.2)
            assert ei.value.rung == 0 and ei.value.rungs == (0,)
        finally:
            release.set()
            idx._merge_test_hook = None
        idx.drain_merges(timeout=60)
        assert idx.merge_stats()["completed"] >= 1

    def test_facade_drain_timeout_passes_through(self):
        from repro_torch.api import IndexSpec, KNNIndex

        rng = np.random.default_rng(11)
        idx = KNNIndex.build(rng.normal(size=(64, D)).astype(np.float32),
                             IndexSpec(mutable=True, buffer_size=32, merge_async=True,
                                       devices=tuple(CPUS)))
        release = threading.Event()

        def hook(phase, snaps):
            if phase == "build":
                assert release.wait(30)

        idx._state._merge_test_hook = hook
        try:
            idx.insert(rng.normal(size=(24, D)).astype(np.float32))
            idx.insert(rng.normal(size=(24, D)).astype(np.float32))
            with pytest.raises(DrainTimeout):
                idx.drain(timeout=0.2)
        finally:
            release.set()
            idx._state._merge_test_hook = None
        idx.drain(timeout=60)


# ---------------------------------------------------------------------------
class TestTombstoneOverwrite:
    def test_brute_rows_overwritten_and_width_tightened(self):
        rng = np.random.default_rng(37)
        idx, model = _index(base_capacity=32, tomb_limit=8, brute_cutoff=1 << 30), {}
        _apply_insert(idx, model, rng.normal(size=(30, D)).astype(np.float32))
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)
        ids, _ = _live_arrays(model)
        dels = rng.choice(ids, size=5, replace=False)
        idx.delete(dels)
        for g in dels:
            del model[int(g)]
        shard = idx._shards[0]
        assert shard.kind == "brute" and shard.n_tomb == 5
        dead_rows = ~shard.live[: shard.n_rows]
        assert (shard.points[: shard.n_rows][dead_rows] == np.float32(PAD_COORD)).all()
        # the device slab was written in place, not made again
        slab = shard._dev_slab.numpy()
        assert (slab[: shard.n_rows][dead_rows] == np.float32(PAD_COORD)).all()
        assert shard.fetch_width(4) == 4
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 4)

    @pytest.mark.parametrize("precision", ["fp32", "int8", "fp16"])
    def test_tree_rows_reclaimed_and_width_tightened(self, precision):
        """fp32: PAD_COORD written into the resident slab in place; codes:
        the dead mask and its resident packed rows; either way the
        leaf-ordered fp32 copies carry PAD_COORD, and the width stays k."""
        from repro_torch.core.quantize import pack_dead

        rng = np.random.default_rng(38)
        idx = _index(base_capacity=32, tomb_limit=6, brute_cutoff=32, precision=precision)
        model = {}
        _apply_insert(idx, model, rng.normal(size=(60, D)).astype(np.float32))
        tree = next(s for s in idx._shards if s.kind == "tree")
        store = tree.engine.store
        resident = store._resident
        assert tree.fetch_width(3) == 3
        dead_before = None if precision == "fp32" else int(store.dead.sum())
        ids, _ = _live_arrays(model)
        dels = rng.choice(np.intersect1d(ids, tree.ids[tree.live]), size=4, replace=False)
        idx.delete(dels)
        for g in dels:
            del model[int(g)]
        t = tree.engine.tree
        inv = np.empty(t.points.shape[0], np.int64)
        inv[t.orig_idx] = np.arange(t.points.shape[0])
        dead_rows = np.nonzero(~tree.live[: tree.n_rows])[0]
        assert dead_rows.size == 4
        assert (t.points[inv[dead_rows]] == np.float32(PAD_COORD)).all()
        if precision == "fp32":
            assert store._resident is resident   # in place
            p = inv[dead_rows]
            leaf = np.searchsorted(t.leaf_start, p, side="right") - 1
            row = p - t.leaf_start[leaf]
            assert (resident.numpy()[leaf, row] == np.float32(PAD_COORD)).all()
        else:
            assert int(store.dead.sum()) == dead_before + 4
            np.testing.assert_array_equal(store.device_meta()[2].numpy(), pack_dead(store.dead))
        assert tree.fetch_width(3) == 3
        _check_parity(idx, model, rng.normal(size=(6, D)).astype(np.float32), 3)


def _jax_store(slabs, n_chunks, sizes, precision):
    from repro.core.chunked import ChunkedLeafStore as JaxStore

    return JaxStore(slabs, n_chunks, uniform=True, precision=precision, leaf_sizes=sizes)


@pytest.mark.parametrize("precision", ["fp32", "int8", "fp16"])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_kill_rows_matches_the_reference(precision, n_chunks):
    """``ChunkedLeafStore.kill_rows`` against ``repro``'s on the same store:
    the same host slab (fp32) or dead mask (codes) after the kill, the
    resident tensors updated in place, a streamed chunk slot holding a
    killed row copied again, and the scan of every chunk equal to one over
    the reference's host slab."""
    from repro_torch.core.chunked import ChunkedLeafStore
    from repro_torch.core.quantize import pack_dead

    rng = np.random.default_rng(3)
    n_leaves, l_pad, d = 6, 16, 5
    slabs = rng.normal(size=(n_leaves, l_pad, d)).astype(np.float32)
    sizes = np.full(n_leaves, l_pad, np.int64)
    sizes[-1] = 11
    slabs[-1, 11:] = np.float32(PAD_COORD)
    port = ChunkedLeafStore(slabs.copy(), n_chunks, device=CPU, uniform=True,
                            precision=precision, leaf_sizes=sizes)
    ref = _jax_store(slabs.copy(), n_chunks, sizes, precision)
    list(port.stream(range(port.n_chunks)))   # fill the slots
    leaf, rows = np.array([0, 2, 2, 5]), np.array([3, 0, 15, 10])
    port.kill_rows(leaf, rows)
    ref.kill_rows(leaf, rows)
    if precision == "fp32":
        np.testing.assert_array_equal(port.host.numpy(), ref.host)
        got = np.concatenate([buf.numpy()[: hi - lo] for (_, buf, _), (lo, hi) in zip(
            port.stream(range(port.n_chunks)),
            (port.chunk_leaf_range(j) for j in range(port.n_chunks)))])
        np.testing.assert_array_equal(got, ref.host[: port.n_leaves])
    else:
        np.testing.assert_array_equal(port.dead, ref.dead)
        np.testing.assert_array_equal(port.device_meta()[2].numpy(), pack_dead(ref.dead))
        np.testing.assert_array_equal(port.quantized_state().dead, ref.quantized_state().dead)


# ---------------------------------------------------------------------------
class TestCertificateAfterKills:
    """The certificate bounds its rounding by the live rows' norms, so the
    PAD_COORD rows a tree shard is padded with, and the ones deletes write,
    leave no row unproven; and no path brings a deleted point back."""

    def test_no_refined_or_brute_rows_after_kills(self):
        rng = np.random.default_rng(71)
        idx, model = _index(base_capacity=64, tomb_limit=16, brute_cutoff=64), {}
        _apply_insert(idx, model, rng.normal(size=(700, D)).astype(np.float32))
        tree = next(s for s in idx._shards if s.kind == "tree")
        assert tree.n_rows < tree.capacity   # padded with PAD_COORD rows
        ids, _ = _live_arrays(model)
        dels = rng.choice(np.intersect1d(ids, tree.ids[tree.live]), size=12, replace=False)
        idx.delete(dels)
        for g in dels:
            del model[int(g)]
        stats = _check_parity(idx, model, rng.normal(size=(64, D)).astype(np.float32), 10)
        assert (stats.refined_rows, stats.exact_rows) == (0, 0)
        bound = tree.engine._x_norm_max
        live_norm = np.sqrt((tree.points[tree.live].astype(np.float64) ** 2).sum(1)).max()
        assert bound == pytest.approx(live_norm, rel=1e-6)

    def test_static_bound_covers_every_row_unless_live_given(self):
        """Without a ``live`` mask the bound is over every row, however large
        (a real coordinate of 2e17 stays in it, as on every static engine);
        the rows a ``live`` mask leaves out are left out of the bound."""
        from repro_torch.core.lazysearch import BufferKDTree

        rng = np.random.default_rng(73)
        pts = rng.normal(size=(300, D)).astype(np.float32)
        pts[17] = 2e17
        every = BufferKDTree(pts, height=3, device=CPU)._x_norm_max
        assert every >= 2e17 * np.sqrt(D) * (1 - 1e-6)
        live = np.ones(300, bool)
        live[17] = False
        rest = BufferKDTree(pts, height=3, device=CPU, live=live)._x_norm_max
        want = np.sqrt((pts[live].astype(np.float64) ** 2).sum(1)).max()
        assert rest == pytest.approx(want, rel=1e-6)

    def test_forced_brute_force_cannot_resurrect_deleted_neighbours(self, monkeypatch):
        """Rows forced past the certificate to the refining pass and fp32
        brute force over ``tree.points``: the deleted true nearest
        neighbours of those rows are never returned."""
        from repro_torch.core import lazysearch

        rng = np.random.default_rng(72)
        idx, model = _index(base_capacity=64, tomb_limit=16, brute_cutoff=64), {}
        _apply_insert(idx, model, rng.normal(size=(700, D)).astype(np.float32))
        q = rng.normal(size=(8, D)).astype(np.float32)
        _, nearest, _ = idx.query(q, 1)
        dels = np.unique(nearest[:, 0])
        idx.delete(dels)
        for g in dels:
            del model[int(g)]
        monkeypatch.setattr(lazysearch, "certify",
                            lambda queries, *a, **kw: np.zeros(len(queries), bool))
        stats = _check_parity(idx, model, q, 3)
        assert stats.exact_rows > 0
        _, di, _ = idx.query(q, 3)
        assert not np.isin(dels, di).any()


# ---------------------------------------------------------------------------
class TestDynamicUnits:
    def test_insert_returns_monotonic_ids(self):
        idx = DynamicIndex(3, base_capacity=8, brute_cutoff=16, devices=CPUS)
        a = idx.insert(np.zeros((4, 3), np.float32))
        b = idx.insert(np.ones((2, 3), np.float32))
        assert a.tolist() == [0, 1, 2, 3] and b.tolist() == [4, 5]
        assert idx.insert(np.empty((0, 3), np.float32)).size == 0

    def test_shape_validation(self):
        idx = DynamicIndex(3, devices=CPUS)
        with pytest.raises(ValueError, match=r"\[b, 3\]"):
            idx.insert(np.zeros((2, 4), np.float32))
        idx.insert(np.zeros((2, 3), np.float32))
        with pytest.raises(ValueError, match=r"\[m, 3\]"):
            idx.query(np.zeros((1, 5), np.float32), 1)
        with pytest.raises(ValueError, match="n_live"):
            idx.query(np.zeros((1, 3), np.float32), 3)

    def test_layout_is_binary_counter(self):
        rng = np.random.default_rng(19)
        idx = _index(base_capacity=16, brute_cutoff=1 << 30)
        for _ in range(9):
            idx.insert(rng.normal(size=(16, D)).astype(np.float32))
        caps = [cap for cap, *_ in idx.shard_layout()]
        assert len(caps) == len(set(caps))
        assert sum(live for _, live, *_ in idx.shard_layout()) == idx.n_live

    def test_big_batch_triggers_flattening_rebuild(self):
        rng = np.random.default_rng(23)
        idx = _index(base_capacity=16, brute_cutoff=1 << 30, rebuild_crossover=64)
        idx.insert(rng.normal(size=(40, D)).astype(np.float32))
        idx.insert(rng.normal(size=(10, D)).astype(np.float32))
        assert len(idx.shard_layout()) == 2
        idx.insert(rng.normal(size=(64, D)).astype(np.float32))
        assert len(idx.shard_layout()) == 1 and idx.n_live == 114

    def test_warm_is_noop_on_empty_and_runs_when_live(self):
        idx = _index(base_capacity=16, brute_cutoff=1 << 30)
        idx.warm(8, 3)
        idx.insert(np.random.default_rng(0).normal(size=(20, D)).astype(np.float32))
        idx.warm(8, 3)
        assert idx.stats.queries_advanced > 0


def test_launch_counts_are_exact_across_threads():
    """The leaf scan's launch counters, updated from the fan-out's and the
    merge worker's threads at once, lose no launch."""
    from repro_torch.kernels import knn_scan

    knn_scan.reset_launches()
    n_threads, per = 8, 2000

    def work(t):
        for i in range(per):
            knn_scan.count_launch("f32", f"f32_k{t % 2 + 10}", f"narrow<{t % 2}>")

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w = knn_scan.leaf_scan_units
    assert w.launches == n_threads * per
    assert w.launches_by_code["f32"] == n_threads * per
    assert sum(w.launches_by_instance.values()) == n_threads * per
    assert w.launches_by_variant == {"narrow<0>": n_threads * per // 2,
                                     "narrow<1>": n_threads * per // 2}
    knn_scan.reset_launches()
    assert w.launches == 0 and w.launches_by_variant == {}


# ---------------------------------------------------------------------------
# four device slots on the CPU (the reference forces four XLA host devices)
# ---------------------------------------------------------------------------
class TestFourSlots:
    CFG = dict(base_capacity=32, tomb_limit=6, brute_cutoff=32)

    def _check(self, idx, model, q, k):
        ids, live = _live_arrays(model)
        dd, di, _ = idx.query(q, k)
        bd, _ = knn_brute(q, live, k, device=CPU)
        np.testing.assert_allclose(dd, bd, **TOL)
        assert np.isin(di, ids).all()

    def test_parity_interleavings_across_devices(self):
        rng = np.random.default_rng(41)
        idx = DynamicIndex(D, **self.CFG, devices=SLOTS, merge_async=True)
        model = {}
        for _ in range(14):
            r = float(rng.random())
            if r < 0.5 or not model:
                b = rng.normal(size=(int(rng.integers(8, 49)), D)).astype(np.float32)
                _apply_insert(idx, model, b)
            elif r < 0.7 and len(model) > 12:
                ids, _ = _live_arrays(model)
                dels = rng.choice(ids, size=int(rng.integers(1, 9)), replace=False)
                idx.delete(dels)
                for g in dels:
                    del model[int(g)]
            else:
                self._check(idx, model, rng.normal(size=(8, D)).astype(np.float32),
                            min(5, len(model)))
        idx.drain_merges(timeout=120)
        self._check(idx, model, rng.normal(size=(8, D)).astype(np.float32), min(6, len(model)))
        tree_slots = {slot for _, kind, slot in idx.placement() if kind == "tree"}
        assert len(tree_slots) >= 2, idx.placement()
        assert {slot for _, kind, slot in idx.placement() if kind == "brute"} <= {0}

    def test_placer_balances_by_capacity(self):
        placer = ShardPlacer(SLOTS)
        first = placer.place(1 << 14, "tree")
        second = placer.place(1 << 12, "tree")
        third = placer.place(1 << 12, "tree")
        assert second != first and third not in (first, second)
        assert placer.place(256, "brute") == 0

    def test_facade_plan_uses_all_devices(self):
        from repro_torch.api import IndexSpec, KNNIndex

        rng = np.random.default_rng(43)
        pts = rng.normal(size=(5000, 5)).astype(np.float32)
        idx = KNNIndex.build(pts, IndexSpec(mutable=True, k_hint=5, devices=tuple(SLOTS)))
        assert idx.plan.n_devices == 4 and idx.plan.merge_async
        q = rng.normal(size=(16, 5)).astype(np.float32)
        dd, _ = idx.query(q, k=5)
        bd, _ = knn_brute(q, pts, 5, device=CPU)
        np.testing.assert_allclose(dd, bd, **TOL)

    def test_mutable_index_on_four_devices_parity(self):
        """tests/test_dynamic_multidevice.py's acceptance script at half
        its n (the crossover n / levels stays above the 3000-point
        batches): the planner places rungs, parity holds under mutation
        with background merges, tree shards land on > 1 slot."""
        from repro_torch.api import IndexSpec, KNNIndex

        rng = np.random.default_rng(0)
        d, k, m = 6, 10, 64
        pts = rng.normal(size=(20_000, d)).astype(np.float32)
        idx = KNNIndex.build(pts, IndexSpec(mutable=True, k_hint=k, m_hint=m,
                                            devices=tuple(SLOTS)))
        assert idx.engine_name == "dynamic", idx.describe()
        assert idx.plan.n_devices == 4 and idx.plan.n_shards == 4 and idx.plan.merge_async
        assert any("mutable multi-device" in r for r in idx.plan.reasons)
        model = {i: pts[i] for i in range(len(pts))}

        def check():
            ids, live = _live_arrays(model)
            q = rng.normal(size=(m, d)).astype(np.float32)
            dd, di = idx.query(q, k=k)
            bd, _ = knn_brute(q, live, k, device=CPU)
            np.testing.assert_allclose(dd, bd, **TOL)
            assert np.isin(di, ids).all()

        check()
        for _ in range(3):
            batch = rng.normal(size=(3000, d)).astype(np.float32)
            _apply_insert(idx, model, batch)
            ids, _ = _live_arrays(model)
            dels = rng.choice(ids, size=24, replace=False)
            idx.delete(dels)
            for g in dels:
                del model[int(g)]
            check()
        assert len({slot for _, kind, slot in idx._state.placement() if kind == "tree"}) >= 2
        idx.drain(timeout=120)
        assert idx._state.merge_stats()["completed"] >= 1
        caps = [cap for cap, *_ in idx._state.shard_layout()]
        assert len(caps) == len(set(caps))
        check()

    def test_placer_drop_device_contract(self):
        placer = ShardPlacer(SLOTS)
        placer.drop_device(2)
        assert placer.slots == [0, 1, 3] and placer.n_devices == 3
        with pytest.raises(KeyError):
            placer.drop_device(2)
        placer.drop_device(0)
        placer.drop_device(1)
        with pytest.raises(RuntimeError, match="last device"):
            placer.drop_device(3)

    def test_handle_device_loss_moves_shards(self):
        rng = np.random.default_rng(21)
        idx = DynamicIndex(D, base_capacity=32, brute_cutoff=32, devices=SLOTS,
                           merge_async=False)
        model = {}
        for _ in range(10):
            _apply_insert(idx, model, rng.normal(size=(200, D)).astype(np.float32))
        victim = max(s.slot for s in idx._shards)
        assert victim > 0
        event = idx.handle_device_loss(victim)
        assert "device loss" in event and "re-placed" in event
        assert not any(s.slot == victim for s in idx._shards)
        assert idx.handle_device_loss(victim) == ""
        self._check(idx, model, rng.normal(size=(8, D)).astype(np.float32), 4)

    @pytest.mark.parametrize("precision", ["fp32", "int8"])
    def test_device_loss_degrades_not_raises(self, precision):
        """tests/test_faults.py's device-loss drill: a shard-bearing slot
        dies mid-stream; queries keep answering exactly from the survivors,
        the event reaches the stats and the plan, mutations go on."""
        from repro_torch.api import IndexSpec, KNNIndex

        rng = np.random.default_rng(0)
        d, k = 5, 5
        pts = rng.normal(size=(12288, d)).astype(np.float32)
        idx = KNNIndex.build(pts[:8192], IndexSpec(mutable=True, buffer_size=1024, k_hint=k,
                                                   precision=precision,
                                                   devices=tuple(SLOTS)))
        model = {i: pts[i] for i in range(8192)}
        for lo in range(8192, 12288, 1024):
            _apply_insert(idx, model, pts[lo:lo + 1024])
        idx.drain(timeout=120)
        st = idx._state
        slots = {s.slot for s in st._shards}
        assert len(slots) >= 2, "forest never spread over slots"
        victim = max(slots)
        faults.arm("device.scan", device_index=victim, sticky=True)
        q = rng.normal(size=(16, d)).astype(np.float32)
        dd, di = idx.query(q, k=k)
        faults.reset()
        ids, live = _live_arrays(model)
        bd, _ = knn_brute(q, live, k, device=CPU)
        np.testing.assert_allclose(dd, bd, **TOL)
        assert np.isin(di, ids).all()
        ev = idx.stats.events
        assert len(ev) == 1 and "device loss" in ev[0] and "surviving device" in ev[0]
        assert any("device loss" in r for r in idx.plan.reasons)
        assert not any(s.slot == victim for s in st._shards)
        assert st.merge_stats()["device_loss"] == 1
        _apply_insert(idx, model, rng.normal(size=(150, d)).astype(np.float32))
        idx.drain(timeout=120)
        ids, live = _live_arrays(model)
        dd, _ = idx.query(q, k=k)
        bd, _ = knn_brute(q, live, k, device=CPU)
        np.testing.assert_allclose(dd, bd, **TOL)

    def test_other_slot_errors_propagate(self):
        """Only DeviceLost degrades: any other error of a slot propagates."""
        rng = np.random.default_rng(5)
        idx = DynamicIndex(D, base_capacity=32, brute_cutoff=32, devices=SLOTS)
        idx.insert(rng.normal(size=(400, D)).astype(np.float32))
        idx.insert(rng.normal(size=(100, D)).astype(np.float32))
        faults.arm("device.scan", device_index=0, exc=faults.FaultError("scan broke"))
        with pytest.raises(faults.FaultError, match="scan broke"):
            idx.query(rng.normal(size=(4, D)).astype(np.float32), 3)
        assert idx.merge_stats()["device_loss"] == 0
