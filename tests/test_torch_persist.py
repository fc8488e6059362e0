"""repro_torch's fault registry and persistence vs the JAX reference, on
the CPU.

Mirrors ``tests/test_faults.py``'s registry units and
``tests/test_persist.py`` on the port (``repro_torch.faults``,
``repro_torch.persist``, ``KNNIndex.save`` / ``load``), its
crash-and-replay harness over a mutable (``dynamic``) index included: a
kill at every op boundary and fault point, then ``load`` (snapshot + WAL
replay) answers exactly as the acknowledged mutations say.  The merge and
device-loss drills are in ``tests/test_torch_dynamic.py``.  Then the
cross-load tests: the port loads snapshots that ``repro`` wrote in the
test (a mutable index's with its WAL tail too) and answers as ``repro``'s
index does, and ``repro`` loads the port's; a save and load within the
port answers bit for bit the same.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro import persist as jax_persist
from repro_torch import faults
from repro_torch.api import IndexSpec, KNNIndex, knn_brute
from repro_torch.persist import (
    FORMAT_VERSION,
    PersistError,
    PersistUnsupported,
    VersionStore,
    WriteAheadLog,
)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPUS = (torch.device("cpu"),)
D = 4
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.reset()
    yield
    faults.reset()


def _rand(seed, n, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# faults.py (tests/test_faults.py::TestRegistry)
# ---------------------------------------------------------------------------
class TestRegistry:
    def test_points_are_the_reference(self):
        from repro import faults as jax_faults

        assert faults.INJECTION_POINTS == jax_faults.INJECTION_POINTS

    def test_disarmed_fire_is_a_noop(self):
        for point in faults.INJECTION_POINTS:
            faults.fire(point)  # must not raise

    def test_unknown_point_refused_at_arm_time(self):
        with pytest.raises(ValueError, match="unknown injection point"):
            faults.arm("wal.tron")

    def test_fires_on_nth_hit_then_disarms(self):
        faults.arm("wal.append", after=3)
        faults.fire("wal.append")
        faults.fire("wal.append")
        with pytest.raises(faults.SimulatedCrash):
            faults.fire("wal.append")
        faults.fire("wal.append")  # non-sticky: disarmed after firing

    def test_sticky_keeps_firing(self):
        faults.arm("merge.build", sticky=True)
        for _ in range(3):
            with pytest.raises(faults.FaultError):
                faults.fire("merge.build")

    def test_ctx_match_filters_hits(self):
        faults.arm("device.scan", device_index=2)
        faults.fire("device.scan", device_index=0)
        faults.fire("device.scan", device_index=1)
        faults.fire("device.scan")          # missing key: no match
        with pytest.raises(faults.DeviceLost) as ei:
            faults.fire("device.scan", device_index=2, device="cuda:2")
        assert ei.value.device == "cuda:2"
        assert ei.value.device_index == 2

    def test_default_exception_types_by_prefix(self):
        cases = {
            "wal.torn": faults.SimulatedCrash,
            "persist.commit": faults.SimulatedCrash,
            "checkpoint.write": faults.SimulatedCrash,
            "merge.swap": faults.FaultError,
            "device.scan": faults.DeviceLost,
        }
        for point, exc_type in cases.items():
            faults.arm(point)
            with pytest.raises(exc_type):
                faults.fire(point)

    def test_explicit_exception_override(self):
        faults.arm("merge.build", exc=KeyError("custom"))
        with pytest.raises(KeyError):
            faults.fire("merge.build")

    def test_hit_counting_enumerates_boundaries(self):
        faults.count_hits()
        faults.fire("wal.append")
        faults.fire("wal.append")
        faults.fire("persist.commit")
        assert faults.hits("wal.append") == 2
        assert faults.hits("persist.commit") == 1
        assert faults.hits("wal.torn") == 0

    def test_env_spec_parsing(self):
        script = textwrap.dedent("""
            import os, sys
            os.environ["REPRO_FAULTS"] = "wal.torn:2,device.scan:1:sticky"
            from repro_torch import faults
            faults.load_env()
            faults.fire("wal.torn")
            try:
                faults.fire("wal.torn")
                raise SystemExit("wal.torn never fired")
            except faults.SimulatedCrash:
                pass
            for _ in range(2):
                try:
                    faults.fire("device.scan")
                    raise SystemExit("device.scan not sticky")
                except faults.DeviceLost:
                    pass
            assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                           for m in sys.modules)
            print("ENV_FAULTS_OK")
        """)
        env = dict(os.environ, PYTHONPATH=SRC)
        out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                             text=True, env=env, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "ENV_FAULTS_OK" in out.stdout


# ---------------------------------------------------------------------------
# persist/format.py (tests/test_persist.py::TestVersionStore)
# ---------------------------------------------------------------------------
class TestVersionStore:
    def test_commit_read_roundtrip(self, tmp_path):
        store = VersionStore(str(tmp_path))
        arrs = {"a/b": np.arange(6).reshape(2, 3), "c": np.float32([1.5])}
        v = store.commit(arrs, {"engine": "x", "mutation_seq": 3})
        assert v == 1
        got, manifest, version = store.read()
        assert version == 1
        assert manifest["engine"] == "x" and manifest["mutation_seq"] == 3
        assert manifest["format"] == FORMAT_VERSION == jax_persist.FORMAT_VERSION
        assert set(got) == {"a/b", "c"}
        np.testing.assert_array_equal(got["a/b"], arrs["a/b"])
        # the reference reads the port's version, and the port the reference's
        ref_got, ref_manifest, _ = jax_persist.VersionStore(str(tmp_path)).read()
        np.testing.assert_array_equal(ref_got["a/b"], arrs["a/b"])
        assert ref_manifest == manifest
        jax_persist.VersionStore(str(tmp_path)).commit({"z": np.int64([4])}, {})
        assert store.read()[0]["z"][0] == 4 and store.versions() == [1, 2]

    def test_keep_k_gc_and_tmp_cleanup(self, tmp_path):
        store = VersionStore(str(tmp_path))
        os.makedirs(tmp_path / "v_0000000042.tmp")  # crashed-commit leftover
        for i in range(4):
            store.commit({"x": np.int64([i])}, {"i": i}, keep=2)
        assert store.versions() == [3, 4]
        assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))
        got, _, _ = store.read()
        assert got["x"][0] == 3

    def test_version_without_manifest_is_invisible(self, tmp_path):
        store = VersionStore(str(tmp_path))
        store.commit({"x": np.int64([1])}, {})
        half = tmp_path / "v_0000000002"
        half.mkdir()
        (half / VersionStore.ARRAYS).write_bytes(b"torn")
        assert store.versions() == [1]
        _, _, version = store.read()
        assert version == 1
        assert store.commit({"x": np.int64([2])}, {}) == 2

    def test_mmap_read_matches_eager_read(self, tmp_path):
        store = VersionStore(str(tmp_path))
        arrs = {
            "slab": np.arange(24, dtype=np.float32).reshape(2, 4, 3),
            "codes": np.arange(24, dtype=np.uint8).reshape(2, 4, 3),
            "ids": np.arange(7, dtype=np.int64) * 3,
            "live": np.array([True, False, True]),
            "empty": np.empty((0, 5), np.float32),
            "scalarish": np.float32([2.5]),
        }
        store.commit(arrs, {})
        eager, _, _ = store.read()
        mapped, _, _ = store.read(mmap=True)
        assert set(mapped) == set(eager)
        for key in eager:
            np.testing.assert_array_equal(mapped[key], eager[key])
            assert mapped[key].dtype == eager[key].dtype

    def test_mmap_is_copy_on_write(self, tmp_path):
        store = VersionStore(str(tmp_path))
        store.commit({"live": np.ones(64, bool)}, {})
        mapped, _, _ = store.read(mmap=True)
        mapped["live"][10:20] = False
        again, _, _ = store.read(mmap=True)
        assert again["live"].all()
        fresh, _, _ = store.read()
        assert fresh["live"].all()

    def test_format_version_mismatch_raises(self, tmp_path):
        store = VersionStore(str(tmp_path))
        store.commit({"x": np.int64([1])}, {})
        mpath = tmp_path / "v_0000000001" / VersionStore.MANIFEST
        manifest = json.loads(mpath.read_text())
        manifest["format"] = 999
        mpath.write_text(json.dumps(manifest))
        with pytest.raises(PersistError, match="format"):
            store.read()

    def test_empty_store_read_raises(self, tmp_path):
        with pytest.raises(PersistError, match="no complete snapshot"):
            VersionStore(str(tmp_path)).read()

    def test_crash_before_slab_write_leaves_no_version(self, tmp_path):
        store = VersionStore(str(tmp_path))
        store.commit({"x": np.int64([1])}, {})
        faults.arm("persist.slab_write")
        with pytest.raises(faults.SimulatedCrash):
            store.commit({"x": np.int64([2])}, {})
        assert store.versions() == [1]
        got, _, _ = store.read()
        assert got["x"][0] == 1

    def test_crash_before_rename_leaves_no_version(self, tmp_path):
        store = VersionStore(str(tmp_path))
        store.commit({"x": np.int64([1])}, {})
        faults.arm("persist.commit")
        with pytest.raises(faults.SimulatedCrash):
            store.commit({"x": np.int64([2])}, {})
        assert store.versions() == [1]
        assert any(n.endswith(".tmp") for n in os.listdir(tmp_path))
        v = store.commit({"x": np.int64([3])}, {})
        assert store.versions() == [1, v]
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# persist/wal.py (tests/test_persist.py::TestWriteAheadLog)
# ---------------------------------------------------------------------------
class TestWriteAheadLog:
    def test_append_replay_roundtrip(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        a, b = _rand(0, 3), np.int64([4, 7])
        wal.append("insert", a, 0)
        wal.append("delete", b, 1)
        recs = wal.replay()
        assert [(s, op) for s, op, _ in recs] == [(0, "insert"), (1, "delete")]
        np.testing.assert_array_equal(recs[0][2], a)
        np.testing.assert_array_equal(recs[1][2], b)
        assert wal.replay(min_seq=1)[0][0] == 1
        assert wal.replay(min_seq=2) == []
        # the same frames as the reference's log
        ref = jax_persist.WriteAheadLog(str(tmp_path)).replay()
        assert [(s, op) for s, op, _ in ref] == [(0, "insert"), (1, "delete")]

    def test_rotate_and_gc_drop_covered_segments(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append("insert", _rand(1, 2), 0)
        wal.append("insert", _rand(2, 2), 1)
        wal.rotate(2)
        wal.rotate(2)
        wal.append("insert", _rand(3, 2), 2)
        assert len(wal._segments()) == 2
        wal.gc(min_seq=2)
        assert wal._segments() == [2]
        assert [s for s, _, _ in wal.replay(min_seq=2)] == [2]
        wal.gc(min_seq=99)
        assert wal._segments() == [2]

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append("insert", _rand(4, 3), 0)
        faults.arm("wal.torn")
        with pytest.raises(faults.SimulatedCrash):
            wal.append("insert", _rand(5, 3), 1)
        wal.close()
        seg = os.path.join(str(tmp_path), "wal_000000000000.log")
        torn_size = os.path.getsize(seg)
        wal2 = WriteAheadLog(str(tmp_path))
        assert os.path.getsize(seg) < torn_size
        assert [s for s, _, _ in wal2.replay()] == [0]
        wal2.append("insert", _rand(6, 3), 1)
        assert [s for s, _, _ in wal2.replay()] == [0, 1]

    def test_mid_log_corruption_raises(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append("insert", _rand(7, 2), 0)
        wal.rotate(1)
        wal.append("insert", _rand(8, 2), 1)
        wal.close()
        first = os.path.join(str(tmp_path), "wal_000000000000.log")
        with open(first, "r+b") as f:
            f.seek(os.path.getsize(first) - 1)
            f.write(b"\xff")
        with pytest.raises(PersistError, match="torn WAL record in non-final"):
            WriteAheadLog(str(tmp_path)).replay()

    def test_seq_regression_raises(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append("insert", _rand(9, 2), 5)
        wal.append("insert", _rand(10, 2), 3)
        with pytest.raises(PersistError, match="seq went backwards"):
            wal.replay()


# ---------------------------------------------------------------------------
# the front door (tests/test_persist.py::TestFacadeRoundtrip)
# ---------------------------------------------------------------------------
ENGINES = [("brute", None), ("kdtree", None), ("host", None), ("host", "int8"),
           ("chunked", None), ("chunked", "int8"), ("chunked", "fp16"), ("streaming", None),
           ("jit", None)]


class TestFacadeRoundtrip:
    @pytest.mark.parametrize("engine,precision", ENGINES)
    def test_save_load_query_parity(self, engine, precision, tmp_path):
        """A save of the port and its load answer bit for bit the same."""
        pts = _rand(11, 400)
        q = _rand(12, 16)
        idx = KNNIndex.build(pts, IndexSpec(engine=engine, precision=precision, devices=CPUS))
        d0, i0 = idx.query(q, k=5)
        assert idx.save(str(tmp_path / engine)) == 1
        idx2 = KNNIndex.load(str(tmp_path / engine), devices=CPUS)
        assert idx2.engine_name == engine
        assert (idx2.n, idx2.d) == (idx.n, idx.d)
        assert idx2.plan.precision == idx.plan.precision
        d1, i1 = idx2.query(q, k=5)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)
        assert any("restored from" in r for r in idx2.plan.reasons)

    def test_unported_state_raises_typed_unsupported(self, tmp_path):
        from repro_torch.api import EngineBase

        with pytest.raises(PersistUnsupported, match="no snapshot"):
            EngineBase().snapshot_state(None)
        with pytest.raises(PersistUnsupported):
            EngineBase().restore_state({}, {}, None, None)

    def test_save_without_persist_dir_needs_path(self):
        idx = KNNIndex.build(_rand(14, 100), IndexSpec(devices=CPUS))
        with pytest.raises(PersistError, match="no live persist dir"):
            idx.save()

    def test_extra_arrays_roundtrip(self, tmp_path):
        idx = KNNIndex.build(_rand(15, 100), IndexSpec(engine="brute", devices=CPUS))
        vals = np.arange(100, dtype=np.int64)
        idx.save(str(tmp_path), extra_arrays={"values": vals})
        idx2 = KNNIndex.load(str(tmp_path), devices=CPUS)
        np.testing.assert_array_equal(idx2._extra_arrays["values"], vals)

    def test_persist_dir_refuses_rebaseline(self, tmp_path):
        spec = IndexSpec(engine="chunked", persist_dir=str(tmp_path), devices=CPUS)
        KNNIndex.build(_rand(16, 50), spec=spec)
        with pytest.raises(PersistError, match="already holds snapshot"):
            KNNIndex.build(_rand(17, 50), spec=spec)

    def test_save_rotates_and_gcs_wal(self, tmp_path):
        """``save()`` into the live persist dir: versions are kept to
        ``snapshot_keep`` and the WAL keeps one segment (an immutable
        engine logs no mutation, so it rotates at 0)."""
        spec = IndexSpec(engine="chunked", persist_dir=str(tmp_path), snapshot_keep=1,
                         devices=CPUS)
        idx = KNNIndex.build(_rand(18, 50), spec=spec)
        for _ in range(3):
            idx.save()
        wal_segs = [f for f in os.listdir(tmp_path / "wal") if f.endswith(".log")]
        assert wal_segs == ["wal_000000000000.log"]
        assert VersionStore(str(tmp_path / "versions")).versions() == [4]
        loaded = KNNIndex.load(str(tmp_path), devices=CPUS)
        assert loaded.save() == 5

    def test_crash_in_save_keeps_the_last_version(self, tmp_path):
        """A kill at either snapshot boundary (``persist.slab_write``,
        ``persist.commit``) leaves the previous version whole: the load
        answers as it."""
        pts, q = _rand(19, 300), _rand(20, 12)
        idx = KNNIndex.build(pts, IndexSpec(engine="chunked", persist_dir=str(tmp_path),
                                            devices=CPUS))
        d0, i0 = idx.query(q, k=4)
        for point in ("persist.slab_write", "persist.commit"):
            faults.arm(point)
            with pytest.raises(faults.SimulatedCrash):
                idx.save()
            loaded = KNNIndex.load(str(tmp_path), devices=CPUS)
            d1, i1 = loaded.query(q, k=4)
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(d0, d1)
        assert VersionStore(str(tmp_path / "versions")).versions() == [1]


# ---------------------------------------------------------------------------
# cross-load: the port and the reference read each other's snapshots
# ---------------------------------------------------------------------------
CROSS = [("brute", None), ("kdtree", None), ("host", None), ("chunked", None),
         ("chunked", "int8"), ("chunked", "fp16"), ("jit", None)]


def _cross_data():
    rng = np.random.default_rng(21)
    return (rng.normal(size=(3000, 5)).astype(np.float32),
            rng.normal(size=(150, 5)).astype(np.float32))


@pytest.mark.parametrize("engine,precision", CROSS)
def test_port_loads_a_reference_snapshot(engine, precision, tmp_path):
    """``repro.api.KNNIndex.save`` in the test, the port's ``load``: the
    same engine, geometry and precision, and ``repro``'s answers (the
    quantized store's codes adopted as they were saved)."""
    pts, q = _cross_data()
    ref = jax_api.KNNIndex.build(pts, jax_api.IndexSpec(engine=engine, precision=precision,
                                                        height=4))
    rd, ri = ref.query(q, 7)
    ref.save(str(tmp_path))
    idx = KNNIndex.load(str(tmp_path), devices=CPUS)
    assert (idx.engine_name, idx.height, idx.plan.n_chunks) == (
        engine, ref.plan.height, ref.plan.n_chunks)
    res = idx.query(q, 7)
    bd, _ = knn_brute(q, pts, 7, device="cpu")
    np.testing.assert_allclose(res.dists, bd, **TOL)
    np.testing.assert_allclose(res.dists, rd, **TOL)
    assert (res.idx == ri).mean() > 0.999
    if precision is not None:
        store = idx._state.store
        assert store.precision == precision
        arrays, _, _ = VersionStore(str(tmp_path / "versions")).read()
        np.testing.assert_array_equal(store.quantized_state().codes,
                                      arrays["quant/codes"][..., :5])


@pytest.mark.parametrize("engine,precision", CROSS)
def test_reference_loads_a_port_snapshot(engine, precision, tmp_path):
    """The port's ``save``, ``repro.api.KNNIndex.load``: the reference
    answers as the port does."""
    pts, q = _cross_data()
    idx = KNNIndex.build(pts, IndexSpec(engine=engine, precision=precision, height=4,
                                        devices=CPUS))
    pd, pi = idx.query(q, 7)
    idx.save(str(tmp_path))
    ref = jax_api.KNNIndex.load(str(tmp_path))
    assert (ref.engine_name, ref.plan.height) == (engine, idx.height)
    assert ref.plan.precision == idx.plan.precision
    rd, ri = ref.query(q, 7)
    np.testing.assert_allclose(rd, pd, **TOL)
    assert (ri == pi).mean() > 0.999


# ---------------------------------------------------------------------------
# the mutable index: snapshot + WAL, crash and replay
# (tests/test_persist.py::TestCrashRestoreHarness)
# ---------------------------------------------------------------------------
N_CRASH_SCRIPTS = 40
_CRASH_MODES = (
    ("none", ("insert", "delete", "save")),
    ("wal.append", ("insert", "delete")),
    ("wal.torn", ("insert", "delete")),
    ("persist.slab_write", ("save",)),
    ("persist.commit", ("save",)),
)


def _gen_ops(rng, n_ops):
    """A mutation script: save every 3rd op, insert / delete otherwise."""
    ops = []
    for i in range(n_ops):
        if i % 3 == 2:
            ops.append(("save", None))
        elif rng.random() < 0.7 or i < 2:
            ops.append(("insert", int(rng.integers(4, 17))))
        else:
            ops.append(("delete", int(rng.integers(1, 5))))
    return ops


def _apply_op(idx, shadow, rng, op, arg):
    """One op; the shadow is updated only after the call returns (an
    unacknowledged mutation may be lost)."""
    if op == "insert":
        pts = rng.normal(size=(arg, D)).astype(np.float32)
        for j, g in enumerate(idx.insert(pts)):
            shadow[int(g)] = pts[j]
    elif op == "delete":
        live = np.fromiter(sorted(shadow), np.int64, len(shadow))
        take = min(arg, len(live) - 8)
        if take < 1:
            return
        dels = rng.choice(live, size=take, replace=False)
        idx.delete(dels)
        for g in dels:
            del shadow[int(g)]
    else:
        idx.save()


def _assert_parity(idx, shadow, rng, *, k=3):
    ids = np.fromiter(sorted(shadow), np.int64, len(shadow))
    live = np.stack([shadow[int(g)] for g in ids])
    q = rng.normal(size=(4, D)).astype(np.float32)
    dd, di = idx.query(q, k=k)
    bd, bi = knn_brute(q, live, k, device="cpu")
    np.testing.assert_array_equal(di, ids[bi])
    np.testing.assert_allclose(dd, bd, rtol=1e-5, atol=1e-5)
    assert idx.n == len(shadow)


def _run_crash_script(seed, root, *, crash_at=None, mode=None):
    """build -> ops[:c] -> a kill at ops[c] -> load -> parity -> one more
    acknowledged mutation -> parity."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(40, D)).astype(np.float32)
    idx = KNNIndex.build(base, IndexSpec(mutable=True, buffer_size=16, k_hint=3,
                                         persist_dir=root, merge_async=False,
                                         devices=CPUS))
    shadow = {i: base[i] for i in range(40)}
    ops = _gen_ops(rng, n_ops=8)
    if crash_at is None:
        crash_at = int(rng.integers(0, len(ops) + 1))
    for i, (op, arg) in enumerate(ops):
        if i == crash_at:
            if mode is None:
                candidates = [m for m, kinds in _CRASH_MODES if op in kinds]
                mode = candidates[int(rng.integers(0, len(candidates)))]
            if mode != "none":
                faults.arm(mode)
                with pytest.raises(faults.SimulatedCrash):
                    _apply_op(idx, shadow, rng, op, arg)
                faults.reset()
            break   # the process "dies" here: the object is abandoned
        _apply_op(idx, shadow, rng, op, arg)
    idx2 = KNNIndex.load(root, devices=CPUS)
    _assert_parity(idx2, shadow, rng)
    _apply_op(idx2, shadow, rng, "insert", 6)
    _assert_parity(idx2, shadow, rng)
    return idx2


class TestCrashRestoreHarness:
    def test_every_boundary_of_a_fixed_script(self, tmp_path):
        """The same seeded script killed at every op boundary x every fault
        point that applies to the op."""
        ops = _gen_ops(np.random.default_rng(0), n_ops=8)
        runs = 0
        for c, (op, _) in enumerate(ops):
            for mode, kinds in _CRASH_MODES:
                if op in kinds:
                    _run_crash_script(777, str(tmp_path / f"c{c}_{mode.replace('.', '_')}"),
                                      crash_at=c, mode=mode)
                    runs += 1
        assert runs >= len(ops)

    @pytest.mark.parametrize("seed", range(N_CRASH_SCRIPTS))
    def test_seeded_interleavings(self, seed, tmp_path):
        _run_crash_script(seed, str(tmp_path / "s"))

    def test_replayed_records_are_reported(self, tmp_path):
        """``load`` replays exactly the records after the snapshot and says
        how many; the WAL keeps appending from there."""
        rng = np.random.default_rng(5)
        idx = KNNIndex.build(_rand(5, 50), IndexSpec(mutable=True, buffer_size=16,
                                                     persist_dir=str(tmp_path),
                                                     devices=CPUS))
        idx.insert(_rand(6, 10))
        idx.delete([0, 1])
        idx.save()
        idx.insert(_rand(7, 5))
        idx.delete([2])
        loaded = KNNIndex.load(str(tmp_path), devices=CPUS)
        assert any("replayed 2 WAL record(s)" in r for r in loaded.plan.reasons)
        assert loaded.n == 50 + 10 - 2 + 5 - 1 == idx.n
        q = rng.normal(size=(8, D)).astype(np.float32)
        d0, i0 = idx.query(q, 4)
        d1, i1 = loaded.query(q, 4)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)
        assert loaded._mutation_seq == 4


def _mutate_both(idx, seed):
    """The same acknowledged mutations on an index of either package."""
    rng = np.random.default_rng(seed)
    idx.insert(rng.normal(size=(300, 5)).astype(np.float32))
    idx.delete(np.arange(0, 600, 9))
    idx.insert(rng.normal(size=(40, 5)).astype(np.float32))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_port_loads_a_reference_mutable_index(precision, tmp_path):
    """``repro``'s mutable index with a persist dir: a snapshot, then more
    mutations in its WAL tail.  The port's ``load`` restores the forest and
    replays the tail: the same live ids, shard layout and answers (ids
    equal up to ties), and it goes on mutating."""
    pts, q = _cross_data()
    spec = dict(mutable=True, buffer_size=256, k_hint=7, merge_async=False,
                precision=precision)
    ref = jax_api.KNNIndex.build(pts[:2000], jax_api.IndexSpec(
        persist_dir=str(tmp_path), **spec))
    _mutate_both(ref, 1)
    ref.save()
    ref.insert(pts[2000:2100])
    ref.delete(np.arange(2, 600, 9))
    rd, ri = ref.query(q, 7)
    idx = KNNIndex.load(str(tmp_path), devices=CPUS)
    assert idx.engine_name == "dynamic" and idx.plan.precision == ref.plan.precision
    assert any("replayed 2 WAL record(s)" in r for r in idx.plan.reasons)
    np.testing.assert_array_equal(idx._state.live_ids(), ref._state.live_ids())
    assert idx._state.shard_layout() == ref._state.shard_layout()
    res = idx.query(q, 7)
    np.testing.assert_allclose(res.dists, rd, **TOL)
    assert (res.idx == ri).mean() > 0.999
    new = idx.insert(pts[2100:2110])
    assert new[0] == ref.insert(pts[2100:2110])[0]


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_reference_loads_a_port_mutable_index(precision, tmp_path):
    """The port's mutable index with a persist dir and a WAL tail; the
    reference's ``load`` restores and replays it and answers as the port
    does."""
    pts, q = _cross_data()
    idx = KNNIndex.build(pts[:2000], IndexSpec(
        mutable=True, buffer_size=256, k_hint=7, merge_async=False, precision=precision,
        persist_dir=str(tmp_path), devices=CPUS))
    _mutate_both(idx, 2)
    idx.save()
    idx.insert(pts[2000:2100])
    idx.delete(np.arange(2, 600, 9))
    pd, pi = idx.query(q, 7)
    ref = jax_api.KNNIndex.load(str(tmp_path))
    assert ref.engine_name == "dynamic"
    np.testing.assert_array_equal(ref._state.live_ids(), idx._state.live_ids())
    assert ref._state.shard_layout() == idx._state.shard_layout()
    rd, ri = ref.query(q, 7)
    np.testing.assert_allclose(rd, pd, **TOL)
    assert (ri == pi).mean() > 0.999
