"""repro_torch's multi-device engines against repro's, on CPU device slots.

A slot is a position in the device list: ``(cpu,) * 4`` is four slots on
the CPU, the port's counterpart of the reference's
``--xla_force_host_platform_device_count=4``.  In-process, the port's
``forest``, ``sharded`` and ``ring`` answers on 1, 3 and 4 slots are held
against ``repro.core.brute.knn_brute``, its planner rule 3 against
``repro.api.planner.plan``, its ``build_forest`` and ``PointCloud`` against
``repro``'s.  One module-scoped subprocess runs ``repro`` on four forced
XLA devices (its ``MultiDeviceTrees``, its ``forest`` engine and
``ring_knn_brute``) and the port is held against what it saved.  Ids must
be equal up to ties, distances within rtol = atol = 1e-5.
"""

import dataclasses
import io
import os
import subprocess
import sys
import textwrap
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core.brute import knn_brute as jax_knn_brute
from repro.data.pipeline import PointCloud as JaxPointCloud
from repro.distributed.forest import build_forest as jax_build_forest
from repro_torch.api import IndexSpec, KNNIndex, available_engines, get_engine, plan
from repro_torch.data.pipeline import PointCloud
from repro_torch.distributed import MultiDeviceTrees, build_forest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
ENGINES = ("forest", "sharded", "ring")
N, M, D, K = 6000, 240, 6, 10   # n divides into 1, 3 and 4 shards


def _data(n=N, m=M, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _same_up_to_ties(dists, idx, ref_d, ref_i, pts, q):
    """Distances within TOL of the reference's; where an id differs, the
    port's neighbour is as near (a tie)."""
    np.testing.assert_allclose(dists, ref_d, **TOL)
    assert idx.dtype == np.int64
    d_of_idx = np.sqrt(np.sum((q[:, None, :] - pts[idx]) ** 2, -1))
    np.testing.assert_allclose(d_of_idx, ref_d, **TOL)
    assert (idx == ref_i).mean() > 0.99


def _build(engine, slots, pts, **kw):
    return KNNIndex.build(pts, IndexSpec(engine=engine, devices=(CPU,) * slots,
                                         tile_q=32, **kw))


# ---------------------------------------------------------------------------
# in-process: the three engines against repro's brute force
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slots", [1, 3, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_reference_brute_force(engine, slots):
    """Each engine on ``(cpu,) * slots`` against
    ``repro.core.brute.knn_brute``; the stats follow the reference's
    aggregation (ring: iterations = P, points_scanned = m n)."""
    pts, q = _data()
    ref_d, ref_i = (np.asarray(a) for a in jax_knn_brute(q, pts, K))
    index = _build(engine, slots, pts)
    res = index.query(q, K)
    _same_up_to_ties(res.dists, res.idx, ref_d, ref_i, pts, q)
    assert index.plan.n_shards == slots and res.engine == engine
    if engine == "ring":
        assert (res.stats.iterations, res.stats.points_scanned) == (slots, M * N)
    else:
        assert res.stats.iterations > 0 and res.stats.queries_advanced > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_answers_do_not_depend_on_the_slot_count(engine):
    """One slot against four on the same data (``repro.core.brute.knn_brute``
    settles any row where they differ): the same distances, ids equal up to
    ties; the sharded and ring engines bit for bit."""
    pts, q = _data(seed=1)
    one = _build(engine, 1, pts).query(q, K)
    four = _build(engine, 4, pts).query(q, K)
    np.testing.assert_allclose(four.dists, one.dists, **TOL)
    if engine in ("sharded", "ring"):
        assert np.array_equal(four.dists, one.dists) and np.array_equal(four.idx, one.idx)
    ref_d, ref_i = (np.asarray(a) for a in jax_knn_brute(q, pts, K))
    _same_up_to_ties(four.dists, four.idx, ref_d, ref_i, pts, q)


def test_warm_reaches_every_slot():
    """``KNNIndex.warm`` runs each forest slot's round for the batch shape
    (on the card it captures each slot's graph), so the query only reuses
    them; the sharded engine warms each slot's chunk of the batch."""
    from repro_torch.core.lazysearch import FP32_OVERFETCH

    pts, q = _data(seed=7)
    forest = _build("forest", 4, pts)
    forest.warm(M, K)
    keys = [list(sh.rounds) for sh in forest._state.shards]
    assert keys == [[(M, K + FP32_OVERFETCH)]] * 4
    forest.query(q, K)
    assert [list(sh.rounds) for sh in forest._state.shards] == keys
    sharded = _build("sharded", 3, pts)
    sharded.warm(M, K)
    res = sharded.query(q, K)
    np.testing.assert_allclose(res.dists, forest.query(q, K).dists, **TOL)


def test_ring_pads_uneven_sets_and_batches():
    """n and m that do not divide into the slots: the reference's padding
    (PAD_COORD rows, zero queries), pad ids never returned; k = n answers
    every point (``repro.core.brute.knn_brute``)."""
    pts, q = _data(n=1001, m=37, d=3, seed=2)
    index = _build("ring", 4, pts)
    res = index.query(q, K)
    ref_d, ref_i = (np.asarray(a) for a in jax_knn_brute(q, pts, K))
    _same_up_to_ties(res.dists, res.idx, ref_d, ref_i, pts, q)
    small = _build("ring", 3, pts[:20])
    res = small.query(q[:5], 20)
    assert (np.sort(res.idx, 1) == np.arange(20)).all()
    ref_d, _ = jax_knn_brute(q[:5], pts[:20], 20)
    np.testing.assert_allclose(res.dists, np.asarray(ref_d), **TOL)


@pytest.mark.parametrize("engine", ENGINES)
def test_rows_without_a_finite_neighbour_get_minus_one(engine):
    """A query with a NaN coordinate, or whose distances overflow fp32, has
    no finite neighbour: ``repro.api.KNNIndex(engine="brute")`` answers id
    -1 at +inf, and so does each engine on four slots; the other rows keep
    their exact answers."""
    pts, q = _data(n=3576, m=40, d=4, seed=11)
    q[3, 2] = np.nan
    q[7, 0] = 1e20
    q[9] = [1e20, -1e20, 1e20, 0.0]
    ref = jax_api.KNNIndex.build(pts, jax_api.IndexSpec(engine="brute")).query(q, 3)
    res = _build(engine, 4, pts).query(q, 3)
    bad = [3, 7, 9]
    assert (ref.idx[bad] == -1).all() and np.isinf(ref.dists[bad]).all()
    np.testing.assert_array_equal(res.idx[bad], ref.idx[bad])
    np.testing.assert_array_equal(res.dists[bad], ref.dists[bad])
    good = np.setdiff1d(np.arange(40), bad)
    _same_up_to_ties(res.dists[good], res.idx[good], ref.dists[good], ref.idx[good], pts,
                     q[good])


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_refuse_mutation_and_snapshots(engine, tmp_path):
    """As ``repro.api.KNNIndex`` on these engines: ``insert`` raises
    ``MutabilityError``, ``save`` the typed ``PersistUnsupported`` (the
    reference has no snapshot of them either)."""
    from repro.api.engine import PersistUnsupported as JaxPersistUnsupported
    from repro_torch.api import MutabilityError
    from repro_torch.api.engine import PersistUnsupported

    pts, _ = _data(n=2000, d=3, seed=12)
    index = _build(engine, 4, pts)
    with pytest.raises(MutabilityError, match="immutable"):
        index.insert(pts[:2])
    with pytest.raises(PersistUnsupported, match="no snapshot representation"):
        index.save(str(tmp_path / "port"))
    ref = jax_api.get_engine(engine)
    with pytest.raises(JaxPersistUnsupported, match="no snapshot representation"):
        ref.snapshot_state(None)


def test_build_forest_matches_reference():
    """``build_forest``'s shards against ``repro.distributed.forest.build_forest``:
    the same split dims, split values and (shard-local) original ids, the
    same offsets, at the default height and a pinned one."""
    pts, _ = _data(n=8192, d=5, seed=3)
    for height in (None, 3):
        trees, offsets = build_forest(pts, 4, height=height)
        ref_trees, ref_offsets = jax_build_forest(pts, 4, height=height)
        np.testing.assert_array_equal(offsets, np.asarray(ref_offsets))
        for t, r in zip(trees, ref_trees):
            np.testing.assert_array_equal(t.split_dim, np.asarray(r.split_dim))
            np.testing.assert_array_equal(t.split_val, np.asarray(r.split_val))
            np.testing.assert_array_equal(t.orig_idx, np.asarray(r.orig_idx))
    with pytest.raises(ValueError, match="equal shards"):
        build_forest(pts[:8191], 4)


# ---------------------------------------------------------------------------
# planner rule 3 (the cases of tests/test_api.py's multi-device plans)
# ---------------------------------------------------------------------------
RULE3_CASES = [
    pytest.param(dict(n=100_000, k=10), 4, id="device_count_drives_forest"),
    pytest.param(dict(n=100_000, k=10), 2, id="two_devices"),
    pytest.param(dict(n=100_001, k=10), 4, id="uneven_n_falls_back"),
    pytest.param(dict(n=100_000, k=10, memory_budget="half_shard", precision="fp32"), 4,
                 id="budget_falls_back"),
    pytest.param(dict(n=100_000, k=10, n_chunks=4), 4, id="pinned_chunks_route_to_sharded"),
    pytest.param(dict(n=16384, k=10, n_shards=3), 4, id="pinned_uneven_shards"),
    pytest.param(dict(n=16383, k=10, n_shards=3), 3, id="pinned_even_shards"),
    pytest.param(dict(n=100_000, k=10, engine="ring"), 4, id="pinned_ring"),
    pytest.param(dict(n=100_000, k=10, memory_budget=1 << 20), 4, id="budget_quantizes"),
]


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("kw,p", RULE3_CASES)
def test_rule3_matches_reference(kw, p, d):
    """``plan`` on ``(cpu,) * p`` against ``repro.api.planner.plan(devices=
    [object()] * p)``: engine, n_shards, n_chunks, precision, resident bytes
    and reasons.  At d a multiple of 8 the two leaf layouts coincide."""
    kw = dict(kw, d=d)
    if kw.get("memory_budget") == "half_shard":
        h = jax_api.plan(kw["n"], d, devices=[object()] * p).height
        kw["memory_budget"] = jax_api.estimate_slab_bytes(kw["n"], d, h) // p // 2
    port = plan(devices=(CPU,) * p, **kw)
    ref = jax_api.plan(devices=[object()] * p, **kw)
    for f in ("engine", "n_shards", "n_chunks", "precision", "height", "resident_bytes",
              "slab_bytes", "over_budget", "reasons"):
        assert getattr(port, f) == getattr(ref, f), f


def test_rule3_cases_and_registry():
    """The reference's expectations of rule 3 (``tests/test_api.py``'s
    multi-device plans) on CPU slots, and the three engines registered with
    ``repro``'s capabilities."""
    cpus = (CPU,) * 4
    assert plan(50_000, 8, devices=cpus).engine == "forest"
    assert plan(50_001, 8, devices=cpus).engine == "sharded"
    p = plan(100_000, 10, devices=cpus, n_chunks=4)
    assert (p.engine, p.n_chunks) == ("sharded", 4)
    assert plan(16383, 10, devices=(CPU,) * 3, n_shards=3).engine == "forest"
    # too few points a shard for k: sharded
    assert plan(4096, 8, k=600, devices=cpus, height=2).engine == "sharded"
    for name in ENGINES:
        assert name in available_engines(multi_device=True)
        caps, ref = (dataclasses.asdict(e.caps) for e in (get_engine(name),
                                                          jax_api.get_engine(name)))
        # the descriptions differ only where the reference names the TPU's ICI
        caps.pop("description"), ref.pop("description")
        assert caps == ref


@pytest.mark.parametrize("engine", ENGINES)
def test_resident_bytes_agree_with_the_plan(engine):
    """``KNNIndex.resident_bytes`` (measured where the engine can) against
    ``Plan.resident_bytes`` and against ``repro.api.planner.plan``'s for the
    same engine and shard count."""
    pts, _ = _data(n=8192, d=8, seed=4)
    index = _build(engine, 4, pts)
    ref = jax_api.plan(8192, 8, devices=[object()] * 4, engine=engine, tile_q=32)
    assert index.plan.resident_bytes == ref.resident_bytes
    assert index.resident_bytes() == index.plan.resident_bytes


# ---------------------------------------------------------------------------
# MultiDeviceTrees: active slots, concurrency
# ---------------------------------------------------------------------------
def test_query_with_active_leaves_idle_slots_out():
    """m < P: only the slots that got a chunk are active and have stats, as
    in ``repro.distributed.sharded.MultiDeviceTrees.query_with_active``
    (m = 2 over 4 slots: slots 0 and 2)."""
    pts, q = _data(n=3000, m=2, d=4, seed=5)
    mdt = MultiDeviceTrees(pts, devices=[CPU] * 4, height=3, tile_q=32)
    d, i, active, stats = mdt.query_with_active(q, 5)
    assert active == [0, 2] == mdt.active and len(stats) == 2
    assert set(mdt.slot_seconds) == {0, 2}
    ref_d, _ = jax_knn_brute(q, pts, 5)
    np.testing.assert_allclose(d, np.asarray(ref_d), **TOL)


def test_concurrent_callers_of_one_sharded_index():
    """Eight threads query one sharded index at once (the instance lock
    serializes its slots' stateful engines): every batch gets the answer it
    gets alone."""
    pts, q = _data(n=4000, m=400, d=5, seed=6)
    index = _build("sharded", 3, pts)
    batches = [q[i * 50:(i + 1) * 50] for i in range(8)]
    alone = [index.query(b, K) for b in batches]
    got = [None] * 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(i):
            got[i] = index.query(batches[i], K)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for a, b in zip(alone, got):
        assert np.array_equal(a.dists, b.dists) and np.array_equal(a.idx, b.idx)


# ---------------------------------------------------------------------------
# the launcher's data and the launcher
# ---------------------------------------------------------------------------
def test_point_cloud_matches_reference_bit_for_bit():
    """``PointCloud`` against ``repro.data.pipeline.PointCloud``: points at
    offsets, queries with salts."""
    for n, d, seed in ((1000, 10, 0), (333, 5, 7)):
        a, b = PointCloud(n, d, seed=seed), JaxPointCloud(n, d, seed=seed)
        assert np.array_equal(a.points(), b.points())
        assert np.array_equal(a.points(offset=3, count=50), b.points(offset=3, count=50))
        assert np.array_equal(a.queries(77, seed_salt=2), b.queries(77, seed_salt=2))


def test_knn_launcher_on_four_cpu_slots():
    """``python -m repro_torch.launch.knn --device cpu --slots 4`` plans the
    forest and answers exactly (``repro.launch.knn``'s lines)."""
    from repro_torch.launch.knn import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--device", "cpu", "--slots", "4", "--n", "20000", "--m", "500"])
    out = buf.getvalue()
    assert "engine=forest" in out and "recall@10=1.0000" in out, out
    assert "4 devices visible and n % 4 == 0" in out


# ---------------------------------------------------------------------------
# repro on four forced XLA devices (one subprocess), against the port
# ---------------------------------------------------------------------------
_REFERENCE = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.api import IndexSpec, KNNIndex
    from repro.compat import make_mesh
    from repro.distributed.ring_knn import ring_knn_brute
    from repro.distributed.sharded import MultiDeviceTrees
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(4096, 6)).astype(np.float32)
    q = rng.normal(size=(256, 6)).astype(np.float32)
    devs = jax.devices()[:4]
    assert len(devs) == 4
    mdt = MultiDeviceTrees(pts, devices=devs, height=3, tile_q=64)
    sd, si, active, _ = mdt.query_with_active(q, 10)
    _, _, active2, stats2 = mdt.query_with_active(q[:2], 10)
    fres = KNNIndex.build(pts, spec=IndexSpec(engine="forest", tile_q=64)).query(q, 10)
    ring_pts = rng.uniform(-1, 1, size=(2048, 3)).astype(np.float32)
    ring_q = rng.uniform(-1, 1, size=(128, 3)).astype(np.float32)
    rd2, ri = ring_knn_brute(jnp.asarray(ring_q), jnp.asarray(ring_pts), k=10,
                             mesh=make_mesh((4,), ("model",)), axis="model")
    np.savez(sys.argv[1], pts=pts, q=q, sd=sd, si=si, active=np.asarray(active),
             active2=np.asarray(active2), n_stats2=len(stats2),
             fd=fres.dists, fi=fres.idx, ring_pts=ring_pts, ring_q=ring_q,
             rd=np.sqrt(np.maximum(np.asarray(rd2), 0)), ri=np.asarray(ri))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multi") / "ref.npz")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), path], capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def test_sharded_matches_reference_multi_device_trees(reference):
    """``MultiDeviceTrees.query_with_active`` on four CPU slots against
    ``repro.distributed.sharded.MultiDeviceTrees`` on four XLA devices: the
    answers, the active slots, and with m = 2 the idle slots left out."""
    r = reference
    mdt = MultiDeviceTrees(r["pts"], devices=[CPU] * 4, height=3, tile_q=64)
    d, i, active, _ = mdt.query_with_active(r["q"], 10)
    _same_up_to_ties(d, i, r["sd"], r["si"], r["pts"], r["q"])
    assert active == r["active"].tolist()
    _, _, active2, stats2 = mdt.query_with_active(r["q"][:2], 10)
    assert active2 == r["active2"].tolist() and len(stats2) == int(r["n_stats2"])


def test_forest_matches_reference_forest_engine(reference):
    """The ``forest`` engine on four CPU slots against ``repro.api.KNNIndex``'s
    ``forest`` engine (``repro.distributed.forest.forest_knn``) on four XLA
    devices."""
    r = reference
    index = _build("forest", 4, r["pts"], k_hint=10)
    res = index.query(r["q"], 10)
    _same_up_to_ties(res.dists, res.idx, r["fd"], r["fi"], r["pts"], r["q"])
    assert index.plan.n_shards == 4


def test_ring_matches_reference_ring_knn_brute(reference):
    """The ``ring`` engine on four CPU slots against
    ``repro.distributed.ring_knn.ring_knn_brute`` on four XLA devices, on
    points near the origin at d = 3, where the reference's decomposed
    distances are right."""
    r = reference
    res = _build("ring", 4, r["ring_pts"]).query(r["ring_q"], 10)
    _same_up_to_ties(res.dists, res.idx, r["rd"], r["ri"].astype(np.int64), r["ring_pts"],
                     r["ring_q"])
