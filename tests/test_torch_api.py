"""repro_torch.api vs repro.api on the CPU: the end-to-end slice.

Both packages get the same numpy points and queries.  Indices must be
equal up to ties (a tie may permute two equidistant neighbours) and
distances agree within rtol 1e-5 / atol 1e-6 (both finish with an exact
fp32 (q - x)^2 re-rank, summed in different orders).
"""

import functools
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core.toptree import build_top_tree as jax_build_top_tree
from repro.core.toptree import tree_to_arrays as jax_tree_to_arrays
from repro_torch.api import (
    KNOWN_OPS,
    BudgetError,
    IndexSpec,
    KNNIndex,
    MutabilityError,
    OpUnsupported,
    RadiusResult,
    SearchStats,
    StatResult,
    StreamingUnsupported,
    available_engines,
    dualtree_cache_size,
    estimate_slab_bytes,
    get_engine,
    knn_brute,
    knn_round_cache_size,
    plan,
)
from repro_torch.core import dualtree
from repro_torch.core.lazysearch import BufferKDTree
from repro_torch.core.quantize import PRECISIONS
from repro_torch.core.toptree import tree_from_arrays

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPU = (torch.device("cpu"),)

# (n, m, d, k, height): tests/test_api.py PARITY_SHAPES
PARITY_SHAPES = [
    pytest.param(4000, 300, 8, 10, 4, id="baseline"),
    pytest.param(700, 64, 4, 12, 6, id="k_gt_leaf"),
    pytest.param(2500, 128, 5, 7, 3, id="d_odd"),
    pytest.param(3000, 17, 8, 5, 4, id="m_lt_tile"),
]


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _assert_same_answers(res, ref_d, ref_i, pts, q):
    np.testing.assert_allclose(res.dists, ref_d, rtol=1e-5, atol=1e-6)
    assert res.idx.dtype == np.int64
    # up to ties: where ids differ, the port's neighbour is as near
    d_of_idx = np.sqrt(np.sum((q[:, None, :] - pts[res.idx]) ** 2, -1))
    np.testing.assert_allclose(d_of_idx, ref_d, rtol=1e-5, atol=1e-6)
    assert (res.idx == ref_i).mean() > 0.999


@functools.lru_cache(maxsize=None)
def _reference(n, m, d, k, height, engine, n_chunks):
    pts, q = _data(n, m, d, seed=n + m)
    spec = jax_api.IndexSpec(engine=engine, height=height, k_hint=k, tile_q=64,
                             n_chunks=n_chunks)
    res = jax_api.KNNIndex.build(pts, spec=spec).query(q, k=k)
    return res.dists, res.idx


@pytest.mark.parametrize("engine,n_chunks", [
    ("brute", None), ("chunked", 1), ("chunked", 3),
])
@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_knn_index_matches_reference(engine, n_chunks, n, m, d, k, height):
    pts, q = _data(n, m, d, seed=n + m)
    ref_d, ref_i = _reference(n, m, d, k, height, engine, n_chunks)
    spec = IndexSpec(engine=engine, height=height, k_hint=k, tile_q=64,
                     n_chunks=n_chunks, devices=CPU)
    index = KNNIndex.build(pts, spec=spec)
    res = index.query(q, k=k)
    _assert_same_answers(res, ref_d, ref_i, pts, q)
    assert res.engine == index.engine_name == engine
    if engine == "chunked":
        assert index.plan.n_chunks == n_chunks
        assert res.stats.chunk_rounds > 0
        assert (res.stats.chunk_copies > 0) == (n_chunks > 1)


@pytest.mark.parametrize("n,m,d,k,height", [
    pytest.param(3000, 64, 8, 150, 4, id="k150"),
    pytest.param(2000, 48, 130, 10, 3, id="d130"),
])
def test_knn_index_long_lists_and_wide_rows(n, m, d, k, height):
    """k above 128 and rows wider than 128 features: the leaf scan takes
    every k <= L_pad and every d, so the port answers what the reference
    answers (the CPU runs the plain version; the card test is in
    test_torch_cuda.py)."""
    pts, q = _data(n, m, d, seed=n + m)
    ref_d, ref_i = _reference(n, m, d, k, height, "chunked", 1)
    spec = IndexSpec(engine="chunked", height=height, k_hint=k, tile_q=64,
                     n_chunks=1, devices=CPU)
    res = KNNIndex.build(pts, spec=spec).query(q, k=k)
    assert res.dists.shape == (m, k)
    _assert_same_answers(res, ref_d, ref_i, pts, q)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_knn_index_d30_matches_reference(precision):
    """The wide cell's configuration at a small size: d = 30 (the top of
    the paper's range, rows past the narrow kernel's 16 features), no
    engine pinned, k = 10.  fp32 with no budget and int8 under a third of
    the fp32 slab bytes (planner rule 4, as ``chip_smoke.py``'s quant cell)
    both plan ``chunked`` with N = 1, as ``repro``'s planner does, and
    answer what ``repro``'s fp32 ``chunked`` engine answers: distances
    within rtol 1e-5 (atol 1e-6), ids equal up to ties (the port's int8
    store proves each row and refines the unproven ones, so it is exact
    too)."""
    n, m, d, k, height = 4000, 200, 30, 10, 4
    pts, q = _data(n, m, d, seed=n + m)
    ref_d, ref_i = _reference(n, m, d, k, height, "chunked", 1)
    budget = estimate_slab_bytes(n, d, height) // 3 if precision == "int8" else None
    index = KNNIndex.build(pts, spec=IndexSpec(height=height, memory_budget=budget,
                                               devices=CPU))
    ref_plan = jax_api.KNNIndex.build(pts, spec=jax_api.IndexSpec(
        height=height, memory_budget=budget)).plan
    assert (index.plan.engine, index.plan.precision, index.plan.n_chunks) == (
        "chunked", precision, 1)
    assert (ref_plan.engine, ref_plan.precision, ref_plan.n_chunks) == (
        "chunked", precision, 1)
    res = index.query(q, k=k)
    _assert_same_answers(res, ref_d, ref_i, pts, q)


def test_carried_tree_from_reference():
    """The index's weights are its tree: a tree built by ``repro`` and
    carried over as arrays gives the reference's answers."""
    pts, q = _data(4000, 300, 8, seed=4300)
    ref_tree = jax_build_top_tree(pts, 4)
    arrays = jax_tree_to_arrays(ref_tree, include_derived=True)
    tree = tree_from_arrays(arrays["points"], arrays, height=ref_tree.height,
                            leaf_pad=ref_tree.leaf_pad)
    index = BufferKDTree(pts, tree=tree, n_chunks=2, tile_q=64,
                         device=torch.device("cpu"))
    assert index.tree is tree
    dists, idx = index.query(q, 10)
    ref_d, ref_i = _reference(4000, 300, 8, 10, 4, "chunked", 1)
    _assert_same_answers(SimpleNamespace(dists=dists, idx=idx), ref_d, ref_i, pts, q)
    with pytest.raises(ValueError, match="prebuilt tree"):
        BufferKDTree(pts[:100], tree=tree, device=torch.device("cpu"))


@pytest.mark.parametrize("kw", [
    dict(n=200_000, d=10),
    dict(n=200_000, d=10, memory_budget=4 << 20, precision="fp32"),
    dict(n=200_000, d=10, memory_budget=4 << 20),
    dict(n=200_000, d=16, memory_budget=4 << 20, precision="fp32"),
    dict(n=200_000, d=16, memory_budget=4 << 20),
    dict(n=1000, d=3),
    dict(n=50_000, d=8, m=10),
    dict(n=50_000, d=8, engine="brute"),
    dict(n=50_000, d=8, n_chunks=4),
    dict(n=50_000, d=8, memory_budget=1),
])
def test_plan_matches_reference(kw):
    """The reference's plan on the port's leaf layout: features unpadded,
    where the reference pads them to a multiple of 8.  Where d is such a
    multiple the layouts coincide, and so must every field."""
    import jax

    port = plan(devices=CPU, **kw)
    ref = jax_api.plan(devices=jax.devices()[:1], **kw)
    for f in ("engine", "height", "buffer_size", "tile_q"):
        assert getattr(port, f) == getattr(ref, f), f
    d = kw["d"]
    d_pad = -(-d // 8) * 8
    if d == d_pad or "memory_budget" not in kw:
        for f in ("n_chunks", "precision", "over_budget"):
            assert getattr(port, f) == getattr(ref, f), f
    else:
        # a smaller layout never needs more chunks or a coarser precision
        assert port.n_chunks <= ref.n_chunks
        assert PRECISIONS.index(port.precision) <= PRECISIONS.index(ref.precision)
    if port.precision != ref.precision:
        return
    assert port.slab_bytes * d_pad == ref.slab_bytes * d
    if port.engine == "chunked" and port.n_chunks == ref.n_chunks:
        if port.precision == "fp32":
            assert port.resident_bytes * d_pad == ref.resident_bytes * d
        else:
            assert d == d_pad and port.resident_bytes == ref.resident_bytes


def test_planner_errors_and_limits():
    with pytest.raises(BudgetError):
        plan(50_000, 8, devices=CPU, memory_budget=1, strict_budget=True)
    two = plan(50_000, 8, devices=CPU * 2)
    assert (two.engine, two.n_shards) == ("forest", 2)
    assert any("2 devices visible and n % 2 == 0" in r for r in two.reasons)
    p = plan(50_000, 8, devices=CPU, op="radius")
    assert p.engine == "chunked" and any("op='radius'" in r for r in p.reasons)
    pinned = plan(50_000, 8, devices=CPU, engine="forest")
    assert (pinned.engine, pinned.n_shards) == ("forest", 1)
    with pytest.raises(KeyError, match="unknown engine"):
        plan(50_000, 8, devices=CPU, engine="mesh")
    mut = plan(50_000, 8, devices=CPU, mutable=True)
    assert (mut.engine, mut.merge_async) == ("dynamic", True)
    assert any("modeled crossover" in r for r in mut.reasons)
    with pytest.raises(ValueError, match="caps.mutable=False"):
        plan(50_000, 8, devices=CPU, mutable=True, engine="chunked")
    assert sorted(available_engines()) == ["brute", "chunked", "dynamic", "forest", "host",
                                           "jit", "kdtree", "ring", "sharded", "streaming"]
    assert sorted(available_engines(op="kde")) == ["brute", "chunked", "host", "streaming"]
    assert get_engine("chunked").caps.ops == frozenset(DUAL_OPS + ("knn",))
    assert get_engine("jit").caps.ops == frozenset({"knn"})


def test_facade_contract():
    pts, q = _data(3000, 50, 5, seed=1)
    index = KNNIndex.build(pts, IndexSpec(devices=CPU, height=4, tile_q=32))
    assert index.stats.iterations == 0
    index.warm(50, 5)
    before = knn_round_cache_size()
    dists, idx = index.query(q, k=5)
    assert knn_round_cache_size() == before
    bd, bi = knn_brute(q, pts, 5, device="cpu")
    np.testing.assert_allclose(dists, bd, rtol=1e-5, atol=1e-6)
    assert index.stats.iterations > 0
    assert index.resident_bytes() == estimate_slab_bytes(3000, 5, 4)
    assert "engine=chunked" in index.describe()
    # the dual-tree ops on the chunked index agree with the brute oracles
    ip, ix, dd = index.radius(q, 0.5)
    bip, bix, bdd = dualtree.radius_brute(q, pts, 0.5, device="cpu")
    np.testing.assert_array_equal(ip, bip)
    np.testing.assert_allclose(dd, bdd, rtol=1e-6)
    dens, err = index.kde(q, 0.3)
    exact = dualtree.kde_brute(q, pts, 0.3, device="cpu").astype(np.float64)
    assert np.all(np.abs(dens - exact) <= 1e-2 * exact + 1e-9 + 1e-5 * np.maximum(exact, 1))
    edges = np.sqrt([0.5, 1.5, 4.5])
    hist, err = index.pair_count(edges)
    np.testing.assert_array_equal(hist, dualtree.pair_count_brute(pts, edges, device="cpu"))
    assert err == 0.0 and index.stats.units_scanned > 0
    jit = KNNIndex.build(pts, IndexSpec(engine="jit", devices=CPU, height=4))
    with pytest.raises(OpUnsupported, match="radius"):
        jit.radius(q, 0.5)
    with pytest.raises(MutabilityError):
        index.insert(pts[:3])
    with pytest.raises(StreamingUnsupported):
        index.query_stream(q, 5, on_complete=print)
    with pytest.raises(ValueError):
        index.query(q[:, :3], 5)
    q8 = KNNIndex.build(pts, IndexSpec(devices=CPU, height=4, precision="int8"))
    d8, i8 = q8.query(q, k=5)
    np.testing.assert_array_equal(i8, bi)
    np.testing.assert_allclose(d8, bd, rtol=1e-5, atol=1e-6)
    assert q8.plan.precision == "int8" and "precision=int8" in q8.describe()
    assert q8.resident_bytes() < index.resident_bytes()
    host = BufferKDTree(pts, height=4, engine="host", device=torch.device("cpu"))
    hd, hi = host.query(q, 5)
    np.testing.assert_allclose(hd, bd, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(hi, bi)
    assert host.stats.flushes > 0 and host.stats.iterations > 0
    with pytest.raises(ValueError, match="engine="):
        BufferKDTree(pts, height=4, engine="warp", device=torch.device("cpu"))


# -- multi-op front door (tests/test_api.py:784-916) ----------------------
#
# Every (op, engine) the registry declares is swept over the parity shapes
# against the reference's all-pairs oracles.  Parity data is an integer
# lattice (squared distances exact in fp32) with radii / edges whose squares
# are non-integers, so radius and pair_count compare bit for bit.

DUAL_OPS = ("radius", "kde", "pair_count")
OP_PAIRS = sorted((op, eng) for op in DUAL_OPS for eng in available_engines(op=op))
NON_DECLARING = sorted(
    eng for eng in available_engines()
    if not any(op in get_engine(eng).caps.ops for op in DUAL_OPS)
)


def _lattice_data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    span = max(3, int(np.sqrt(300 / d)))
    pts = rng.integers(0, span, size=(n, d)).astype(np.float32)
    q = rng.integers(0, span, size=(m, d)).astype(np.float32)
    return pts, q


# squared values are non-integers: no lattice distance sits on an edge
_EDGES = np.sqrt(np.array([0.5, 3.5, 7.5, 16.5, 32.5, 64.5, 144.5]))


def _csr_rows_equal(ip_a, ix_a, ip_b, ix_b):
    assert np.array_equal(ip_a, ip_b)
    for i in range(len(ip_a) - 1):
        assert set(ix_a[ip_a[i]:ip_a[i + 1]].tolist()) == set(
            ix_b[ip_b[i]:ip_b[i + 1]].tolist()), f"row {i}"


@pytest.mark.parametrize("op,engine", OP_PAIRS, ids=[f"{o}-{e}" for o, e in OP_PAIRS])
@pytest.mark.parametrize("n,m,d,k,height", PARITY_SHAPES)
def test_declared_op_exact_vs_reference_oracle(op, engine, n, m, d, k, height):
    """``tests/test_api.py::TestOpParity`` on the port: each declared op
    against ``repro.core.dualtree``'s oracles on the same lattice data."""
    from repro.core.dualtree import kde_brute, pair_count_brute, radius_brute

    pts, q = _lattice_data(n, m, d, seed=(n * 7 + m * 3 + d + len(op)) % 1000)
    idx = KNNIndex.build(pts, IndexSpec(engine=engine, op=op, height=height, m_hint=m,
                                        devices=CPU))
    if op == "radius":
        r = float(np.sqrt(1.5 * d + 0.5))
        res = idx.radius(q, r)
        assert isinstance(res, RadiusResult)
        bi, bj, _ = radius_brute(q, pts, r)
        _csr_rows_equal(res.indptr, res.indices, bi, bj)
        assert res.engine == engine and res.r == r
    elif op == "kde":
        h, rtol, atol = float(np.sqrt(d)), 1e-2, 1e-9
        res = idx.kde(q, h, rtol=rtol, atol=atol)
        assert isinstance(res, StatResult) and res.op == "kde"
        exact = kde_brute(q, pts, h).astype(np.float64)
        bound = rtol * exact + atol + 1e-5 * np.maximum(exact, 1.0)
        assert np.all(np.abs(res.values.astype(np.float64) - exact) <= bound)
    else:
        res = idx.pair_count(_EDGES)
        assert isinstance(res, StatResult) and res.op == "pair_count"
        ref = pair_count_brute(pts, _EDGES)
        assert np.array_equal(res.values, ref)
        assert res.values.sum() > 0  # non-degenerate histogram
        assert res.error_bound == 0.0
    assert isinstance(res.stats, SearchStats)


def test_op_caps_contract():
    """``tests/test_api.py::TestOpCapsContract``: a closed set of ops, the
    engines of the reference that declare the dual-tree ops declare them
    here, the registry filters by op, and ``jit`` (knn only) raises the
    typed ``OpUnsupported`` from every op entry point, naming the engines
    that declare it."""
    assert KNOWN_OPS == {"knn", "radius", "kde", "pair_count"}
    ref = jax_api.available_engines()
    for name, caps in available_engines().items():
        assert caps.ops <= KNOWN_OPS and "knn" in caps.ops, name
        assert caps.ops == ref[name].ops, name
    for op in DUAL_OPS:
        assert sorted(available_engines(op=op)) == ["brute", "chunked", "host", "streaming"]
    assert set(available_engines(op="knn")) == set(available_engines())
    with pytest.raises(ValueError, match="unknown op"):
        available_engines(op="warp")
    assert NON_DECLARING == ["dynamic", "forest", "jit", "kdtree", "ring", "sharded"]
    pts, q = _lattice_data(700, 16, 4, seed=22)
    idx = KNNIndex.build(pts, IndexSpec(engine="jit", height=2, devices=CPU))
    with pytest.raises(OpUnsupported, match="radius"):
        idx.radius(q, 1.0)
    with pytest.raises(OpUnsupported, match="kde"):
        idx.kde(q, 1.0)
    with pytest.raises(OpUnsupported, match="chunked"):
        idx.pair_count(np.array([0.5, 1.5]))
    with pytest.raises(OpUnsupported):
        idx.warm(m=8, ops=("radius",))
    assert isinstance(OpUnsupported("x"), TypeError)


def test_planner_op_rules():
    """``tests/test_api.py::TestPlannerOpRules``: unknown ops rejected, the
    op recorded in the reasons, a pinned engine lacking the op and
    ``mutable`` with a dual-tree op raise, as ``repro.api.plan`` does."""
    with pytest.raises(ValueError, match="unknown op"):
        plan(5000, 8, op="warp", devices=CPU)
    with pytest.raises(ValueError, match="unknown op"):
        KNNIndex.build(np.zeros((64, 3), np.float32), spec=IndexSpec(op="warp", devices=CPU))
    p = plan(5000, 8, m=300, op="radius", devices=CPU)
    ref = jax_api.plan(5000, 8, m=300, op="radius")
    assert p.engine == ref.engine and "radius" in get_engine(p.engine).caps.ops
    assert any("op='radius'" in r for r in p.reasons)
    with pytest.raises(ValueError, match="does not declare"):
        plan(5000, 8, engine="jit", op="kde", devices=CPU)
    with pytest.raises(ValueError, match="does not declare"):
        jax_api.plan(5000, 8, engine="jit", op="kde")
    with pytest.raises(ValueError, match="mutable"):
        plan(5000, 8, mutable=True, op="pair_count", devices=CPU)


def test_dual_ops_warm_and_quantized_index():
    """``KNNIndex.warm(ops=, n_edges=)`` meets every batch shape of the
    live calls; an int8 index answers the dual-tree ops exactly from a
    private fp32 store (``BufferKDTree.dualtree``)."""
    pts, q = _lattice_data(2500, 300, 3, seed=30)
    index = KNNIndex.build(pts, IndexSpec(height=4, precision="int8", devices=CPU))
    assert index.plan.precision == "int8" and index._state.store.quantized
    index.warm(m=300, ops=("radius", "kde", "pair_count"), n_edges=len(_EDGES))
    before = dualtree_cache_size()
    r = float(np.sqrt(7.5))
    res = index.radius(q, r)
    index.kde(q, 1.0)
    hist = index.pair_count(_EDGES).values
    assert dualtree_cache_size() == before
    assert not index._state.dualtree().store.quantized
    from repro.core.dualtree import pair_count_brute, radius_brute

    bi, bj, _ = radius_brute(q, pts, r)
    _csr_rows_equal(res.indptr, res.indices, bi, bj)
    np.testing.assert_array_equal(hist, pair_count_brute(pts, _EDGES))


def _run(code: str, **env):
    full_env = {**os.environ, "PYTHONPATH": SRC, **env}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=full_env,
                          timeout=120)


PORT_MODULES = ("persist.format", "training.optimizer", "training.step",
                "training.checkpoint", "models.moe", "models.ssm", "models.rglru",
                "models.frontends", "launch.train", "examples.train_lm",
                "examples.knnlm_serve", "roofline.calibrate", "configs.shapes",
                "launch.dryrun", "launch.perf", "examples.quickstart",
                "examples.outlier_detection")


def test_port_imports_neither_jax_nor_repro():
    """Every module of ``repro_torch`` imported (``pkgutil.walk_packages``,
    the training, family and example modules among them) brings in neither
    jax, ``repro`` nor ``ml_dtypes``; ``chip_smoke.py`` names none of them
    in any import."""
    import ast

    out = _run("""
        import importlib, pkgutil, sys
        import repro_torch.api, repro_torch.core, repro_torch.kernels.ops
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
               or m == "repro" or m.startswith("repro.")]
        print("MODULES", len(names), sorted(names))
        print("BAD", bad)
    """)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    for name in PORT_MODULES:
        assert f"'repro_torch.{name}'" in out.stdout, name
    tree = ast.parse(open(os.path.join(SRC, "..", "chip_smoke.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro", "ml_dtypes"), name


def _load_script(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("d", [10, 30])
def test_main_cell_time_data_is_chip_smokes(d):
    """``scripts/main_cell_time.py`` makes its own copy of ``chip_smoke.py``'s
    main / wide cell data (so that it runs from an older tree's root): the
    two give the same arrays at a seed, a shift and d."""
    root = os.path.join(SRC, "..")
    smoke = _load_script(os.path.join(root, "chip_smoke.py"))
    timer = _load_script(os.path.join(root, "scripts", "main_cell_time.py"))
    for seed in (0, 3):
        want = smoke.main_data(seed, 14, d=d)
        got = timer.mixture_data(seed, 14, d)
        assert want[0].shape == (1024, d) and want[1].shape == (64, d)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_build_without_card_and_without_cpu_device_raises():
    out = _run("""
        import numpy as np
        from repro_torch.api import KNNIndex
        try:
            KNNIndex.build(np.zeros((5000, 4), np.float32))
        except RuntimeError as e:
            print("RAISED", e)
    """, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout and "torch.device('cpu')" in out.stdout


# --------------------------------------------------------------------------
# measured-cost calibration (tests/test_api.py TestCalibration, both packages)
# --------------------------------------------------------------------------
def _cal_pair(**kw):
    """The same ``Calibration`` in both packages (tests/test_api.py's base)."""
    from repro_torch.api import Calibration

    base = dict(h2d_gbps=10.0, h2d_latency_s=50e-6, round_s=5e-3,
                engine_qps={"chunked": 2500.0, "host": 600.0}, source="test")
    base.update(kw)
    return Calibration(**base), jax_api.Calibration(**base)


def _calibrated_reasons(p, mask: bool):
    import re

    rs = [r for r in p.reasons if "calibrat" in r or "measured" in r]
    return [re.sub(r"\d+(\.\d+)?", "#", r) for r in rs] if mask else rs


def _plan_both(cal, **kw):
    """The port's plan on one CPU slot and the reference's on one device,
    with the same calibration pair (or the same non-pair argument); the
    engine, n_chunks, starvation deadline, ``calibrated`` and the reasons
    that cite a calibration must be equal.  The port stores rows unpadded
    (the reference pads d to a multiple of 8), so where d is not such a
    multiple the byte counts in the reasons differ and their words must
    not."""
    pc, rc = cal if isinstance(cal, tuple) else (cal, cal)
    port = plan(devices=CPU, calibration=pc, **kw)
    ref = jax_api.plan(devices=[object()], calibration=rc, **kw)
    for f in ("engine", "n_chunks", "starvation_deadline", "calibrated", "crossover_batch"):
        assert getattr(port, f) == getattr(ref, f), f
    mask = kw["d"] % 8 != 0
    assert _calibrated_reasons(port, mask) == _calibrated_reasons(ref, mask)
    return port, ref


class TestCalibration:
    """Measured-cost planning: a Calibration turns rule-based decisions
    into calibrated ones, in both packages alike."""

    def test_uncalibrated_plan_defaults(self):
        p, _ = _plan_both(None, n=50_000, d=8, m=50_000)
        assert not p.calibrated and p.starvation_deadline >= 1

    def test_calibrated_engine_choice_shows_numbers(self):
        p, _ = _plan_both(_cal_pair(), n=50_000, d=8, m=50_000)
        assert p.calibrated and p.engine == "chunked"   # 2500 q/s beats 600 q/s
        assert any("calibrated engine choice" in r and "2500" in r for r in p.reasons)

    def test_calibrated_choice_can_flip_engine(self):
        p, _ = _plan_both(_cal_pair(engine_qps={"chunked": 100.0, "host": 900.0}),
                          n=50_000, d=8, m=50_000)
        assert p.engine == "host"

    @pytest.mark.parametrize("d", [8, 10])
    def test_calibrated_deadline_from_cost_ratio(self, d):
        n = 200_000
        h = plan(n, d, devices=CPU).height
        budget = estimate_slab_bytes(n, d, h) // 3
        rbudget = jax_api.estimate_slab_bytes(n, d, h) // 3
        for cal, want in ((dict(h2d_gbps=0.001, round_s=1e-3), 16),
                          (dict(h2d_gbps=1000.0, round_s=5e-3), 1)):
            pc, rc = _cal_pair(**cal)
            port = plan(n, d, k=10, devices=CPU, memory_budget=budget, calibration=pc)
            ref = jax_api.plan(n, d, k=10, devices=[object()], memory_budget=rbudget,
                               calibration=rc)
            assert port.starvation_deadline == ref.starvation_deadline == want
            assert (port.engine, port.n_chunks, port.calibrated) == (
                ref.engine, ref.n_chunks, ref.calibrated)
            assert _calibrated_reasons(port, d % 8 != 0) == _calibrated_reasons(ref, d % 8 != 0)
            assert any("starvation deadline" in r for r in port.reasons)

    @pytest.mark.parametrize("d", [8, 10])
    def test_calibrated_chunk_note_shows_copy_cost(self, d):
        n = 200_000
        h = plan(n, d, devices=CPU).height
        pc, rc = _cal_pair()
        port = plan(n, d, k=10, devices=CPU, memory_budget=estimate_slab_bytes(n, d, h) // 3,
                    calibration=pc, precision="fp32")
        ref = jax_api.plan(n, d, k=10, devices=[object()],
                           memory_budget=jax_api.estimate_slab_bytes(n, d, h) // 3,
                           calibration=rc, precision="fp32")
        assert port.n_chunks == ref.n_chunks > 1
        assert _calibrated_reasons(port, d % 8 != 0) == _calibrated_reasons(ref, d % 8 != 0)
        assert any("calibrated chunk copy" in r and "GB/s" in r for r in port.reasons)

    def test_partial_calibration_is_harmless(self):
        from repro_torch.api import Calibration

        p, _ = _plan_both((Calibration(source="empty"), jax_api.Calibration(source="empty")),
                          n=50_000, d=8, m=50_000)
        assert p.calibrated and p.engine == "chunked" and p.starvation_deadline >= 1

    def test_load_roundtrip(self, tmp_path):
        """``load`` reads the port's own file names, with the reference's
        keys, as the reference reads its own."""
        import json

        from repro_torch.api import Calibration

        files = {"copy_cost": {"h2d_gbps": 12.5, "h2d_latency_s": 1e-5, "round_s": 4e-3},
                 "engine": {"shape": {"m": 2000}, "chunked_s": 0.8, "host_s": 3.2,
                            "chunked_qps": 2500.0}}
        (tmp_path / "port").mkdir()
        (tmp_path / "ref").mkdir()
        for name, data in files.items():
            (tmp_path / "port" / f"BENCH_torch_{name}.json").write_text(json.dumps(data))
            (tmp_path / "ref" / f"BENCH_{name}.json").write_text(json.dumps(data))
        cal = Calibration.load(root=str(tmp_path / "port"))
        rcal = jax_api.Calibration.load(root=str(tmp_path / "ref"))
        for f in ("h2d_gbps", "h2d_latency_s", "round_s", "engine_qps", "build_pps",
                  "dynamic_crossover", "dynamic_measured"):
            assert getattr(cal, f) == getattr(rcal, f), f
        assert cal.engine_qps["host"] == pytest.approx(2000 / 3.2)
        assert cal.source == "BENCH_torch_copy_cost.json+BENCH_torch_engine.json"

    def test_load_reads_only_the_ports_files(self, tmp_path):
        """A directory with only the reference's files (another machine's
        numbers) gives no calibration, nor does a missing one."""
        import json

        from repro_torch.api import Calibration

        for name in ("copy_cost", "engine", "dynamic"):
            (tmp_path / f"BENCH_{name}.json").write_text(json.dumps({"h2d_gbps": 1.0}))
        assert Calibration.load(root=str(tmp_path)) is None
        assert Calibration.load(root=str(tmp_path / "nowhere")) is None

    def test_stale_calibration_warns_and_lands_in_reasons(self):
        pc, rc = _cal_pair(age_s=10 * 86400.0)
        assert pc.stale and rc.stale
        with pytest.warns(UserWarning, match="days old"):
            p, _ = _plan_both((pc, rc), n=50_000, d=8, m=50_000)
        assert any("calibration stale" in r for r in p.reasons) and p.calibrated

    def test_fresh_calibration_does_not_warn(self):
        import warnings as _warnings

        with _warnings.catch_warnings():
            _warnings.simplefilter("error")
            p, _ = _plan_both(_cal_pair(age_s=3600.0), n=50_000, d=8, m=50_000)
        assert not any("stale" in r for r in p.reasons)

    def test_load_derives_age_from_file_mtime(self, tmp_path):
        import json
        import time

        from repro_torch.api import CALIBRATION_STALE_S, Calibration

        assert CALIBRATION_STALE_S == jax_api.CALIBRATION_STALE_S
        cc = tmp_path / "BENCH_torch_copy_cost.json"
        cc.write_text(json.dumps({"h2d_gbps": 10.0, "round_s": 1e-3}))
        old = time.time() - (CALIBRATION_STALE_S + 86400)
        os.utime(cc, (old, old))
        cal = Calibration.load(root=str(tmp_path))
        assert cal.age_s > CALIBRATION_STALE_S and cal.stale and cal.slow_stale
        os.utime(cc, None)
        assert not Calibration.load(root=str(tmp_path)).stale

    @pytest.mark.parametrize("crossover", [4096, None])
    def test_load_reads_dynamic_bench(self, tmp_path, crossover):
        """A measured crossover overrides the dynamic engine's model; a
        measured None (batch-dynamic won at every size) pins none."""
        import json

        from repro_torch.api import Calibration

        data = json.dumps({"build_pps": 1e6, "crossover_batch": crossover})
        (tmp_path / "BENCH_torch_dynamic.json").write_text(data)
        (tmp_path / "BENCH_dynamic.json").write_text(data)
        cal = Calibration.load(root=str(tmp_path))
        rcal = jax_api.Calibration.load(root=str(tmp_path))
        assert cal.dynamic_measured and cal.dynamic_crossover == crossover
        assert "BENCH_torch_dynamic.json" in cal.source
        port = plan(50_000, 8, devices=CPU, mutable=True, calibration=cal)
        ref = jax_api.plan(50_000, 8, devices=[object()], mutable=True, calibration=rcal)
        assert port.crossover_batch == ref.crossover_batch == crossover
        mut = [r for r in port.reasons if r.startswith("mutable: dynamic engine")]
        rmut = [r for r in ref.reasons if r.startswith("mutable: dynamic engine")]
        assert [r.replace("BENCH_torch_", "BENCH_") for r in mut] == rmut

    def test_spec_carries_calibration_through_facade(self):
        pts, q = _data(6000, 64, 6, seed=9)
        pc, _ = _cal_pair()
        idx = KNNIndex.build(pts, IndexSpec(engine="chunked", height=4, calibration=pc,
                                            devices=CPU))
        assert idx.plan.calibrated
        dists, ids = idx.query(q, k=5)
        bd, _ = knn_brute(q, pts, 5, device="cpu")
        np.testing.assert_allclose(dists, bd, rtol=1e-4, atol=1e-4)

    def test_refresh_remeasures_h2d_over_base(self):
        from repro_torch.api import Calibration

        base = Calibration(h2d_gbps=0.001, round_s=5e-3, engine_qps={"chunked": 2500.0},
                           age_s=30 * 86400.0, source="old-bench")
        cal = Calibration.refresh(base, device=torch.device("cpu"))
        assert cal.h2d_gbps > 0.001 and cal.h2d_latency_s >= 0.0
        assert not cal.stale and cal.age_s == 0.0
        assert cal.round_s == 5e-3 and cal.engine_qps == {"chunked": 2500.0}
        assert cal.source == "old-bench+inline-refresh"

    def test_plan_refresh_string(self, tmp_path, monkeypatch):
        """``calibration="refresh"`` with no calibration files measures the
        copy rate on the first slot's device; any other string raises."""
        import warnings as _warnings

        from repro_torch.api import planner as planner_mod

        monkeypatch.setattr(planner_mod.Calibration, "load",
                            classmethod(lambda cls, root=None: None))
        with _warnings.catch_warnings():
            _warnings.simplefilter("error", UserWarning)
            p = plan(50_000, 8, m=50_000, devices=CPU, calibration="refresh")
        assert p.calibrated
        assert any(r.startswith("calibration auto-refresh: no bench files found")
                   for r in p.reasons)
        with pytest.raises(ValueError, match="refresh"):
            plan(50_000, 8, devices=CPU, calibration="reload")


# --------------------------------------------------------------------------
# the examples (examples/quickstart.py, examples/outlier_detection.py)
# --------------------------------------------------------------------------
def test_quickstart_example_matches_reference():
    """``repro_torch.examples.quickstart`` at 20000 points and 2000 queries
    on the CPU against the reference example's calls at that size: the
    same answers, device-resident and under a third of the budget."""
    from repro.data.pipeline import PointCloud as RefCloud
    from repro_torch.examples import quickstart

    got = quickstart.main(["--device", "cpu", "--n", "20000", "--m", "2000"])
    pc = RefCloud(20000, 10, seed=0)
    points, queries = pc.points(), pc.queries(2000)
    index = jax_api.KNNIndex.build(points, height=7)
    rd, ri = index.query(queries, k=10)
    budget = index.resident_bytes() // 3
    chunked = jax_api.KNNIndex.build(points, spec=jax_api.IndexSpec(height=7,
                                                                    memory_budget=budget))
    cd, ci = chunked.query(queries[:2000], k=10)
    _assert_same_answers(SimpleNamespace(dists=got["dists"], idx=got["idx"]), rd, ri,
                         points, queries)
    _assert_same_answers(SimpleNamespace(dists=got["chunked_dists"], idx=got["chunked_idx"]),
                         cd, ci, points, queries[:2000])
    assert got["recall"] == 1.0
    assert (got["engine"], got["chunked_engine"]) == (index.engine_name, chunked.engine_name)


def test_outlier_detection_example_matches_reference():
    """``repro_torch.examples.outlier_detection`` at 6000 sources (height 6)
    on the CPU against the reference example's calls on the same catalog:
    the same outliers flagged; the port's neighbor counts are the exact
    (float64) ones, and the reference's differ from them only by pairs
    within its decomposed fp32 form's rounding of r (|d^2 - r^2| <= 4 eps
    (|q|^2 + |x|^2)); the port's radius is the direct fp32 form."""
    from repro_torch.examples import outlier_detection

    n, r = 6000, 0.02
    got = outlier_detection.main(["--device", "cpu", "--n", str(n), "--height", "6"])
    data = outlier_detection.catalog(n)
    index = jax_api.KNNIndex.build(data, spec=jax_api.IndexSpec(op="radius", height=6,
                                                                m_hint=len(data)))
    indptr, ids, dists = index.radius(data, r)
    want = np.diff(indptr) - 1
    rank = np.argsort(want, kind="stable")
    assert got["flagged"] == set(rank[:outlier_detection.N_ANOM].tolist()) == set(
        range(n, n + outlier_detection.N_ANOM))
    x = data.astype(np.float64)
    sq = (x ** 2).sum(1)
    eps = np.finfo(np.float32).eps
    for lo in range(0, len(x), 1024):
        d2 = ((x[lo:lo + 1024, None, :] - x[None]) ** 2).sum(-1)
        exact = (d2 <= r * r).sum(1) - 1
        np.testing.assert_array_equal(got["counts"][lo:lo + 1024], exact)
        near = (np.abs(d2 - r * r) <= 4 * eps * (sq[lo:lo + 1024, None] + sq[None])).sum(1)
        assert (np.abs(want[lo:lo + 1024] - exact) <= near).all()
