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
    BudgetError,
    IndexSpec,
    KNNIndex,
    MutabilityError,
    OpUnsupported,
    StreamingUnsupported,
    available_engines,
    estimate_slab_bytes,
    get_engine,
    knn_brute,
    knn_round_cache_size,
    plan,
)
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
    with pytest.raises(NotImplementedError, match="item 18"):
        plan(50_000, 8, devices=CPU * 2)
    with pytest.raises(OpUnsupported, match="item 13"):
        plan(50_000, 8, devices=CPU, op="radius")
    with pytest.raises(KeyError, match="not yet ported"):
        plan(50_000, 8, devices=CPU, engine="forest")
    assert sorted(available_engines()) == ["brute", "chunked", "streaming"]
    assert available_engines(op="kde") == {}
    assert get_engine("chunked").caps.ops == frozenset({"knn"})


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
    for call in (lambda: index.radius(q, 0.5), lambda: index.kde(q, 0.1),
                 lambda: index.pair_count([0.0, 1.0])):
        with pytest.raises(OpUnsupported):
            call()
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
    with pytest.raises(NotImplementedError, match="item 17"):
        BufferKDTree(pts, height=4, engine="host", device=torch.device("cpu"))


def _run(code: str, **env):
    full_env = {**os.environ, "PYTHONPATH": SRC, **env}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=full_env,
                          timeout=120)


def test_port_imports_neither_jax_nor_repro():
    out = _run("""
        import sys
        import repro_torch.api, repro_torch.core, repro_torch.kernels.ops
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro.")]
        print("BAD", bad)
    """)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


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
