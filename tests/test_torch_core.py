"""repro_torch.core vs the JAX reference (repro.core), on the CPU.

Same numpy inputs through both packages.  The tree build, traversal, work
plan, compaction ladder and chunk streaming only move integers and copy
values, so they must agree exactly; the engine's answers agree up to ties
(indices) and rtol 1e-5 (distances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import traversal as jax_traversal
from repro.core.chunked import ChunkedLeafStore as JaxStore
from repro.core.chunked_jit import compaction_ladder as jax_ladder
from repro.core.jitsearch import _build_plan as jax_build_plan
from repro.core.lazysearch import BufferKDTree as JaxBufferKDTree
from repro.core.quantize import quantize_slabs as jax_quantize_slabs
from repro.core.toptree import build_top_tree as jax_build_top_tree
from repro.core.toptree import tree_to_arrays as jax_tree_to_arrays
from repro_torch.core import traversal
from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.chunked_jit import (
    ChunkResidentEngine,
    chunk_round_cache_size,
    compaction_ladder,
)
from repro_torch.core.jitsearch import _build_plan
from repro_torch.core.lazysearch import FP32_OVERFETCH, BufferKDTree
from repro_torch.core.quantize import quantize_slabs
from repro_torch.core.toptree import (
    build_top_tree,
    default_buffer_size,
    suggest_height,
    tree_from_arrays,
    tree_to_arrays,
)

CPU = torch.device("cpu")
TREE_FIELDS = ("split_dim", "split_val", "leaf_start", "leaf_end", "points",
               "orig_idx", "points_padded")


def _assert_trees_equal(a, b):
    assert (a.height, a.n, a.d, a.leaf_pad) == (b.height, b.n, b.d, b.leaf_pad)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("n,d,h,rule", [
    (1000, 3, 4, "cyclic"), (777, 8, 6, "cyclic"), (2048, 5, 3, "widest"),
])
def test_top_tree_identical(n, d, h, rule):
    pts = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    _assert_trees_equal(build_top_tree(pts, h, dim_rule=rule),
                        jax_build_top_tree(pts, h, dim_rule=rule))


def test_tree_carried_from_reference_arrays():
    pts = np.random.default_rng(1).normal(size=(900, 6)).astype(np.float32)
    ref = jax_build_top_tree(pts, 5)
    arrays = jax_tree_to_arrays(ref, include_derived=True)
    carried = tree_from_arrays(arrays["points"], arrays, height=ref.height,
                               leaf_pad=ref.leaf_pad)
    _assert_trees_equal(carried, ref)
    # without the derived slab the padded view is rebuilt identically
    slim = {k: v for k, v in tree_to_arrays(carried).items()}
    rebuilt = tree_from_arrays(ref.points, slim, height=ref.height, leaf_pad=ref.leaf_pad)
    _assert_trees_equal(rebuilt, ref)
    assert suggest_height(10**6) == 7 and default_buffer_size(12) == 4096


def _random_tree(h, d=4, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=((1 << h) * 6, d)).astype(np.float32)
    return build_top_tree(pts, h), rng


@pytest.mark.parametrize("h", [3, 6, 9])
def test_advance_leaf_sequences_match_reference(h):
    """Fixed 2h+1 masked steps visit the same leaves, in the same order, as
    the reference's while_loop (radii shrink round by round, as the
    running k-th distance does)."""
    tree, rng = _random_tree(h, seed=h)
    m = 64
    q = rng.normal(size=(m, tree.d)).astype(np.float32)
    radius = np.full((m,), np.inf, np.float32)
    fl = tree.first_leaf_heap
    sd_t, sv_t = torch.from_numpy(tree.split_dim).long(), torch.from_numpy(tree.split_val)
    st_t = traversal.init_state(m, CPU)
    st_j = jax_traversal.init_state(m)
    for _ in range(500):
        leaf_t, st_t = traversal.advance(st_t, torch.from_numpy(q), torch.from_numpy(radius),
                                         sd_t, sv_t, first_leaf_heap=fl)
        leaf_j, st_j = jax_traversal.advance(st_j, jnp.asarray(q), jnp.asarray(radius),
                                             jnp.asarray(tree.split_dim),
                                             jnp.asarray(tree.split_val),
                                             first_leaf_heap=fl)
        np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
        np.testing.assert_array_equal(st_t.node.numpy(), np.asarray(st_j.node))
        np.testing.assert_array_equal(st_t.fromc.numpy(), np.asarray(st_j.fromc))
        if (leaf_t < 0).all():
            break
        st_t = traversal.exit_leaf(st_t, fl)
        st_j = jax_traversal.exit_leaf(st_j, fl)
        live = np.isfinite(radius)
        radius = np.where(live, radius * 0.7, rng.uniform(0.2, 1.5, size=m)).astype(np.float32)
    else:
        pytest.fail("traversal did not finish")


@pytest.mark.parametrize("m,tq,n_leaves,seed", [
    (100, 8, 16, 0), (257, 16, 5, 1), (64, 64, 32, 2), (33, 4, 7, 3),
])
def test_build_plan_matches_reference(m, tq, n_leaves, seed):
    rng = np.random.default_rng(seed)
    leaf = rng.integers(-1, n_leaves, size=m).astype(np.int32)
    leaf[rng.random(m) < 0.3] = -1
    ul, uq, nu = _build_plan(torch.from_numpy(leaf), tq, n_leaves)
    jl, jq, jn = jax_build_plan(jnp.asarray(leaf), tq, n_leaves)
    np.testing.assert_array_equal(ul.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(uq.numpy(), np.asarray(jq))
    assert int(nu) == int(jn)
    assert ul.dtype == uq.dtype == nu.dtype == torch.int32


def test_compaction_ladder_matches_reference():
    for m in (1, 31, 32, 100, 127, 128, 129, 1000, 4096, 10**6 + 3):
        assert compaction_ladder(m) == jax_ladder(m), m


@pytest.mark.parametrize("n_chunks,uniform", [(1, True), (3, True), (4, False)])
def test_chunked_store_stream_matches_reference(n_chunks, uniform):
    rng = np.random.default_rng(n_chunks)
    slabs = rng.normal(size=(10, 8, 8)).astype(np.float32)
    port = ChunkedLeafStore(slabs, n_chunks, device=CPU, uniform=uniform)
    ref = JaxStore(slabs, n_chunks, uniform=uniform, leaf_sizes=np.full(10, 8))
    np.testing.assert_array_equal(port.chunk_lo, ref.chunk_lo)
    np.testing.assert_array_equal(port.chunk_hi, ref.chunk_hi)
    np.testing.assert_array_equal(port.chunk_of_leaf(np.arange(10)),
                                  ref.chunk_of_leaf(np.arange(10)))
    for visit in ([0], list(range(n_chunks)), list(range(n_chunks))[::-1], [0, 0]):
        got = [(j, lo, buf.numpy().copy()) for j, buf, lo in port.stream(visit)]
        want = [(j, lo, np.asarray(buf)) for j, buf, lo in ref.stream(visit)]
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2], w[2])
        assert port.copies == ref.copies
    assert port.resident_bytes() == ref.resident_bytes()


@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_quantize_slabs_match_reference(precision):
    rng = np.random.default_rng(4)
    slabs = rng.normal(size=(6, 16, 8)).astype(np.float32)
    sizes = rng.integers(1, 17, size=6)
    a = quantize_slabs(slabs, precision, sizes)
    b = jax_quantize_slabs(slabs, precision, sizes)
    for f in ("codes", "scale", "offset", "dead"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.eps == b.eps


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_engine_schedule_matches_reference(n_chunks):
    """Same tree, same queries: the same rounds, chunk visits, units and
    compactions as the reference's chunked engine, and the same answers.
    The port's fp32 engine selects ``FP32_OVERFETCH`` candidates beyond k
    (ROADMAP Queue 3), so the reference runs at that width too; every row
    is proven by the first pass here, so the port runs one pass."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(3000, 6)).astype(np.float32)
    q = rng.normal(size=(400, 6)).astype(np.float32)
    port = BufferKDTree(pts, height=5, n_chunks=n_chunks, device=CPU, tile_q=64)
    ref = JaxBufferKDTree(pts, height=5, n_chunks=n_chunks, tile_q=64)
    pd, pi = port.query(q, 8)
    rd, ri = ref.query(q, 8 + FP32_OVERFETCH)
    rd, ri = rd[:, :8], ri[:, :8]
    assert (port.stats.refined_rows, port.stats.exact_rows) == (0, 0)
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-6)
    assert (pi == ri).mean() > 0.999
    for f in ("iterations", "chunk_rounds", "units_scanned", "compactions",
              "steady_rounds", "tail_rounds", "queries_advanced"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.stats.chunk_copies == ref.store.copies


def test_round_shapes_bounded_and_on_retire_reports_each_row_once():
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(2000, 4)).astype(np.float32)
    index = BufferKDTree(pts, height=4, n_chunks=2, device=CPU)
    index.warm(300, 5)
    after_warm = chunk_round_cache_size()
    for m in (300, 300):
        index.query(rng.normal(size=(m, 4)).astype(np.float32), 5)
    assert chunk_round_cache_size() == after_warm   # warm touched every shape
    seen = []

    def on_retire(rows, d2, gi):
        seen.append((rows.copy(), d2.copy(), gi.copy()))

    q = torch.from_numpy(rng.normal(size=(300, 4)).astype(np.float32))
    d2, gi, info = index._engine.run(q, 5, index.engine_tile_q,
                                     index.buffer_size, on_retire=on_retire)
    rows = np.concatenate([s[0] for s in seen])
    assert np.array_equal(np.sort(rows), np.arange(300))
    for r, d, g in seen:
        np.testing.assert_array_equal(d, d2[r])
        np.testing.assert_array_equal(g, gi[r])
    assert info["early_retired"] > 0


def test_engine_backend_follows_the_store_device():
    """Built with no backend named, the round loop runs what the store's
    device runs (the plain version on the CPU); naming the kernel for a
    CPU store raises instead of running something else."""
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(600, 5)).astype(np.float32)
    index = BufferKDTree(pts, height=3, device=CPU)
    eng = index._engine
    bare = ChunkResidentEngine(eng.store, eng._split_dim, eng._split_val,
                               eng._leaf_start, eng._leaf_size,
                               eng.first_leaf_heap)
    assert eng.backend == bare.backend == "ref"
    assert index.store.host.shape[2] == 5      # slabs hold no pad columns
    with pytest.raises(ValueError, match="cannot run on cpu"):
        BufferKDTree(pts, height=3, device=CPU, backend="cuda")
