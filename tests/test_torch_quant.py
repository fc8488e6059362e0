"""repro_torch's budgeted leaf store (fp16 / int8 codes) vs the JAX reference.

Same numpy inputs through both packages, on the CPU.  Each test names the
``repro`` function it holds the port against.  The store's codes, padding
and metadata only move values, so they must agree exactly where the two
layouts coincide (d a multiple of 8: the reference pads features to one,
the port keeps the points' width).  Scans and answers compare distances at
rtol 1e-5 and indices permutation-aware; indices against brute force are
bit-identical, the contract of ``tests/test_quantized.py``.

The reference dequantizes int8 codes in a jitted round, where XLA on the
CPU fuses ``code * scale + offset`` into one FMA; the port's plain version
and its CUDA kernel round the product and the sum separately (the kernel
uses ``__fmul_rn`` / ``__fadd_rn`` to match torch's two operations).  The
two differ in the last ulp of some coordinates, hence the tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core.chunked import ChunkedLeafStore as JaxStore
from repro.core.chunked_jit import _chunk_round as jax_chunk_round
from repro.core.chunked_jit import _initial_advance as jax_initial_advance
from repro.core.lazysearch import BufferKDTree as JaxBufferKDTree
from repro.core.quantize import quantize_slabs as jax_quantize_slabs
from repro.kernels import ops as jax_kops
from repro.kernels.ref import leaf_scan_ref as jax_leaf_scan_ref
from repro_torch.api import IndexSpec, KNNIndex, knn_brute
from repro_torch.core.chunked import ChunkedLeafStore
from repro_torch.core.chunked_jit import _chunk_round, _initial_advance
from repro_torch.core.lazysearch import FP32_OVERFETCH, BufferKDTree
from repro_torch.core.quantize import (
    QUANT_OVERFETCH,
    pack_dead,
    quantize_slabs,
    unpack_dead,
)
from repro_torch.kernels import knn_scan, ops

CPU = torch.device("cpu")
CPUS = (CPU,)
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


def _slabs(n_leaves, l_pad, d, seed):
    """Random slabs with ragged leaf sizes; rows past a leaf's size hold
    PAD_COORD, as ``build_top_tree`` leaves them."""
    rng = np.random.default_rng(seed)
    slabs = rng.standard_normal((n_leaves, l_pad, d)).astype(np.float32)
    sizes = rng.integers(1, l_pad + 1, size=n_leaves)
    slabs[np.arange(l_pad)[None, :] >= sizes[:, None]] = ops.PAD_COORD
    return slabs, sizes


# ---------------------------------------------------------------------------
# quantize.py and the store
# ---------------------------------------------------------------------------
def test_pack_dead_is_reference_packbits_msb_first():
    """``pack_dead`` against ``repro.core.chunked.ChunkedLeafStore.device_meta``'s
    ``np.packbits(dead, axis=1)``; ``unpack_dead`` against the reference
    round's shift-and-mask unpack."""
    rng = np.random.default_rng(0)
    dead = rng.random((5, 21)) < 0.3
    bits = pack_dead(dead)
    np.testing.assert_array_equal(bits, np.packbits(dead, axis=1))
    assert bits[0, 0] >> 7 == dead[0, 0]              # row 0 is the high bit
    back = unpack_dead(torch.from_numpy(bits), 21)
    ref = ((jnp.asarray(bits)[:, :, None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref).reshape(5, -1)[:, :21] == 1)
    np.testing.assert_array_equal(back.numpy(), dead)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_store_matches_reference(precision, n_chunks):
    """Codes, uniform padding, packed dead mask, streamed chunks and byte
    counts against ``repro.core.chunked.ChunkedLeafStore`` at d = 8."""
    slabs, sizes = _slabs(10, 24, 8, seed=n_chunks)
    port = ChunkedLeafStore(slabs, n_chunks, device=CPU, uniform=True,
                            precision=precision, leaf_sizes=sizes)
    ref = JaxStore(slabs, n_chunks, uniform=True, precision=precision,
                   leaf_sizes=sizes)
    assert port.quantized and port.affine == ref.affine == (precision == "int8")
    assert port.host.dtype == {"fp16": torch.float16, "int8": torch.uint8}[precision]
    np.testing.assert_array_equal(port.host.numpy(), ref.host)   # incl. padding
    np.testing.assert_array_equal(port.dead, ref.dead)
    np.testing.assert_array_equal(port.q_scale, ref.q_scale)
    np.testing.assert_array_equal(port.q_offset, ref.q_offset)
    assert port.quant_eps == ref.quant_eps
    sc, of, dead = port.device_meta()
    rsc, rof, rdead = ref.device_meta()
    np.testing.assert_array_equal(dead.numpy(), np.asarray(rdead))
    if port.affine:
        np.testing.assert_array_equal(sc.numpy(), np.asarray(rsc))
        np.testing.assert_array_equal(of.numpy(), np.asarray(rof))
    else:
        assert sc is None and of is None
    np.testing.assert_array_equal(port.chunk_lo, ref.chunk_lo)
    np.testing.assert_array_equal(port.chunk_hi, ref.chunk_hi)
    visit = list(range(n_chunks))[::-1] + [0]
    got = [(j, lo, buf.numpy().copy()) for j, buf, lo in port.stream(visit)]
    want = [(j, lo, np.asarray(buf)) for j, buf, lo in ref.stream(visit)]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])
    assert port.copies == ref.copies
    assert port.meta_bytes() == ref.meta_bytes() > 0
    assert port.resident_bytes() == ref.resident_bytes()
    assert port.chunk_bytes == ref.chunk_bytes


def test_store_fp32_has_no_meta_and_later_items_raise():
    """An fp32 store matches ``repro.core.chunked.ChunkedLeafStore``'s byte
    counts with no metadata and has no codes to snapshot; an int8 store's
    ``quantized_state`` is the reference's, and a store adopting it holds
    the same codes; ``kill_rows`` marks the rows dead in the mask and in
    its resident packed copy (``tests/test_torch_dynamic.py`` holds it
    against the reference's)."""
    slabs, sizes = _slabs(6, 16, 8, seed=5)
    port = ChunkedLeafStore(slabs, 2, device=CPU, uniform=True, leaf_sizes=sizes)
    ref = JaxStore(slabs, 2, uniform=True, leaf_sizes=sizes)
    assert not port.quantized and port.quant_eps == 0.0
    assert port.meta_bytes() == ref.meta_bytes() == 0
    assert port.resident_bytes() == ref.resident_bytes()
    with pytest.raises(ValueError, match="no dequantize metadata"):
        port.device_meta()
    with pytest.raises(ValueError, match="no codes"):
        port.quantized_state()
    q8 = ChunkedLeafStore(slabs, 2, device=CPU, uniform=True, precision="int8",
                          leaf_sizes=sizes)
    qs = q8.quantized_state()
    ref_qs = JaxStore(slabs, 2, uniform=True, precision="int8",
                      leaf_sizes=sizes).quantized_state()
    for name in ("codes", "scale", "offset", "dead"):
        np.testing.assert_array_equal(getattr(qs, name), getattr(ref_qs, name), name)
    assert qs.eps == ref_qs.eps and qs.precision == "int8"
    again = ChunkedLeafStore(qs, 2, device=CPU, uniform=True)
    assert again.precision == "int8" and torch.equal(again.host, q8.host)
    with pytest.raises(ValueError, match="precision"):
        ChunkedLeafStore(slabs, 1, device=CPU, precision="bf16")
    assert not q8.dead[0, 0]
    q8.kill_rows(np.array([0]), np.array([0]))
    assert q8.dead[0, 0] and (q8.device_meta()[2][0, 0] & 0x80)


@pytest.mark.parametrize("d", [3, 6, 13])
def test_eps_at_unpadded_width(d):
    """``repro.core.quantize.quantize_slabs`` on rows padded to a multiple of
    8 against the port's unpadded rows: int8 is the same (pad columns have
    scale 0); fp16's ``_fp16_eps`` adds 2^-24 per pad column, so the port's
    eps is smaller by exactly that."""
    slabs, sizes = _slabs(7, 16, d, seed=d)
    d_pad = -(-d // 8) * 8
    padded = np.concatenate([slabs, np.zeros((7, 16, d_pad - d), np.float32)], -1)
    padded[slabs[..., 0] == ops.PAD_COORD] = ops.PAD_COORD
    for precision in ("fp16", "int8"):
        a = quantize_slabs(slabs, precision, sizes)
        b = jax_quantize_slabs(padded, precision, sizes)
        np.testing.assert_array_equal(a.codes, b.codes[..., :d])
        np.testing.assert_array_equal(a.dead, b.dead)
        if precision == "int8":
            assert a.eps == b.eps
            assert (b.scale[:, d:] == 0).all()
        else:
            pad_cols = (d_pad - d) * (2.0 ** -24) ** 2
            np.testing.assert_allclose(a.eps ** 2 + pad_cols, b.eps ** 2, rtol=1e-12)
            assert a.eps < b.eps


def test_dequantize_rounds_twice_where_the_reference_fuses():
    """The port's dequantize (``knn_scan.dequantize``, which the kernel
    repeats) rounds the product and the sum, like numpy; the reference's
    jitted round (``repro.core.chunked_jit._chunk_round``) lets XLA fuse them
    into one FMA on the CPU.  They agree within one ulp of the product or
    of the sum, whichever is larger (the product's rounding is what the
    fused form skips)."""
    slabs, sizes = _slabs(8, 64, 10, seed=3)
    qs = quantize_slabs(slabs, "int8", sizes)
    dead = torch.from_numpy(pack_dead(qs.dead))
    port = knn_scan.dequantize(torch.from_numpy(qs.codes), torch.from_numpy(qs.scale),
                               torch.from_numpy(qs.offset), dead).numpy()
    two = qs.codes.astype(np.float32) * qs.scale[:, None, :] + qs.offset[:, None, :]
    live = ~qs.dead
    np.testing.assert_array_equal(port[live], two[live])
    assert (port[qs.dead] == ops.PAD_COORD).all()
    fused = np.asarray(jax.jit(lambda c, s, o: c.astype(jnp.float32) * s[:, None, :]
                               + o[:, None, :])(qs.codes, qs.scale, qs.offset))
    prod = qs.codes.astype(np.float32) * qs.scale[:, None, :]
    ulp = np.spacing(np.maximum(np.abs(prod[live]), np.abs(fused[live])))
    assert (np.abs(port[live] - fused[live]) <= ulp).all()
    assert (port[live] != fused[live]).any()   # they do differ somewhere


# ---------------------------------------------------------------------------
# the plain leaf scan with codes
# ---------------------------------------------------------------------------
def _reference_round_dequantize(codes, scale, offset, dead_bits, affine):
    """The dequantize of ``repro.core.chunked_jit._chunk_round``'s body, on
    gathered slabs (jnp, as the reference runs it)."""
    bits = jnp.asarray(dead_bits)
    l_pad = codes.shape[1]
    dead_tile = ((bits[:, :, None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
                 ).reshape(bits.shape[0], -1)[:, :l_pad].astype(bool)
    slabs = jnp.asarray(codes).astype(jnp.float32)
    if affine:
        slabs = slabs * jnp.asarray(scale)[:, None, :] + jnp.asarray(offset)[:, None, :]
    return jnp.where(dead_tile[:, :, None], jnp.float32(jax_kops.PAD_COORD), slabs)


def _all_dists(q, x):
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    return np.maximum(np.sum(q * q, -1)[..., :, None]
                      - 2 * np.einsum("wqd,wld->wql", q, x)
                      + np.sum(x * x, -1)[..., None, :], 0.0)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("lp,d,k,seed", [
    (48, 8, 10, 0),
    (64, 10, 18, 1),       # the overfetched k of a k = 10 query
    (40, 3, 30, 2),        # k above most leaves' live rows: dead rows fill the tail
    (37, 13, 7, 3),        # L_pad not a multiple of 8: a partial mask byte
])
def test_plain_scan_with_codes_matches_reference_round(precision, lp, d, k, seed):
    """``knn_scan.leaf_scan_units_ref`` on codes against the reference
    round's dequantize followed by ``repro.kernels.ref.leaf_scan_ref``,
    with dead rows below the leaf size (marked as tombstones are)."""
    slabs, sizes = _slabs(6, lp, d, seed)
    qs = quantize_slabs(slabs, precision, sizes)
    rng = np.random.default_rng(seed)
    dead = qs.dead | (rng.random(qs.dead.shape) < 0.2)   # tombstones below the size
    bits = pack_dead(dead)
    qpad = rng.standard_normal((50, d)).astype(np.float32)
    unit_leaf = np.array([3, 0, 5, 3, 1], np.int32)
    unit_query = rng.integers(-1, 50, size=(5, 16)).astype(np.int32)
    affine = precision == "int8"
    meta = dict(dead=torch.from_numpy(bits))
    if affine:
        meta.update(scale=torch.from_numpy(qs.scale), offset=torch.from_numpy(qs.offset))
    pd, pi = ops.leaf_scan_units(
        torch.from_numpy(qpad), torch.from_numpy(qs.codes),
        torch.from_numpy(unit_leaf), torch.from_numpy(unit_query),
        torch.tensor(5, dtype=torch.int32), k=k, **meta)
    x = _reference_round_dequantize(qs.codes[unit_leaf], qs.scale[unit_leaf],
                                    qs.offset[unit_leaf], bits[unit_leaf], affine)
    q_tiles = np.where((unit_query >= 0)[..., None], qpad[np.clip(unit_query, 0, None)],
                       0.0).astype(np.float32)
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q_tiles), x, k=k)
    rd = np.asarray(rd)
    np.testing.assert_allclose(pd.numpy(), rd, **TOL)
    d_of_pi = np.take_along_axis(_all_dists(q_tiles, np.asarray(x)), pi.numpy().astype(np.int64), -1)
    np.testing.assert_allclose(d_of_pi, rd, **TOL)
    # every dead row sits behind every live row, in index order
    sel_dead = dead[unit_leaf[:, None, None], pi.numpy()]
    assert (np.diff(sel_dead.astype(int), axis=-1) >= 0).all()
    live_rows = (~dead[unit_leaf]).sum(1)
    want_dead = np.broadcast_to(np.maximum(k - live_rows, 0)[:, None], sel_dead.shape[:2])
    np.testing.assert_array_equal(sel_dead.sum(-1), want_dead)


def test_plain_scan_refuses_mismatched_meta():
    codes = torch.zeros((2, 16, 4), dtype=torch.uint8)
    args = (torch.zeros((4, 4)), codes, torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.int32), torch.tensor(1, dtype=torch.int32))
    dead = torch.zeros((2, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="dead-row mask"):
        knn_scan.leaf_scan_units_ref(*args, k=2)
    with pytest.raises(ValueError, match="scale and offset"):
        knn_scan.leaf_scan_units_ref(*args, k=2, dead=dead)
    with pytest.raises(ValueError, match="reads slabs"):
        knn_scan.leaf_scan_units_ref(args[0], codes.double(), *args[2:], k=2)


# ---------------------------------------------------------------------------
# one round of the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_chunk_round_with_codes_matches_reference(precision, n_chunks):
    """``_chunk_round`` on codes against ``repro.core.chunked_jit._chunk_round``
    with ``quant=True`` and backend ``ref``, round after round over every
    chunk: the same pending-leaf map and n_units, top-k within tolerance."""
    pts, q = _data(3000, 200, 8, seed=n_chunks)
    k = 10 + QUANT_OVERFETCH
    port = BufferKDTree(pts, height=5, n_chunks=n_chunks, device=CPU, tile_q=16,
                        precision=precision)
    ref = JaxBufferKDTree(pts, height=5, n_chunks=n_chunks, tile_q=16,
                          precision=precision)
    pe, re_ = port._engine, ref._engine
    assert port.store.quant_eps == ref.store.quant_eps > 0
    qsc, qof, qdd, qeps, quant, affine = re_._quant_args()
    assert quant and affine == (precision == "int8")

    qt = torch.from_numpy(q)
    leaf, node, fromc = _initial_advance(qt, pe._split_dim, pe._split_val,
                                         first_leaf_heap=pe.first_leaf_heap)
    jleaf, jnode, jfromc = jax_initial_advance(jnp.asarray(q), re_._split_dim,
                                               re_._split_val,
                                               first_leaf_heap=re_.first_leaf_heap)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    m = q.shape[0]
    knn_d = torch.full((m + 1, k), ops.INVALID_DIST)
    knn_i = torch.full((m + 1, k), -1, dtype=torch.int32)
    jd = jnp.full((m + 1, k), jax_kops.INVALID_DIST, jnp.float32)
    ji = jnp.full((m + 1, k), -1, jnp.int32)
    rounds = 0
    while (leaf >= 0).any() and rounds < 6:
        chunks = list(range(n_chunks))
        for (j, slab, lo), (_, jslab, jlo) in zip(port.store.stream(chunks),
                                                   ref.store.stream(chunks)):
            leaf, nu = _chunk_round(
                node, fromc, leaf, knn_d, knn_i, qt, slab, lo, pe._leaf_start,
                pe._leaf_size, pe._split_dim, pe._split_val, pe._meta, pe._qeps,
                k=k, tq=16, first_leaf_heap=pe.first_leaf_heap, backend="ref")
            jnode, jfromc, jleaf, jd, ji, jnu = jax_chunk_round(
                jnode, jfromc, jleaf, jd, ji, jnp.asarray(q), jslab, jnp.int32(jlo),
                re_._leaf_start, re_._leaf_size, re_._split_dim, re_._split_val,
                qsc, qof, qdd, qeps, k=k, tq=16, first_leaf_heap=re_.first_leaf_heap,
                ub=8, backend="ref", quant=True, affine=affine)
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
            assert int(nu) == int(jnu)
            # row m is the dump row every empty plan slot writes into
            np.testing.assert_allclose(knn_d[:m].numpy(), np.asarray(jd)[:m], **TOL)
            same = knn_i[:m].numpy() == np.asarray(ji)[:m]
            assert same.mean() > 0.999
        rounds += 1
    assert rounds > 1


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
def _budget_for(n, d, height, frac):
    return int(jax_api.estimate_slab_bytes(n, d, height) * frac)


@functools.lru_cache(maxsize=None)
def _reference_index(n, m, d, k, height, precision, budget):
    pts, q = _data(n, m, d, seed=n + d)
    spec = jax_api.IndexSpec(engine="chunked", height=height, k_hint=k, tile_q=64,
                             precision=precision, memory_budget=budget)
    index = jax_api.KNNIndex.build(pts, spec=spec)
    res = index.query(q, k=k)
    return res.dists, res.idx, index.plan, index.resident_bytes()


# (precision pinned, fraction of the fp32 slab as memory_budget, plan wanted)
FRONT_DOOR = [
    pytest.param("fp16", None, ("fp16", 1), id="fp16_pinned"),
    pytest.param("int8", None, ("int8", 1), id="int8_pinned"),
    pytest.param(None, 0.6, ("fp16", 1), id="budget_fp16"),
    pytest.param(None, 1 / 3, ("int8", 1), id="budget_int8_resident"),
    pytest.param(None, 1 / 12, ("int8", None), id="budget_int8_streamed"),
]


@pytest.mark.parametrize("precision,frac,want", FRONT_DOOR)
def test_knn_index_quantized_matches_reference_and_brute(precision, frac, want):
    """``KNNIndex`` at fp16 / int8, pinned or chosen by planner rule 4,
    against ``repro.api.KNNIndex`` (plan, resident bytes, answers) and
    against ``knn_brute`` (indices bit-identical)."""
    n, m, d, k, height = 6000, 64, 8, 10, 5
    pts, q = _data(n, m, d, seed=n + d)
    budget = None if frac is None else _budget_for(n, d, height, frac)
    ref_d, ref_i, ref_plan, ref_resident = _reference_index(
        n, m, d, k, height, precision, budget)
    spec = IndexSpec(engine="chunked", height=height, k_hint=k, tile_q=64,
                     precision=precision, memory_budget=budget, devices=CPUS)
    index = KNNIndex.build(pts, spec=spec)
    prec, n_chunks = want
    assert index.plan.precision == ref_plan.precision == prec
    assert index.plan.n_chunks == ref_plan.n_chunks
    if n_chunks is not None:
        assert index.plan.n_chunks == n_chunks
    else:
        assert index.plan.n_chunks >= 2
    assert index.resident_bytes() == ref_resident
    if budget is not None:
        assert index.resident_bytes() <= budget
    assert f"precision={prec}" in index.describe()
    res = index.query(q, k=k)
    bd, bi = knn_brute(q, pts, k, device="cpu")
    np.testing.assert_array_equal(res.idx, bi)
    np.testing.assert_array_equal(res.idx, ref_i)
    np.testing.assert_allclose(res.dists, bd, **TOL)
    np.testing.assert_allclose(res.dists, ref_d, **TOL)
    assert (res.stats.chunk_copies > 0) == (index.plan.n_chunks > 1)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_quantized_odd_width_and_k_above_leaf(precision):
    """As ``tests/test_quantized.py::TestQuantizedParity`` does for
    ``repro.api.KNNIndex``: d % 8 != 0, and k above a leaf's row count
    (selection reaches across leaves, the overfetch band still closes)."""
    pts, q = _data(6000, 48, 6, seed=11)
    res = KNNIndex.build(pts, IndexSpec(precision=precision, devices=CPUS)).query(q, 10)
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    np.testing.assert_array_equal(res.idx, bi)
    np.testing.assert_allclose(res.dists, bd, rtol=1e-4, atol=1e-4)
    pts, q = _data(2000, 24, 5, seed=12)
    index = KNNIndex.build(pts, IndexSpec(engine="chunked", height=7, precision=precision,
                                          devices=CPUS))
    k = 2 * -(-2000 // (1 << 7))
    res = index.query(q, k=k)
    bd, bi = knn_brute(q, pts, k, device="cpu")
    np.testing.assert_array_equal(res.idx, bi)
    np.testing.assert_allclose(res.dists, bd, rtol=1e-4, atol=1e-4)


def test_overfetch_clamped_to_n():
    """``BufferKDTree._engine_k`` as ``repro.core.lazysearch.BufferKDTree``'s:
    k + QUANT_OVERFETCH past n is clamped, and the answer stays exact; an
    fp32 store runs at k + FP32_OVERFETCH (the reference at k)."""
    pts, q = _data(260, 8, 4, seed=15)
    tree = BufferKDTree(pts, height=3, precision="int8", device=CPU)
    ref = JaxBufferKDTree(pts, height=3, precision="int8")
    for k in (1, 10, 252, 256):
        assert tree._engine_k(k) == ref._engine_k(k)
    assert tree._engine_k(256) == 260
    fp32 = BufferKDTree(pts, height=3, device=CPU)
    assert fp32._engine_k(10) == 10 + FP32_OVERFETCH
    assert fp32._engine_k(258) == 260
    d_, i_ = tree.query(q, k=256)
    bd, bi = knn_brute(q, pts, 256, device="cpu")
    np.testing.assert_array_equal(i_, bi)
    assert d_.shape == (8, 256)


def _ring_case(n_ring=60):
    """``n_ring`` points on a ring around the query, 1e-3 apart in radius,
    and 140 far points that stretch the leaves' int8 ranges: the
    quantization band (eps ~ 0.28) holds far more than QUANT_OVERFETCH ring
    points."""
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, n_ring)
    rad = 1.0 + np.arange(n_ring) * 1e-3
    ring = np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)
    far = rng.uniform(-100, 100, size=(140, 2))
    return np.concatenate([ring, far]).astype(np.float32), np.zeros((1, 2), np.float32)


def test_refine_repairs_the_reference_overfetch_miss():
    """``repro.api.KNNIndex`` at int8 keeps the first run's k + 8 candidates
    and here misses true neighbours; the port proves each row's answer
    (``BufferKDTree._certified``), runs unproven rows again with more
    candidates, and returns brute force's indices."""
    pts, q = _ring_case()
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    ref = jax_api.KNNIndex.build(pts, spec=jax_api.IndexSpec(
        engine="chunked", height=2, precision="int8")).query(q, 10)
    assert not np.array_equal(ref.idx, bi), "the reference no longer misses here"
    index = KNNIndex.build(pts, IndexSpec(engine="chunked", height=2, precision="int8",
                                          devices=CPUS))
    res = index.query(q, 10)
    np.testing.assert_array_equal(res.idx, bi)
    np.testing.assert_allclose(res.dists, bd, **TOL)
    assert res.stats.refined_rows == 1
    got = []
    stream = KNNIndex.build(pts, IndexSpec(engine="streaming", height=2, precision="int8",
                                           devices=CPUS))
    out = stream.query_stream(q, 10, on_complete=lambda r, d, i: got.append((r, i)))
    assert len(got) == 1 and got[0][0].tolist() == [0]
    np.testing.assert_array_equal(got[0][1], bi)
    np.testing.assert_array_equal(out.idx, bi)


def test_certificate_and_last_resort():
    """A row is proven when the k_eff-th candidate, less eps and the fp32
    slack, is no nearer than the exact k-th (fp32 stores with eps = 0); a
    k_eff = n is exact by construction; rows left unproven after the
    second pass take fp32 brute force over the host points."""
    pts, q = _ring_case()
    tree = BufferKDTree(pts, height=2, precision="int8", device=CPU)
    eps = tree.store.quant_eps
    dists = np.full((2, 10), 1.0, np.float32)
    d2 = np.zeros((2, 18), np.float32)
    d2[0, -1] = (1.0 + eps + 0.01) ** 2      # far enough: proven
    d2[1, -1] = (1.0 + eps - 0.01) ** 2      # inside the band: not proven
    np.testing.assert_array_equal(tree._certified(q.repeat(2, 0), d2, dists, 10, 18),
                                  [True, False])
    assert tree._certified(q.repeat(2, 0), d2, dists, 10, tree.n).all()
    fp32 = BufferKDTree(pts, height=2, device=CPU)
    assert fp32._certified(q.repeat(2, 0), d2, dists, 10, 18).all()
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    ed, ei = tree._exact_rows(q, 10)
    np.testing.assert_array_equal(ei, bi)
    np.testing.assert_allclose(ed, bd, **TOL)
    # 160 ring points: more than QUANT_REFINE_OVERFETCH in the band too
    pts, q = _ring_case(160)
    index = KNNIndex.build(pts, IndexSpec(engine="chunked", height=2, precision="int8",
                                          devices=CPUS))
    res = index.query(q, 10)
    bd, bi = knn_brute(q, pts, 10, device="cpu")
    np.testing.assert_array_equal(res.idx, bi)
    assert (res.stats.refined_rows, res.stats.exact_rows) == (1, 1)
