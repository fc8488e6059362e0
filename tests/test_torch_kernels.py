"""repro_torch kernels vs the JAX reference (repro.kernels, repro.core.brute).

Inputs come from numpy with a seed and go to both packages as numpy
arrays.  Distances are compared with rtol=atol=1e-5: the two packages sum
the ||q||^2 - 2 q.x + ||x||^2 decomposition in different orders (the
reference does not reach bit-identity against itself either: its
interpret-mode Pallas kernel differs from its own ``leaf_scan_ref`` once a
slab spans several tiles).  Indices are compared permutation-aware: the
reference distance at every rank must be the distance of the port's index.
The CUDA kernel itself runs only on the card: ``test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kernels_knn import SWEEP, _inputs

from repro.core.brute import knn_brute as jax_knn_brute
from repro.kernels import knn_scan as jax_knn_scan
from repro.kernels.ref import leaf_scan_ref as jax_leaf_scan_ref
from repro_torch.core.brute import knn_brute
from repro_torch.kernels import knn_scan, ops
from repro_torch.kernels.ref import PAD_COORD, knn_brute_ref, leaf_scan_ref

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _np_inputs(w, tq, lp, d, d_pad, seed=0, pad_rows=0):
    q, x = _inputs(w, tq, lp, d, d_pad, seed=seed, pad_rows=pad_rows)
    return np.array(q), np.array(x)


def _all_dists(q, x):
    """Reference decomposition for every (query, slab row) pair, float64."""
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    qn = np.sum(q * q, -1)[..., :, None]
    xn = np.sum(x * x, -1)[..., None, :]
    return np.maximum(qn - 2 * np.einsum("wqd,wld->wql", q, x) + xn, 0.0)


def _assert_scan_matches(q, x, k, port_d, port_i, ref_d):
    port_d = np.asarray(port_d)
    port_i = np.asarray(port_i)
    ref_d = np.asarray(ref_d)
    np.testing.assert_allclose(port_d, ref_d, **TOL)
    d_of_pi = np.take_along_axis(_all_dists(q, x), port_i.astype(np.int64), -1)
    np.testing.assert_allclose(d_of_pi, ref_d, **TOL)
    assert (np.diff(port_d, axis=-1) >= 0).all()
    assert port_i.dtype == np.int32


@pytest.mark.parametrize("w,tq,lp,d,d_pad,k,tx", SWEEP)
def test_leaf_scan_ref_sweep(w, tq, lp, d, d_pad, k, tx):
    q, x = _np_inputs(w, tq, lp, d, d_pad, seed=w * 7 + k)
    rd, _ = jax_leaf_scan_ref(jnp.asarray(q), jnp.asarray(x), k=k)
    pd, pi = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=k)
    _assert_scan_matches(q, x, k, pd, pi, rd)


def test_leaf_scan_ref_padded_rows():
    q, x = _np_inputs(2, 32, 128, 6, 8, seed=9, pad_rows=37)
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q), jnp.asarray(x), k=8)
    pd, pi = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=8)
    _assert_scan_matches(q, x, 8, pd, pi, rd)


def test_leaf_scan_ref_fewer_real_rows_than_k():
    """Pad rows fill the tail in index order, exactly as the reference."""
    q, x = _np_inputs(1, 16, 8, 10, 16, seed=3, pad_rows=3)   # 5 real rows
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q), jnp.asarray(x), k=8)
    pd, pi = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=8)
    _assert_scan_matches(q, x, 8, pd, pi, rd)
    np.testing.assert_array_equal(pi.numpy()[..., 5:], np.asarray(ri)[..., 5:])
    assert (pi.numpy()[..., 5:] == np.arange(5, 8)).all()


def test_leaf_scan_ref_exact_ties_lowest_index():
    """Integer-lattice points give exact ties in both packages: the indices
    must then be identical (lowest index first)."""
    rng = np.random.default_rng(5)
    q = np.zeros((2, 16, 8), np.float32)
    x = np.zeros((2, 64, 8), np.float32)
    q[..., :3] = rng.integers(-2, 3, size=(2, 16, 3))
    x[..., :3] = rng.integers(-2, 3, size=(2, 64, 3))
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q), jnp.asarray(x), k=9)
    pd, pi = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=9)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("case", [
    # (w, tq, lp, d, d_pad, k, tx, pad_rows)
    (2, 16, 64, 5, 8, 4, 32, 0),
    (1, 8, 16, 10, 16, 8, 16, 11),     # 5 real rows < k
])
def test_leaf_scan_ref_vs_pallas_valid_prefix(case):
    """Against the Pallas kernel (interpret mode): only positions whose
    index is below the real row count are compared — the only ones the
    chunk round reads; the Pallas tail sentinel differs (1e31 / 2**30)."""
    w, tq, lp, d, d_pad, k, tx, pad_rows = case
    q, x = _np_inputs(w, tq, lp, d, d_pad, seed=31, pad_rows=pad_rows)
    kd, ki = jax_knn_scan.leaf_scan_pallas(
        jnp.asarray(q), jnp.asarray(x), k=k, tq=tq, tx=tx, interpret=True
    )
    pd, pi = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=k)
    real = lp - pad_rows
    valid = np.asarray(ki) < real
    assert valid.any()
    np.testing.assert_allclose(pd.numpy()[valid], np.asarray(kd)[valid], **TOL)
    np.testing.assert_array_equal(pi.numpy() < real, valid)


def test_leaf_scan_units_ref_matches_gathered_scan():
    """The indexed plain form equals the work-unit form on gathered tiles
    (empty slots scan a zero query, like the reference's masked gather)."""
    rng = np.random.default_rng(2)
    qpad = rng.normal(size=(40, 8)).astype(np.float32)
    slab = rng.normal(size=(5, 24, 8)).astype(np.float32)
    unit_leaf = np.array([3, 0, 4, 0], np.int32)
    unit_query = rng.integers(-1, 40, size=(4, 8)).astype(np.int32)
    d, i = ops.leaf_scan_units(
        torch.from_numpy(qpad), torch.from_numpy(slab),
        torch.from_numpy(unit_leaf), torch.from_numpy(unit_query),
        torch.tensor(3, dtype=torch.int32), k=6,
    )
    q_tiles = np.where((unit_query >= 0)[..., None], qpad[np.clip(unit_query, 0, None)], 0.0)
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q_tiles), jnp.asarray(slab[unit_leaf]), k=6)
    _assert_scan_matches(q_tiles.astype(np.float32), slab[unit_leaf], 6, d, i, rd)


def test_ops_dispatch_cpu_is_plain():
    q, x = _np_inputs(2, 32, 128, 5, 8, seed=17)
    a = ops.leaf_scan(torch.from_numpy(q), torch.from_numpy(x), k=5)
    b = ops.leaf_scan(torch.from_numpy(q), torch.from_numpy(x), k=5, backend="ref")
    c = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=5)
    for u, v in zip(a + b, c + c):
        assert torch.equal(u, v)
    assert ops.engine_tile_q(128, "cuda") == 128
    assert ops.engine_tile_q(128, "ref") == 16
    padded = ops.pad_dim(torch.ones(3, 5), 8, fill=PAD_COORD)
    assert padded.shape == (3, 8) and (padded[:, 5:] == PAD_COORD).all()


def test_backend_follows_the_device():
    """The plain version never stands in for the kernel on a CUDA tensor,
    and the kernel wrapper takes CUDA tensors only."""
    assert ops.resolve_backend("auto", CPU) == "ref"
    assert ops.resolve_backend("ref", CPU) == "ref"
    with pytest.raises(ValueError, match="cannot run on cpu"):
        ops.resolve_backend("cuda", CPU)
    with pytest.raises(ValueError, match="cannot run on cuda"):
        ops.resolve_backend("ref", torch.device("cuda", 0))
    q, x = _np_inputs(1, 8, 16, 3, 8, seed=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn_scan.leaf_scan_units(
            torch.from_numpy(q[0]), torch.from_numpy(x),
            torch.zeros(1, dtype=torch.int32),
            torch.arange(8, dtype=torch.int32)[None],
            torch.tensor(1, dtype=torch.int32), k=2,
        )


@pytest.mark.parametrize("k,width,seed", [(1, 8, 0), (5, 40, 1), (8, 64, 2)])
def test_extract_topk_equals_reference(k, width, seed):
    rng = np.random.default_rng(seed)
    cand_d = rng.integers(0, 6, size=(16, width)).astype(np.float32)   # ties
    cand_i = rng.permutation(16 * width).reshape(16, width).astype(np.int32)
    jd, ji = jax_knn_scan._extract_topk(jnp.asarray(cand_d), jnp.asarray(cand_i), k)
    pd, pi = knn_scan._extract_topk(torch.from_numpy(cand_d), torch.from_numpy(cand_i), k)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k,seed", [(1, 0), (4, 1), (10, 2)])
def test_rank_merge_equals_reference(k, seed):
    rng = np.random.default_rng(seed)
    a_d = np.sort(rng.integers(0, 8, size=(12, k)), 1).astype(np.float32)
    b_d = np.sort(rng.integers(0, 8, size=(12, k)), 1).astype(np.float32)
    a_i = rng.integers(0, 100, size=(12, k)).astype(np.int32)
    b_i = rng.integers(100, 200, size=(12, k)).astype(np.int32)
    jd, ji = jax_knn_scan._rank_merge(*map(jnp.asarray, (a_d, a_i, b_d, b_i)), k)
    pd, pi = knn_scan._rank_merge(*map(torch.from_numpy, (a_d, a_i, b_d, b_i)), k)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,m,d,k", [(500, 37, 3, 5), (3000, 130, 10, 10)])
def test_knn_brute_vs_reference(n, m, d, k):
    rng = np.random.default_rng(n + m)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)
    jd, ji = jax_knn_brute(q, pts, k, tile_q=64, tile_x=1024)
    pd, pi = knn_brute(q, pts, k, device=CPU, tile_q=64, tile_x=1024)
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-6)
    assert pi.dtype == np.int64
    d_of_pi = np.sqrt(np.sum((q[:, None, :] - pts[pi]) ** 2, -1))
    np.testing.assert_allclose(d_of_pi, jd, rtol=1e-5, atol=1e-6)
    rd, ri = knn_brute_ref(torch.from_numpy(q), torch.from_numpy(pts), k=k)
    np.testing.assert_allclose(np.sqrt(rd.numpy()), jd, rtol=1e-5, atol=1e-6)



# --- the CUDA kernel's launch choice and its selection scheme (no card) ---

VARIANT_DS = list(range(1, 17)) + [31, 64, 130, 300]
VARIANT_KS = [1, 10, 32, 33, 128, 129, 1000]


@pytest.mark.parametrize("d", VARIANT_DS)
def test_choose_variant_takes_every_k_and_d(d):
    """Every k <= L_pad and every d get a launch that fits one block's
    shared memory: no limit of the kernel is left for the caller."""
    for k in VARIANT_KS:
        for tq in (1, 8, 128):
            v = knn_scan.choose_variant(d, k, tq, l_pad=4096)
            assert v.smem_bytes <= knn_scan.SMEM_LIMIT == 232_448
            assert v.threads % 32 == 0 and v.threads * v.qpt >= tq
            if v.kind == "narrow":
                assert d <= v.width <= d + 1 and v.width in knn_scan.NARROW_WIDTHS
            else:   # rows staged whole (width 0) or in chunks of WIDE_FC features
                assert d > knn_scan.NARROW_WIDTHS[-1] and v.width in (0, knn_scan.WIDE_FC)
                assert (v.qpt, v.threads) == (1, knn_scan.WIDE_THREADS)
            if v.list_at == "reg":
                assert k <= v.kmax in knn_scan.REG_KMAX
            else:
                assert v.kmax == 0
            if v.list_at == "out":     # only when the list cannot be in shared memory
                assert v.smem_bytes + 8 * k * v.qpt * v.threads > knn_scan.SMEM_LIMIT
    # the main path's launch: exact width 10, a register list of exactly 10
    main = knn_scan.choose_variant(10, 10, 128, 4096)
    assert (main.kind, main.width, main.kmax, main.qpt, main.list_at, main.threads) == (
        "narrow", 10, 10, 2, "reg", 64)


def test_choose_variant_raises_only_on_malformed_calls():
    with pytest.raises(ValueError, match="k=65"):
        knn_scan.choose_variant(10, 65, 128, l_pad=64)
    with pytest.raises(ValueError, match="k=0"):
        knn_scan.choose_variant(10, 0, 128, l_pad=64)
    with pytest.raises(ValueError, match="TQ=129"):
        knn_scan.choose_variant(10, 10, 129, l_pad=64)
    with pytest.raises(ValueError, match="d=0"):
        knn_scan.choose_variant(0, 10, 128, l_pad=64)
    # the placements the card tests compare bit for bit
    assert [knn_scan.choose_variant(16, k, 128, 1000).list_at for k in (16, 17, 300)] == [
        "reg", "smem", "out"]
    assert knn_scan.choose_variant(17, 16, 128, 1000).kind == "wide"


def _fma(a, b, c):
    """fp32 fused multiply-add (exact product, one rounding; a model)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _round_up_sub(a, b):
    """a - b rounded toward +inf in fp32 (``__fsub_ru``)."""
    exact = np.float64(a) - np.float64(b)
    r = np.float32(exact)
    return np.nextafter(r, np.float32(np.inf)) if np.float64(r) < exact else r


def _narrow_kernel_model(q, x, k, use_filter=True):
    """numpy model of the narrow kernel's selection for one unit: acc is the
    FMA chain from ||x||^2 over -2q; the rows of a 64-row tile (of each
    32-row pass in the first tile) are filtered by the rounded-up bound
    first, then inserted in ascending row order with a strict < against
    the list as it is then."""
    tq, d = q.shape
    qn = np.zeros(tq, np.float32)
    xn = np.zeros(x.shape[0], np.float32)
    for j in range(d):
        qn = _fma(q[:, j], q[:, j], qn)
        xn = _fma(x[:, j], x[:, j], xn)
    acc = np.broadcast_to(xn, (tq, x.shape[0])).astype(np.float32)
    for j in range(d):
        acc = _fma(-2 * q[:, j, None], x[None, :, j], acc)
    out_d = np.empty((tq, k), np.float32)
    out_i = np.empty((tq, k), np.int32)
    n = x.shape[0]
    flushes = sorted({0, min(32, n), *range(64, n, 64), n})
    for t in range(tq):
        lst, thr = [], np.float32(np.inf)
        for r0, r1 in zip(flushes[:-1], flushes[1:]):
            bound = (_round_up_sub(thr, qn[t]) if thr > 0 else -np.inf) if use_filter else np.inf
            for r in range(r0, r1):
                if not acc[t, r] < bound:
                    continue
                dist = max(np.float32(acc[t, r] + qn[t]), np.float32(0))
                if dist < thr:
                    pos = sum(1 for e in lst if e[0] <= dist)
                    lst = (lst[:pos] + [(dist, r)] + lst[pos:])[:k]
                    if len(lst) == k:
                        thr = lst[-1][0]
        out_d[t] = [e[0] for e in lst]
        out_i[t] = [e[1] for e in lst]
    return out_d, out_i


@pytest.mark.parametrize("lp,d,k,lattice", [
    (200, 10, 10, False), (150, 3, 1, False), (300, 7, 33, False),
    (256, 10, 10, True), (100, 2, 16, True),
])
def test_kernel_selection_scheme_matches_reference(lp, d, k, lattice):
    """The kernel's filter never drops a row the list would take (the
    unfiltered scheme gives bit-identical lists), and its lists are the
    reference's: within TOL, and bit-identical with exact ties on a
    lattice, where every value is exact."""
    rng = np.random.default_rng(lp + d + k)
    if lattice:
        q = rng.integers(-2, 3, size=(16, d)).astype(np.float32)
        x = rng.integers(-2, 3, size=(lp, d)).astype(np.float32)
    else:
        q = rng.normal(size=(16, d)).astype(np.float32)
        x = rng.normal(size=(lp, d)).astype(np.float32)
    md, mi = _narrow_kernel_model(q, x, k)
    ud, ui = _narrow_kernel_model(q, x, k, use_filter=False)
    np.testing.assert_array_equal(md, ud)
    np.testing.assert_array_equal(mi, ui)
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q[None]), jnp.asarray(x[None]), k=k)
    _assert_scan_matches(q[None], x[None], k, md[None], mi[None], rd)
    if lattice:
        np.testing.assert_array_equal(md, np.asarray(rd)[0])
        np.testing.assert_array_equal(mi, np.asarray(ri)[0])


# --- the long lists (k > 16): a heap of 64-bit keys ---

_INT_MAX = 2**31 - 1


def _key(dist, idx):
    """csrc/leaf_scan.cu ``list_key``: the fp32 distance's bits over the
    index, as an unsigned 64-bit integer."""
    return (int(np.float32(dist).view(np.uint32)) << 32) | int(idx)


def _key_pair(key):
    return np.uint32(key >> 32).view(np.float32), np.int32(key & 0xFFFFFFFF)


class _HeapModel:
    """Model of csrc/leaf_scan.cu ``HeapList``: a max-heap of kl keys
    starting at (+inf, INT_MAX); an insert replaces the root and sifts it
    down, taking the larger child (the right one only when strictly
    larger); ``sorted`` is the kernel's final heapsort."""

    def __init__(self, kl):
        self.keys = [_key(np.inf, _INT_MAX)] * kl

    def worst(self):
        return _key_pair(self.keys[0])[0]

    def _sift(self, v, n):
        k, at, c = self.keys, 0, 1
        while c < n:
            if c + 1 < n and k[c + 1] > k[c]:
                c += 1
            if not k[c] > v:
                break
            k[at] = k[c]
            at, c = c, 2 * c + 1
        k[at] = v

    def insert(self, dist, idx):
        self._sift(_key(dist, idx), len(self.keys))

    def sorted(self):
        k = self.keys
        for n in range(len(k) - 1, 0, -1):
            v = k[n]
            k[n] = k[0]
            self._sift(v, n)
        pairs = [_key_pair(v) for v in k]
        return (np.array([p[0] for p in pairs], np.float32),
                np.array([p[1] for p in pairs], np.int32))


def _heap_kernel_model(q, x, k):
    """numpy model of the narrow kernel's selection for k > 16: the filter
    and row order of ``_narrow_kernel_model``, each passing row that beats
    the heap's root inserted into ``_HeapModel``, then the heapsort."""
    tq, d = q.shape
    qn = np.zeros(tq, np.float32)
    xn = np.zeros(x.shape[0], np.float32)
    for j in range(d):
        qn = _fma(q[:, j], q[:, j], qn)
        xn = _fma(x[:, j], x[:, j], xn)
    acc = np.broadcast_to(xn, (tq, x.shape[0])).astype(np.float32)
    for j in range(d):
        acc = _fma(-2 * q[:, j, None], x[None, :, j], acc)
    out_d = np.empty((tq, k), np.float32)
    out_i = np.empty((tq, k), np.int32)
    n = x.shape[0]
    flushes = sorted({0, min(32, n), *range(64, n, 64), n})
    for t in range(tq):
        heap = _HeapModel(k)
        for r0, r1 in zip(flushes[:-1], flushes[1:]):
            thr = heap.worst()
            bound = _round_up_sub(thr, qn[t]) if thr > 0 else -np.inf
            for r in range(r0, r1):
                if not acc[t, r] < bound:
                    continue
                dist = max(np.float32(acc[t, r] + qn[t]), np.float32(0))
                if dist < heap.worst():
                    heap.insert(dist, r)
        out_d[t], out_i[t] = heap.sorted()
    return out_d, out_i


# (L_pad, d, kl): kl just past the register lists, the quantized path's
# 18, 33, the refining pass's 74 and a list past shared memory (217), each
# with L_pad just above kl and well above it
HEAP_CASES = [
    (30, 3, 17), (200, 3, 17), (20, 10, 18), (300, 10, 18), (40, 5, 33),
    (300, 5, 33), (80, 10, 74), (400, 10, 74), (260, 4, 217),
]


@pytest.mark.parametrize("lp,d,k", HEAP_CASES)
def test_heap_selection_matches_insert_at_a_time(lp, d, k):
    """The heap gives the lists the sorted list inserted into one row at a
    time gives (the kernel's design for k > 16 before the heap), bit for
    bit: the same rows pass the filter, and the heap holds the k first
    (distance, index) pairs as the sorted list does."""
    rng = np.random.default_rng(lp + k)
    q = rng.normal(size=(8, d)).astype(np.float32)
    x = rng.normal(size=(lp, d)).astype(np.float32)
    hd, hi = _heap_kernel_model(q, x, k)
    md, mi = _narrow_kernel_model(q, x, k)
    np.testing.assert_array_equal(hd, md)
    np.testing.assert_array_equal(hi, mi)


@pytest.mark.parametrize("lp,d,k", HEAP_CASES)
def test_heap_selection_matches_reference_exact_ties(lp, d, k):
    """On an integer lattice every value is exact and ties are everywhere:
    the heap's lists equal ``repro``'s ``leaf_scan_ref`` bit for bit,
    distances and the lowest-index tie order."""
    rng = np.random.default_rng(7 * lp + k)
    q = rng.integers(-2, 3, size=(8, d)).astype(np.float32)
    x = rng.integers(-2, 3, size=(lp, d)).astype(np.float32)
    hd, hi = _heap_kernel_model(q, x, k)
    rd, ri = jax_leaf_scan_ref(jnp.asarray(q[None]), jnp.asarray(x[None]), k=k)
    np.testing.assert_array_equal(hd, np.asarray(rd)[0])
    np.testing.assert_array_equal(hi, np.asarray(ri)[0])


@pytest.mark.parametrize("kl,width", [(17, 17), (17, 40), (18, 300), (33, 100),
                                      (74, 74), (74, 500)])
def test_heap_equals_extract_topk(kl, width):
    """The heap on its own: candidates taken in index order (each only if it
    beats the root, as the kernel tests it) and heapsorted equal the port's
    ``_extract_topk`` (the reference's per-tile selection, ties to the
    first position) of the same row, distances drawn from a few values so
    ties cross every level of the heap."""
    rng = np.random.default_rng(kl * width)
    cand_d = rng.integers(0, 6, size=(4, width)).astype(np.float32)
    cand_d[1] = 0.0                              # one row of nothing but ties
    cand_i = np.broadcast_to(np.arange(width, dtype=np.int32), (4, width))
    want_d, want_i = knn_scan._extract_topk(torch.from_numpy(cand_d),
                                            torch.from_numpy(cand_i.copy()), kl)
    for row in range(4):
        heap = _HeapModel(kl)
        for j in range(width):
            if cand_d[row, j] < heap.worst():
                heap.insert(cand_d[row, j], j)
        got_d, got_i = heap.sorted()
        np.testing.assert_array_equal(got_d, want_d[row].numpy())
        np.testing.assert_array_equal(got_i, want_i[row].numpy())


def test_heap_keys_order_as_distance_index_pairs():
    """A key's unsigned order is the (distance, index) order for every
    distance the kernel forms (>= +0, subnormals and +inf included)."""
    dists = np.array([0.0, 1e-45, 1e-38, 1e-30, 0.5, 1.0, 1.0000001, 3e37, np.inf],
                     np.float32)
    pairs = [(float(d), i) for d in dists for i in (0, 1, 7, 4095, _INT_MAX)]
    by_key = sorted(pairs, key=lambda p: _key(*p))
    assert by_key == sorted(pairs)
    assert all(_key_pair(_key(d, i)) == (np.float32(d), i) for d, i in pairs)


def test_choose_variant_long_lists_take_the_heap():
    """Past the longest register list the narrow kernel takes the heap with
    one query per thread: in shared memory while 8 bytes x k per slot fit,
    then in the output rows; so does the wide kernel."""
    for tq in (8, 128):
        for k in (17, 18, 74, 216, 217, 300):
            v = knn_scan.choose_variant(10, k, tq, 4096)
            assert (v.kind, v.kmax, v.qpt, v.threads) == ("narrow", 0, 1, max(32, tq))
            base = knn_scan.choose_variant(10, 10, tq, 4096).smem_bytes   # no list there
            in_smem = base + 8 * k * v.threads <= knn_scan.SMEM_LIMIT
            assert v.list_at == ("smem" if in_smem else "out")
            assert v.smem_bytes == (base + 8 * k * v.threads if in_smem else base)
            assert v.name == f"narrow<10,heap>/{v.list_at}"
    assert knn_scan.choose_variant(10, 216, 128, 4096).list_at == "smem"
    assert knn_scan.choose_variant(10, 217, 128, 4096).list_at == "out"
    assert knn_scan.choose_variant(10, 16, 128, 4096).name == "narrow<10,16>/reg"
    wide = knn_scan.choose_variant(130, 74, 128, 4096)
    assert (wide.kind, wide.qpt, wide.list_at, wide.name) == (
        "wide", 1, "smem", "wide<heap>/smem")


WIDE_DS = [17, 30, 72, 130, 300, 1024]
WIDE_KS = [1, 16, 17, 74, 216, 300]


@pytest.mark.parametrize("k", WIDE_KS)
@pytest.mark.parametrize("d", WIDE_DS)
def test_choose_variant_wide_placements(d, k):
    """Rows of d > 16 take the wide kernel with the narrow kernel's lists:
    a register list for k <= 16, a heap in shared memory while it fits,
    else in the output rows; rows staged whole while -2q of every slot and
    two pieces of whole rows fit, else in chunks of WIDE_FC features.  The
    shared memory is the C library's formula and stays within one block's
    limit, for every code type."""
    for code in ("f32", "u8", "f16"):
        v = knn_scan.choose_variant(d, k, 128, 4096, code)
        slots = v.qpt * v.threads
        assert (v.kind, v.qpt, v.threads, v.code) == ("wide", 1, knn_scan.WIDE_THREADS,
                                                      code)
        whole = knn_scan._wide_base_bytes(code, d, 0, slots)
        assert v.width == (0 if whole <= knn_scan.SMEM_LIMIT else knn_scan.WIDE_FC)
        base = knn_scan._wide_base_bytes(code, d, v.width, slots)
        heap = 8 * k * slots
        if k <= 16:
            assert v.list_at == "reg" and v.kmax == min(km for km in knn_scan.REG_KMAX
                                                        if km >= k)
            assert v.smem_bytes == base
        elif base + heap <= knn_scan.SMEM_LIMIT:
            assert (v.list_at, v.kmax, v.smem_bytes) == ("smem", 0, base + heap)
        else:
            assert (v.list_at, v.kmax, v.smem_bytes) == ("out", 0, base)
        assert v.smem_bytes <= knn_scan.SMEM_LIMIT
        # fp32: -2q of every slot (whole rows) and two staged pieces, rows
        # padded where dp / 4 is even
        dp = -(-d // 4) * 4
        rs = dp if (dp // 4) % 2 else dp + 4
        if code == "f32" and v.width == 0:
            assert base == 4 * slots * dp + 2 * 4 * 32 * rs
    # the instances the wide cell and phase 3 launch
    assert knn_scan.choose_variant(30, 16, 128, 4096).name == "wide<16>/reg"
    assert knn_scan.choose_variant(30, 18, 128, 4096, "u8").name == "wide<heap>/smem/u8"
    assert knn_scan.choose_variant(130, 10, 128, 4096).name == "wide<10>/reg"


def test_wide_variant_names_are_distinct():
    """Every wide launch the library can take has a name of its own (list,
    rows whole or in chunks, code type), and none is a narrow name: the
    launch counts by variant tell them apart."""
    seen = {}
    for d in WIDE_DS + [16]:
        for k in WIDE_KS + [4, 8, 10]:
            for code in ("f32", "u8", "f16"):
                v = knn_scan.choose_variant(d, k, 128, 4096, code)
                out = dataclasses.replace(v, list_at="out", kmax=0)
                for u in (v, out) if v.kind == "wide" else (v,):
                    key = (u.kind, u.width, u.kmax, u.qpt, u.list_at, u.code)
                    assert seen.setdefault(u.name, key) == key, u.name
    wide = [n for n in seen if n.startswith("wide<")]
    assert {"wide<16>/reg", "wide<heap>/smem", "wide<heap>/out", "wide<16>/reg/chunk128",
            "wide<heap>/out/chunk128", "wide<heap>/smem/u8"} <= set(wide)
    assert all(not n.startswith("wide") for n in set(seen) - set(wide))


# --- code slabs (fp16 / uint8): the launch choice and the tile copy ---

@pytest.mark.parametrize("code", ["f16", "u8"])
@pytest.mark.parametrize("d", VARIANT_DS)
def test_choose_variant_for_codes(code, d):
    """A code slab takes the fp32 slab's instance, block and list placement
    wherever its raw tile fits; only the narrow kernel's raw tile bytes
    (and, for u8, the leaf's scale and offset) change."""
    es = knn_scan.CODES[code][1]
    for k in VARIANT_KS:
        f32 = knn_scan.choose_variant(d, k, 128, l_pad=4096)
        v = knn_scan.choose_variant(d, k, 128, l_pad=4096, code=code)
        assert v.smem_bytes <= knn_scan.SMEM_LIMIT and v.code == code
        assert (v.kind, v.kmax, v.threads) == (f32.kind, f32.kmax, f32.threads)
        if v.kind == "wide":
            # codes add the raw tiles (and u8 metadata) to whole rows, so rows
            # go in chunks a little earlier than fp32's
            whole = knn_scan._wide_base_bytes(code, d, 0, v.threads)
            assert v.width == (0 if whole <= knn_scan.SMEM_LIMIT else knn_scan.WIDE_FC)
            heap = 8 * k * v.threads if v.list_at == "smem" else 0
            assert v.smem_bytes == knn_scan._wide_base_bytes(code, d, v.width,
                                                             v.threads) + heap
            assert v.name.endswith("/" + code)
            continue
        assert v.width == f32.width
        raw = -(-(knn_scan.TILE * d * es + 4) // 16) * 16
        meta = 4 * -(-2 * d // 4) * 4 if code == "u8" else 0
        delta = meta + 2 * raw - 2 * knn_scan.TILE * d * 4
        if v.list_at == f32.list_at:
            assert v.smem_bytes - f32.smem_bytes == delta
        assert v.name.endswith("/" + code)
    # the quantized main path: k = 10 overfetched to 18 takes the heap in
    # shared memory, not a register list (REG_KMAX stops at 16)
    main = knn_scan.choose_variant(10, 18, 128, 4096, code="u8")
    assert (main.kind, main.width, main.kmax, main.list_at) == ("narrow", 10, 0, "smem")
    assert (main.qpt, main.threads, main.name) == (1, 128, "narrow<10,heap>/smem/u8")
    with pytest.raises(ValueError, match="code="):
        knn_scan.choose_variant(10, 10, 128, 4096, code="bf16")


def _tile_window(addr, nbytes):
    """The narrow kernel's copy of a code tile's bytes [addr, addr + nbytes)
    (csrc/leaf_scan.cu ``issue``): offsets from the 4-byte boundary below
    addr, whole words by cp.async, the rest by plain loads per thread."""
    a = addr & 3
    e = a + nbytes
    wb, we = (a + 3) >> 2, e >> 2
    words = [o for k in range(wb, we) for o in range(4 * k, 4 * k + 4)]
    plain = []
    for t in range(3):
        h = a + t
        if h < min(4 * wb, e):
            plain.append(h)
        b = max(4 * we, 4 * wb) + t
        if b < e:
            plain.append(b)
    return a, e, words, plain


@pytest.mark.parametrize("es", [1, 2])
def test_code_tile_copy_covers_every_byte_once(es):
    """Every byte of a tile is copied exactly once and nothing outside it
    is read, for every leaf base alignment, odd d and a last partial tile."""
    for d in (1, 2, 3, 9, 10, 13):
        for rows in (1, 2, 3, 37, 64):
            for base in range(0, 8, es):
                a, e, words, plain = _tile_window(base, rows * d * es)
                got = sorted(words + plain)
                assert got == list(range(a, e)), (d, rows, base)
                assert e <= -(-(knn_scan.TILE * d * es + 4) // 16) * 16   # raw tile
