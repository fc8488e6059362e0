"""repro_torch's CUDA leaf-scan kernel against its plain version, on the card,
and the engines, the LM, the train step, checkpoints and the model families
on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc and skips without one (it is
decided inside each test, never at import).  The file imports neither jax
nor ``repro``, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Distances are compared with rtol=atol=1e-5 (the kernel sums the
decomposition with FFMA in another order than the plain matmul), indices
permutation-aware against float64 distances; on an integer lattice, where
every value is exact, bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.brute import knn_brute
from repro_torch.core.lazysearch import BufferKDTree
from repro_torch.core.quantize import pack_dead, quantize_slabs
from repro_torch.kernels import knn_scan
from repro_torch.kernels.ref import PAD_COORD, leaf_scan_ref

TOL = dict(rtol=1e-5, atol=1e-5)

# (W, TQ, L_pad, d, d_pad, k, pad_rows): the reference's kernel sweep
# (tests/test_kernels_knn.py SWEEP), then the edge cases of the kernel.
CASES = [
    (1, 8, 64, 3, 8, 1, 0),
    (2, 64, 128, 5, 8, 5, 0),
    (4, 128, 512, 10, 16, 10, 0),
    (3, 32, 256, 15, 16, 7, 0),
    (1, 16, 1024, 7, 8, 10, 0),
    (5, 64, 96, 2, 8, 3, 0),
    (1, 16, 16, 10, 16, 8, 11),       # 5 real rows < k: pad rows fill the tail
    (2, 128, 300, 10, 16, 40, 0),     # shared-memory list, ragged last tile
    (1, 32, 64, 70, 72, 20, 0),       # 72 features: the wide kernel
    (4, 128, 512, 10, 10, 10, 0),     # unpadded rows, as the main path passes them
    # one row per narrow instance width, at k = 10
    (2, 128, 300, 2, 2, 10, 0),
    (2, 128, 300, 4, 4, 10, 0),
    (2, 128, 300, 6, 6, 10, 0),
    (2, 128, 300, 8, 8, 10, 0),
    (2, 128, 300, 10, 10, 10, 0),
    (2, 128, 300, 12, 12, 10, 0),
    (2, 128, 300, 14, 14, 10, 0),
    (2, 128, 300, 16, 16, 10, 0),
    (2, 128, 300, 9, 9, 10, 0),       # odd d: the even instance's zero column
]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda", 0)


def _inputs(w, tq, lp, d, d_pad, seed, pad_rows=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((w, tq, d_pad), np.float32)
    q[..., :d] = rng.normal(size=(w, tq, d))
    x = np.zeros((w, lp, d_pad), np.float32)
    x[..., :d] = rng.normal(size=(w, lp, d))
    if pad_rows:
        x[:, lp - pad_rows:, :d] = PAD_COORD
    return q, x


def _assert_scan_matches(q, x, kd, ki, rd):
    kd, ki, rd = kd.cpu().numpy(), ki.cpu().numpy(), rd.cpu().numpy()
    np.testing.assert_allclose(kd, rd, **TOL)
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    all_d = np.maximum(
        np.sum(q64 * q64, -1)[..., :, None]
        - 2 * np.einsum("wqd,wld->wql", q64, x64)
        + np.sum(x64 * x64, -1)[..., None, :], 0.0)
    d_of_ki = np.take_along_axis(all_d, ki.astype(np.int64), -1)
    np.testing.assert_allclose(d_of_ki, rd, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_vs_plain(case):
    dev = _device()
    w, tq, lp, d, d_pad, k, pad_rows = case
    q, x = _inputs(w, tq, lp, d, d_pad, seed=w + k, pad_rows=pad_rows)
    qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    before = knn_scan.leaf_scan_units.launches
    kd, ki = knn_scan.leaf_scan_cuda(qt, xt, k=k)
    torch.cuda.synchronize()
    assert knn_scan.leaf_scan_units.launches == before + 1
    rd, _ = leaf_scan_ref(qt, xt, k=k)
    _assert_scan_matches(q, x, kd, ki, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("lp,d,d_pad,k", [(200, 3, 8, 9), (1024, 10, 10, 10)])
def test_kernel_exact_ties_lowest_index(lp, d, d_pad, k):
    """Integer lattice: every value is exact, so distances and the tie
    order (lowest index first) must be bit-identical to the plain version."""
    dev = _device()
    rng = np.random.default_rng(5)
    q = np.zeros((2, 128, d_pad), np.float32)
    x = np.zeros((2, lp, d_pad), np.float32)
    q[..., :d] = rng.integers(-2, 3, size=(2, 128, d))
    x[..., :d] = rng.integers(-2, 3, size=(2, lp, d))
    kd, ki = knn_scan.leaf_scan_cuda(torch.from_numpy(q).to(dev),
                                     torch.from_numpy(x).to(dev), k=k)
    rd, ri = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=k)
    np.testing.assert_array_equal(kd.cpu().numpy(), rd.numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), ri.numpy())


@pytest.mark.cuda
def test_kernel_indexed_form_skips_rows_past_n_units():
    dev = _device()
    rng = np.random.default_rng(2)
    qpad = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev)
    slab = torch.from_numpy(rng.normal(size=(6, 64, 16)).astype(np.float32)).to(dev)
    unit_leaf = torch.from_numpy(rng.integers(0, 6, size=9).astype(np.int32)).to(dev)
    unit_query = torch.from_numpy(
        rng.integers(-1, 300, size=(9, 32)).astype(np.int32)).to(dev)
    n_units = torch.tensor(5, dtype=torch.int32, device=dev)
    kd, ki = knn_scan.leaf_scan_units(qpad, slab, unit_leaf, unit_query, n_units, k=7)
    rd, ri = knn_scan.leaf_scan_units_ref(qpad, slab, unit_leaf, unit_query, n_units, k=7)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kd[:5].cpu().numpy(), rd[:5].cpu().numpy(), **TOL)
    assert (ki[:5] < 64).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lp,d,k,pad_rows,code", [
    pytest.param(600, 10, 129, 0, "f32", id="600-10-129-0"),     # list in shared memory
    pytest.param(600, 10, 300, 0, "f32", id="600-10-300-0"),     # list in the output rows
    pytest.param(300, 136, 10, 0, "f32", id="300-136-10-0"),     # wide kernel
    # wide kernel, output-row list, pad rows in the tail
    pytest.param(320, 300, 300, 37, "f32", id="320-300-300-37"),
    # the wide cell's rows (d = 30): its register list and the refining
    # pass's heap, fp32 and uint8 codes with dead rows
    pytest.param(1000, 30, 16, 0, "f32", id="1000-30-16-0"),
    pytest.param(1000, 30, 74, 11, "f32", id="1000-30-74-11"),
    pytest.param(1000, 30, 16, 0, "u8", id="1000-30-16-0-u8"),
    pytest.param(1000, 30, 74, 0, "u8", id="1000-30-74-0-u8"),
    # rows too wide to stage whole: chunks of features
    pytest.param(300, 520, 16, 5, "f32", id="300-520-16-5"),
    pytest.param(300, 520, 40, 0, "u8", id="300-520-40-0-u8"),
])
def test_kernel_takes_long_lists_and_wide_rows(lp, d, k, pad_rows, code):
    dev = _device()
    if code != "f32":
        q, codes, meta = _code_inputs(2, 128, lp, d, code, seed=lp + d + k, dead_frac=0.2)
        kd, ki, rd, _, x = _scan_codes(dev, q, codes, meta, k)
        _assert_scan_matches(q, x, kd, ki, rd)
        dead = np.unpackbits(meta["dead"], axis=1)[:, :lp].astype(bool)
        sel_dead = dead[np.arange(2)[:, None, None], ki.cpu().numpy()]
        assert (np.diff(sel_dead.astype(int), axis=-1) >= 0).all()
        return
    q, x = _inputs(2, 128, lp, d, d, seed=lp + k, pad_rows=pad_rows)
    qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    kd, ki = knn_scan.leaf_scan_cuda(qt, xt, k=k)
    torch.cuda.synchronize()
    rd, _ = leaf_scan_ref(qt, xt, k=k)
    _assert_scan_matches(q, x, kd, ki, rd)


@pytest.mark.cuda
def test_kernel_instances_agree_bit_for_bit():
    """Every instance forms the same values: a register list (k=16), the
    first 16 entries of a shared-memory list (k=17) and of an output-row
    list (k=300), and the wide kernel's register list (k=16) and heaps in
    shared memory (k=17) and in the output rows (k=300) on the rows with
    zero columns past 16 (d = 17, and d = 30 at k = 16) are identical."""
    dev = _device()
    q, x = _inputs(3, 128, 1000, 16, 30, seed=11)
    qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    base = knn_scan.leaf_scan_cuda(qt[..., :16].contiguous(), xt[..., :16].contiguous(), k=16)
    others = [knn_scan.leaf_scan_cuda(qt[..., :16].contiguous(), xt[..., :16].contiguous(), k=k)
              for k in (17, 300)]
    q17, x17 = qt[..., :17].contiguous(), xt[..., :17].contiguous()
    lists = [knn_scan.choose_variant(17, k, 128, 1000).list_at for k in (16, 17, 300)]
    assert lists == ["reg", "smem", "out"]
    others += [knn_scan.leaf_scan_cuda(q17, x17, k=k) for k in (16, 17, 300)]
    others.append(knn_scan.leaf_scan_cuda(qt, xt, k=16))
    torch.cuda.synchronize()
    for od, oi in others:
        assert torch.equal(od[..., :16], base[0]) and torch.equal(oi[..., :16], base[1])


@pytest.mark.cuda
def test_kernel_raises_on_malformed_calls():
    dev = _device()
    x = torch.zeros((1, 64, 8), device=dev)
    # one launch takes at most 128 query slots; a wider tile is scanned as
    # blocks of 128, one launch each
    with pytest.raises(ValueError, match="TQ=129"):
        knn_scan.choose_variant(8, 4, 129, 64)
    knn_scan.reset_launches()
    kd, _ = knn_scan.leaf_scan_cuda(torch.zeros((1, 129, 8), device=dev), x, k=4)
    assert kd.shape == (1, 129, 4) and knn_scan.leaf_scan_units.launches == 2
    with pytest.raises(ValueError, match="k=65"):
        knn_scan.leaf_scan_cuda(torch.zeros((1, 8, 8), device=dev), x, k=65)
    with pytest.raises(ValueError, match="reads slabs"):
        knn_scan.leaf_scan_cuda(torch.zeros((1, 8, 8), device=dev), x.double(), k=4)
    with pytest.raises(ValueError, match="dead-row mask"):
        knn_scan.leaf_scan_cuda(torch.zeros((1, 8, 8), device=dev), x.half(), k=4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(10, 150), (130, 10)])
def test_knn_index_on_card_long_lists_and_wide_rows(d, k):
    from repro_torch.api import IndexSpec, KNNIndex

    dev = _device()
    rng = np.random.default_rng(d + k)
    pts = rng.normal(size=(20000, d)).astype(np.float32)
    q = rng.normal(size=(500, d)).astype(np.float32)
    res = KNNIndex.build(pts, IndexSpec(height=5, devices=(dev,))).query(q, k)
    bd, bi = knn_brute(q, pts, k, device=dev)
    np.testing.assert_allclose(res.dists, bd, rtol=1e-5, atol=1e-6)
    assert (res.idx == bi).mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_buffer_kdtree_on_card_is_exact(n_chunks):
    dev = _device()
    rng = np.random.default_rng(n_chunks)
    pts = rng.normal(size=(20000, 10)).astype(np.float32)
    q = rng.normal(size=(3000, 10)).astype(np.float32)
    before = knn_scan.leaf_scan_units.launches
    index = BufferKDTree(pts, height=6, n_chunks=n_chunks, device=dev)
    d, i = index.query(q, 10)
    assert knn_scan.leaf_scan_units.launches > before
    bd, bi = knn_brute(q, pts, 10, device=dev)
    np.testing.assert_allclose(d, bd, rtol=1e-5, atol=1e-6)
    assert (i == bi).mean() > 0.999


# --- code slabs: the kernel reads fp16 / uint8 codes itself ---

def _code_inputs(w, tq, lp, d, code, seed, dead_frac=0.1):
    """Queries and a code slab of w leaves (ragged leaf sizes, and dead rows
    below the sizes), with the metadata the kernel reads, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(w, tq, d)).astype(np.float32)
    x = rng.normal(size=(w, lp, d)).astype(np.float32)
    sizes = rng.integers(lp // 2, lp + 1, size=w)
    x[np.arange(lp)[None, :] >= sizes[:, None]] = PAD_COORD
    qs = quantize_slabs(x, {"f16": "fp16", "u8": "int8"}[code], sizes)
    dead = qs.dead | (rng.random(qs.dead.shape) < dead_frac)
    meta = {"dead": pack_dead(dead)}
    if code == "u8":
        meta.update(scale=qs.scale, offset=qs.offset)
    return q, qs.codes, meta


def _scan_codes(dev, q, codes, meta, k):
    qt = torch.from_numpy(q).to(dev)
    ct = torch.from_numpy(codes).to(dev)
    mt = {n: torch.from_numpy(a).to(dev) for n, a in meta.items()}
    before = dict(knn_scan.leaf_scan_units.launches_by_code)
    kd, ki = knn_scan.leaf_scan_cuda(qt, ct, k=k, **mt)
    torch.cuda.synchronize()
    code = knn_scan._CODE_OF_DTYPE[ct.dtype]
    assert knn_scan.leaf_scan_units.launches_by_code[code] == before[code] + 1
    w, tq, d = q.shape
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    rd, ri = knn_scan.leaf_scan_units_ref(
        qt.reshape(w * tq, d), ct, ul, uq, torch.tensor(w, dtype=torch.int32, device=dev),
        k=k, **mt)
    x = knn_scan.dequantize(ct, mt.get("scale"), mt.get("offset"), mt["dead"])
    return kd, ki, rd, ri, x.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["f16", "u8"])
@pytest.mark.parametrize("lp,d,k", [
    (512, 10, 10),      # register list
    (4096, 10, 18),     # the quantized main path: overfetched k, shared-memory list
    (300, 9, 40),       # odd d (an unaligned u8 leaf base), ragged last tile
    (600, 10, 300),     # list in the output rows
    (300, 130, 150),    # the wide kernel
    (37, 3, 7),         # L_pad not a multiple of 8 or of 4
])
def test_kernel_reads_codes(code, lp, d, k):
    """Each code type and list placement against the plain version on the
    same codes: distances within TOL, indices permutation-aware, and dead
    rows only behind every live row."""
    dev = _device()
    q, codes, meta = _code_inputs(3, 128, lp, d, code, seed=lp + d + k)
    kd, ki, rd, _, x = _scan_codes(dev, q, codes, meta, k)
    _assert_scan_matches(q, x, kd, ki, rd)
    dead = np.unpackbits(meta["dead"], axis=1)[:, :lp].astype(bool)
    sel_dead = dead[np.arange(3)[:, None, None], ki.cpu().numpy()]
    assert (np.diff(sel_dead.astype(int), axis=-1) >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["f16", "u8"])
@pytest.mark.parametrize("lp,d,k", [(200, 3, 9), (4096, 10, 18)])
def test_kernel_reads_codes_lattice_bit_for_bit(code, lp, d, k):
    """Integer lattice codes (u8 with scale 1, offset -2; f16 integers) and
    dead rows below the leaf size: every value is exact, so distances and
    tie order (lowest index, dead rows last in index order) equal the plain
    version bit for bit."""
    dev = _device()
    rng = np.random.default_rng(lp + k)
    q = rng.integers(-2, 3, size=(2, 128, d)).astype(np.float32)
    lattice = rng.integers(0, 5, size=(2, lp, d))
    dead = rng.random((2, lp)) < 0.3
    meta = {"dead": pack_dead(dead)}
    if code == "u8":
        codes = lattice.astype(np.uint8)
        meta.update(scale=np.ones((2, d), np.float32), offset=np.full((2, d), -2, np.float32))
    else:
        codes = (lattice - 2).astype(np.float16)
    kd, ki, rd, ri, _ = _scan_codes(dev, q, codes, meta, k)
    np.testing.assert_array_equal(kd.cpu().numpy(), rd.cpu().numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), ri.cpu().numpy())


# --- the long lists: k past the register lists (k + QUANT_OVERFETCH = 18,
# the refining pass's 74), each code type, L_pad below and above k + 16 ---

LONG_KS = [17, 18, 24, 32, 33, 74]


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["f32", "u8", "f16"])
@pytest.mark.parametrize("k", LONG_KS)
@pytest.mark.parametrize("lp_over_k", [5, 300])
def test_kernel_long_lists_vs_plain(code, k, lp_over_k):
    """A list of k > 16 against the plain version, for fp32 rows (pad rows
    in one leaf's tail) and for codes (ragged leaves and dead rows):
    distances within TOL, indices permutation-aware, dead and pad rows only
    behind every live row.  L_pad = k + 5 leaves fewer rows than a list and
    a full register buffer hold together."""
    dev = _device()
    lp = k + lp_over_k
    if code == "f32":
        q, x = _inputs(3, 128, lp, 10, 10, seed=lp + k)
        x[1, lp - 3:] = PAD_COORD
        qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        kd, ki = knn_scan.leaf_scan_cuda(qt, xt, k=k)
        torch.cuda.synchronize()
        rd, _ = leaf_scan_ref(qt, xt, k=k)
        dead = np.zeros((3, lp), bool)
        dead[1, lp - 3:] = True
    else:
        q, codes, meta = _code_inputs(3, 128, lp, 10, code, seed=lp + k)
        kd, ki, rd, _, x = _scan_codes(dev, q, codes, meta, k)
        dead = np.unpackbits(meta["dead"], axis=1)[:, :lp].astype(bool)
    _assert_scan_matches(q, x, kd, ki, rd)
    sel_dead = dead[np.arange(3)[:, None, None], ki.cpu().numpy()]
    assert (np.diff(sel_dead.astype(int), axis=-1) >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["f32", "u8", "f16"])
@pytest.mark.parametrize("k", LONG_KS)
def test_kernel_long_lists_lattice_bit_for_bit(code, k):
    """Integer lattices at the main path's width (every value exact, ties
    everywhere; codes with 30 % dead rows): distances and the lowest-index
    tie order equal the plain version bit for bit."""
    dev = _device()
    rng = np.random.default_rng(100 + k)
    lp = 4096 if k in (18, 74) else 300
    q = rng.integers(-2, 3, size=(2, 128, 10)).astype(np.float32)
    lattice = rng.integers(0, 5, size=(2, lp, 10))
    if code == "f32":
        x = (lattice - 2).astype(np.float32)
        kd, ki = knn_scan.leaf_scan_cuda(torch.from_numpy(q).to(dev),
                                         torch.from_numpy(x).to(dev), k=k)
        rd, ri = leaf_scan_ref(torch.from_numpy(q), torch.from_numpy(x), k=k)
    else:
        meta = {"dead": pack_dead(rng.random((2, lp)) < 0.3)}
        if code == "u8":
            codes = lattice.astype(np.uint8)
            meta.update(scale=np.ones((2, 10), np.float32),
                        offset=np.full((2, 10), -2, np.float32))
        else:
            codes = (lattice - 2).astype(np.float16)
        kd, ki, rd, ri, _ = _scan_codes(dev, q, codes, meta, k)
    np.testing.assert_array_equal(kd.cpu().numpy(), rd.cpu().numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), ri.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("precision,n_chunks", [("fp16", 1), ("int8", 1), ("int8", 3)])
def test_buffer_kdtree_on_card_quantized_is_exact(precision, n_chunks):
    """The budgeted store on the card: the kernel reads the codes (launches
    of that code type), and the answers equal brute force up to ties (the
    card's brute force sums (q - x)^2 in another order than the host's
    exact re-rank, so equal-looking distances may swap)."""
    dev = _device()
    rng = np.random.default_rng(n_chunks)
    pts = rng.normal(size=(20000, 10)).astype(np.float32)
    q = rng.normal(size=(3000, 10)).astype(np.float32)
    code = {"fp16": "f16", "int8": "u8"}[precision]
    before = knn_scan.leaf_scan_units.launches_by_code[code]
    index = BufferKDTree(pts, height=6, n_chunks=n_chunks, device=dev, precision=precision)
    d, i = index.query(q, 10)
    assert knn_scan.leaf_scan_units.launches_by_code[code] > before
    bd, bi = knn_brute(q, pts, 10, device=dev)
    np.testing.assert_allclose(d, bd, rtol=1e-5, atol=1e-6)
    d_of_i = np.sqrt(np.sum((q[:, None, :] - pts[i]) ** 2, -1))
    np.testing.assert_allclose(d_of_i, bd, rtol=1e-5, atol=1e-6)
    assert (i == bi).mean() > 0.999


# --- the jit engine's captured round, the dual-tree ops on the card ---

@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(3000, 14), (700, 40)])
def test_captured_round_equals_eager_round_bit_for_bit(m, k):
    """``JitRounds`` on the card: the CUDA graph of one round, replayed,
    leaves the state and the round log the eager round leaves, bit for
    bit, round by round; its kernel launches come from the replays (the wrapper counts the eager
    round and the capture only)."""
    from repro_torch.core.jitsearch import JitRounds, lazy_knn_jit, tree_arrays_from
    from repro_torch.core.toptree import build_top_tree

    dev = _device()
    rng = np.random.default_rng(m)
    pts = rng.normal(size=(20000, 10)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(m, 10)).astype(np.float32)).to(dev)
    tree = build_top_tree(pts, 6)
    ta = tree_arrays_from(tree, dev)
    kw = dict(tq=128, first_leaf_heap=tree.first_leaf_heap)
    graph = JitRounds(ta, m, k, sync_every=1, **kw)
    eager = JitRounds(ta, m, k, **kw)
    graph.run(q, max_rounds=1)          # the eager warm round, then capture
    assert graph.graph is not None and graph.eager_rounds == 1
    eager.reset(q)
    eager.round()
    for _ in range(200):
        for a, b in ((graph.node, eager.node), (graph.fromc, eager.fromc),
                     (graph.knn_d[:m], eager.knn_d[:m]), (graph.knn_i[:m], eager.knn_i[:m]),
                     (graph.rounds, eager.rounds), (graph._log, eager._log)):
            assert torch.equal(a, b)
        if not bool(eager.live):
            break
        launches = knn_scan.leaf_scan_units.launches
        graph.graph.replay()
        assert knn_scan.leaf_scan_units.launches == launches   # not the wrapper
        eager.round()
    assert not bool(eager.live), "did not reach the fixed point in 200 rounds"
    # a second batch replays the same graph: answers exact against brute force
    cache = {(m, k): graph}
    d2, oi, rounds = lazy_knn_jit(q, ta, k=k, cache=cache, **kw)
    assert rounds == int(eager.rounds) and graph.replays > 0
    bd, _ = knn_brute(q.cpu().numpy(), pts, k, device=dev)
    np.testing.assert_allclose(np.sqrt(d2.cpu().numpy()), bd, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_jit_cache_bounds_device_memory():
    """Queries at many batch sizes keep at most ``CACHED_SHAPES`` captured
    rounds: the evicted ones give back their buffers and their graphs'
    memory pools, so device memory stays that of a full cache."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.jitsearch import CACHED_SHAPES

    dev = _device()
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(20000, 10)).astype(np.float32)
    q = rng.normal(size=(4000, 10)).astype(np.float32)
    index = KNNIndex.build(pts, IndexSpec(engine="jit", height=6, devices=(dev,)))
    held = []
    for i in range(3 * CACHED_SHAPES):
        m = 3000 + 10 * i
        res = index.query(q[:m], 10)
        assert res.dists.shape == (m, 10)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        held.append((torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)))
        assert len(index._state.rounds) == min(i + 1, CACHED_SHAPES)
    full = held[CACHED_SHAPES - 1]
    for alloc, reserved in held[CACHED_SHAPES:]:
        assert alloc <= 1.1 * full[0], (held, CACHED_SHAPES)
        assert reserved <= 1.1 * full[1], (held, CACHED_SHAPES)


@pytest.mark.cuda
def test_replayed_rounds_count_what_eager_rounds_count():
    """After ``warm`` captured the round, a query's device counts (every
    round a graph replay) equal those of the same queries run round by
    round eagerly: the replays count.  The replays past the fixed point add
    rounds run and no work."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.jitsearch import SYNC_EVERY, JitRounds
    from repro_torch.core.lazysearch import FP32_OVERFETCH

    from repro_torch.kernels import stamp

    dev = _device()
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(20000, 10)).astype(np.float32)
    q = rng.normal(size=(3000, 10)).astype(np.float32)
    index = KNNIndex.build(pts, IndexSpec(engine="jit", height=6, devices=(dev,)))
    stamp.reset_launches()
    index.warm(3000, 10)
    # the eager round and the capture pass the wrappers: five stamps and a
    # tally each; a replay passes none
    assert stamp.launches == {"stamp": 10, "tally": 2}
    state = index._state
    graph = state.rounds[(3000, 10 + FP32_OVERFETCH)]
    replays = graph.replays
    st = index.query(q, 10).stats
    assert graph.replays > replays and graph.eager_rounds == 1
    assert stamp.launches == {"stamp": 10, "tally": 2}
    eager = JitRounds(state.tree, 3000, 10 + FP32_OVERFETCH, tq=state.tq,
                      first_leaf_heap=state.top.first_leaf_heap)
    eager.reset(torch.from_numpy(q).to(dev))
    executed = 0
    while executed == 0 or bool(eager.live):
        eager.round()
        executed += 1
    want = eager._read(executed)
    got = graph.last
    assert (st.leaf_visits, st.useful_pairs, st.units_scanned) == (
        want.leaf_visits, want.useful_pairs, want.units_scanned)
    assert want.leaf_visits > 0 and want.units_scanned > 0
    np.testing.assert_array_equal(got.log, want.log)
    assert st.iterations == len(want.log) == executed
    assert executed <= st.steady_rounds < executed + SYNC_EVERY


@pytest.mark.cuda
def test_phase_stamps_lie_between_their_kernels_and_their_stamps():
    """Each phase's device seconds of a replayed query, held against a
    ``torch.profiler`` trace of the same rounds (``stamp.trace_bounds``):
    summed over the rounds, no less than the span of the phase's own
    kernels between its two stamps (first start to last end, the gaps
    included) and no more than the span from the earlier stamp's start to
    the later one's end, to within the clock's microsecond step at each
    stamp.  The trace holds five stamps a round executed, replays included,
    and the two bounds lie within 20 us of each other in every round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.jitsearch import PHASES
    from repro_torch.core.lazysearch import FP32_OVERFETCH
    from repro_torch.kernels.stamp import trace_bounds

    dev = _device()
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(2 ** 18, 10)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(2 ** 15, 10)).astype(np.float32)).to(dev)
    index = KNNIndex.build(pts, IndexSpec(engine="jit", devices=(dev,)))
    index.warm(2 ** 15, 10)
    rounds = index._state.rounds[(2 ** 15, 10 + FP32_OVERFETCH)]
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rounds.run(q)
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    inner, outer = trace_bounds(events)
    executed = rounds.last.executed
    assert inner.shape == (executed, len(PHASES))
    assert (outer - inner).max() < 20e-6, (outer - inner).max()
    step = 1e-6 * executed
    for p, (name, sec) in enumerate(rounds.last.phase_s):
        assert name == PHASES[p]
        lo, hi = inner[:, p].sum(), outer[:, p].sum()
        assert lo - step <= sec <= hi + step, (name, lo, sec, hi)
        assert lo > 0, name


@pytest.mark.cuda
def test_tally_kernel_equals_the_plain_tally():
    """The tally kernel adds what ``kernels/ops.py::tally`` adds on the
    CPU: the visits, the pairs and the units, into the row of the live
    round, the last row once the rounds pass it; one launch each call."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stamp

    dev = _device()
    rng = np.random.default_rng(10)
    sizes = torch.from_numpy(rng.integers(0, 4097, size=4096).astype(np.int32))
    want = torch.zeros((7, 3), dtype=torch.int64)
    got = want.to(dev)
    stamp.reset_launches()
    for r, m in [(1, 1), (2, 1000), (3, 2 ** 20 + 3), (5, 2 ** 18), (9, 2 ** 20), (40, 77)]:
        leaf = torch.from_numpy(rng.integers(-1, 4096, size=m).astype(np.int32))
        leaf[rng.random(m) < 0.7] = -1
        units = torch.tensor(int(rng.integers(0, 12288)), dtype=torch.int32)
        rounds = torch.tensor(r, dtype=torch.int32)
        kops.tally(want, leaf, sizes, units, rounds)
        kops.tally(got, leaf.to(dev), sizes.to(dev), units.to(dev), rounds.to(dev))
    torch.cuda.synchronize(dev)
    assert torch.equal(got.cpu(), want) and int(want[6, 0]) > 0
    assert stamp.launches == {"stamp": 0, "tally": 6}


@pytest.mark.cuda
def test_a_span_encloses_its_kernel_on_the_profilers_clock():
    """A host span (``repro_torch.tracing``, Unix nanoseconds) around a
    kernel and a synchronize holds the kernel's interval as
    ``torch.profiler`` reports it: the two share a clock, so spans can be
    laid over a device trace."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    dev = _device()
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("probe") as opened:
            (a @ a).sum()
            torch.cuda.synchronize(dev)
    (sp,) = [s for s in tracing.spans() if s.id == opened.id]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.name().startswith(("Memcpy", "Memset"))]
    assert kernels
    for e in kernels:
        assert sp.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= sp.end_ns, (
            e.name(), sp.start_ns, e.start_ns(), e.duration_ns(), sp.end_ns)


@pytest.mark.cuda
def test_jit_index_on_card_is_exact():
    """``KNNIndex`` with ``engine="jit"`` on the card against brute force,
    also far from the origin, where the certificate sends rows to brute
    force."""
    from repro_torch.api import IndexSpec, KNNIndex

    dev = _device()
    rng = np.random.default_rng(4)
    for offset in (0.0, 300.0):
        pts = (rng.normal(size=(20000, 10)) + offset).astype(np.float32)
        q = (rng.normal(size=(3000, 10)) + offset).astype(np.float32)
        res = KNNIndex.build(pts, IndexSpec(engine="jit", height=6, devices=(dev,))).query(q, 10)
        bd, bi = knn_brute(q, pts, 10, device=dev)
        np.testing.assert_allclose(res.dists, bd, rtol=1e-5, atol=1e-6)
        assert (res.idx == bi).mean() > 0.999
        assert (res.stats.exact_rows > 0) == (offset > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_dual_ops_on_card_equal_the_cpu(n_chunks):
    """radius, kde and pair_count on the card against the same ops on the
    CPU (lattice points: radius and pair_count bit for bit; kde within its
    fp32 rounding)."""
    from repro_torch.core.chunked import ChunkedLeafStore
    from repro_torch.core.dualtree import DualTree
    from repro_torch.core.toptree import build_top_tree

    dev = _device()
    rng = np.random.default_rng(9)
    pts = rng.integers(0, 12, size=(6000, 3)).astype(np.float32)
    q = rng.integers(0, 12, size=(700, 3)).astype(np.float32)
    tree = build_top_tree(pts, 5)
    edges = np.sqrt([0.5, 3.5, 7.5, 16.5, 32.5])
    r = float(np.sqrt(7.5))
    out = []
    for device in (torch.device("cpu"), dev):
        store = ChunkedLeafStore(tree.points_padded, n_chunks=n_chunks, uniform=True,
                                 leaf_sizes=tree.leaf_sizes(), device=device)
        dual = DualTree(tree, store)
        out.append((dual.radius(q, r), dual.kde(q, 1.5), dual.pair_count(edges)))
    (cr, ck, cp), (gr, gk, gp) = out
    for a, b in zip(cr[:3], gr[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(gk[0], ck[0], rtol=1e-5, atol=1e-9)
    assert gk[1] == ck[1]
    np.testing.assert_array_equal(gp[0], cp[0])
    for f in ("iterations", "flushes", "units_scanned", "points_scanned", "chunk_rounds"):
        assert getattr(gp[1], f) == getattr(cp[1], f), f


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["chunked", "host"])
def test_tile_wider_than_128_answers_as_128(engine):
    """IndexSpec(tile_q=256): the wrapper scans each 256-slot tile as two
    launches of 128 slots, and the index answers as at tile_q=128."""
    from repro_torch.api import IndexSpec, KNNIndex

    dev = _device()
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(30000, 10)).astype(np.float32)
    q = rng.normal(size=(4000, 10)).astype(np.float32)
    out = []
    for tq in (128, 256):
        index = KNNIndex.build(pts, IndexSpec(engine=engine, tile_q=tq, height=5,
                                              devices=(dev,)))
        knn_scan.reset_launches()
        out.append((index.query(q, 10), knn_scan.leaf_scan_units.launches))
    (r128, l128), (r256, l256) = out
    np.testing.assert_array_equal(r256.idx, r128.idx)
    np.testing.assert_array_equal(r256.dists, r128.dists)
    assert l128 > 0 and l256 > 0
    # the wide plan: its rows are the same kernel's, block by block
    x = torch.randn((6, 512, 10), device=dev)
    qpad = torch.randn((3000, 10), device=dev)
    ul = torch.arange(6, dtype=torch.int32, device=dev)
    uq = torch.randint(-1, 3000, (6, 300), dtype=torch.int32, device=dev)
    nu = torch.tensor(6, dtype=torch.int32, device=dev)
    knn_scan.reset_launches()
    kd, ki = knn_scan.leaf_scan_units(qpad, x, ul, uq, nu, k=10)
    assert knn_scan.leaf_scan_units.launches == 3 and kd.shape == (6, 300, 10)
    for s in range(0, 300, 128):
        bd, bi = knn_scan.leaf_scan_units(qpad, x, ul, uq[:, s:s + 128].contiguous(), nu, k=10)
        assert torch.equal(kd[:, s:s + 128], bd) and torch.equal(ki[:, s:s + 128], bi)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,n_chunks", [("fp32", 1), ("fp32", 3), ("int8", 1),
                                                 ("fp16", 3)])
def test_host_engine_on_card_is_exact(precision, n_chunks):
    """The host loop on the card: every scan the CUDA kernel, the answers
    exact against knn_brute."""
    from repro_torch.api import IndexSpec, KNNIndex

    dev = _device()
    rng = np.random.default_rng(13)
    pts = rng.normal(size=(40000, 10)).astype(np.float32)
    q = rng.normal(size=(5000, 10)).astype(np.float32)
    index = KNNIndex.build(pts, IndexSpec(engine="host", precision=precision,
                                          n_chunks=n_chunks, height=6, devices=(dev,)))
    knn_scan.reset_launches()
    res = index.query(q, 10)
    assert knn_scan.leaf_scan_units.launches >= res.stats.chunk_rounds > 0
    bd, bi = knn_brute(q, pts, 10, device=dev)
    np.testing.assert_allclose(res.dists, bd, rtol=1e-5, atol=1e-6)
    assert (res.idx == bi).mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("engine,precision", [("chunked", None), ("chunked", "int8"),
                                              ("host", None), ("jit", None), ("brute", None)])
def test_save_and_load_on_card_answer_bit_for_bit(engine, precision, tmp_path):
    from repro_torch.api import IndexSpec, KNNIndex

    dev = _device()
    rng = np.random.default_rng(14)
    pts = rng.normal(size=(20000, 10)).astype(np.float32)
    q = rng.normal(size=(2000, 10)).astype(np.float32)
    index = KNNIndex.build(pts, IndexSpec(engine=engine, precision=precision, height=5,
                                          devices=(dev,)))
    d0, i0 = index.query(q, 10)
    index.save(str(tmp_path))
    loaded = KNNIndex.load(str(tmp_path))
    d1, i1 = loaded.query(q, 10)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(i1, i0)


# ---------------------------------------------------------------------------
# the mutable index (core/dynamic.py) on the card
# ---------------------------------------------------------------------------
def _mutable_script(dev_list, precision, seed):
    """Build, insert, delete and query a mutable index on ``dev_list``
    (one or four slots of the card); every answer exact against knn_brute
    over the live points, the tree shards through the CUDA leaf scan."""
    from repro_torch.api import IndexSpec, KNNIndex

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(60000, 10)).astype(np.float32)
    q = rng.normal(size=(2000, 10)).astype(np.float32)
    live = np.zeros(len(pts), bool)
    index = KNNIndex.build(pts[:40000], IndexSpec(mutable=True, precision=precision,
                                                  k_hint=10, devices=tuple(dev_list)))
    live[:40000] = True
    for lo in range(40000, 60000, 4000):
        index.insert(pts[lo:lo + 4000])
        live[lo:lo + 4000] = True
        dels = rng.choice(np.nonzero(live)[0], 500, replace=False)
        index.delete(dels)
        live[dels] = False
    index.drain(timeout=300)
    knn_scan.reset_launches()
    res = index.query(q, 10)
    assert knn_scan.leaf_scan_units.launches > 0
    ids = np.nonzero(live)[0]
    bd, bi = knn_brute(q, pts[ids], 10, device=dev_list[0])
    np.testing.assert_allclose(res.dists, bd, rtol=1e-5, atol=1e-6)
    assert live[res.idx].all()
    assert (res.idx == ids[bi]).mean() > 0.999
    if precision in (None, "fp32"):
        assert res.stats.exact_rows == 0
    return index


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "int8"])
def test_mutable_index_on_card_is_exact(precision):
    dev = _device()
    index = _mutable_script([dev], precision, seed=21)
    assert index.engine_name == "dynamic"
    assert {s.device.type for s in index._state._shards} == {"cuda"}


@pytest.mark.cuda
def test_mutable_index_on_four_slots_of_the_card_is_exact():
    dev = _device()
    index = _mutable_script([dev] * 4, None, seed=22)
    assert index.plan.n_devices == 4
    assert len({slot for _, kind, slot in index._state.placement() if kind == "tree"}) >= 2


@pytest.mark.cuda
def test_merge_swapped_in_while_a_query_runs():
    """A background merge builds its staging shard on the card and swaps it
    in while another thread queries the forest: every answer exact, and
    the swapped shard answers from its first query on."""
    import threading

    from repro_torch.core.dynamic import DynamicIndex

    dev = _device()
    rng = np.random.default_rng(23)
    pts = rng.normal(size=(40000, 8)).astype(np.float32)
    idx = DynamicIndex(8, base_capacity=1024, brute_cutoff=2048, devices=[dev],
                       merge_async=True)
    idx.insert(pts[:20000])
    q = rng.normal(size=(512, 8)).astype(np.float32)
    errors, answers = [], []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                answers.append(idx.query(q, 10)[:2])
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    t = threading.Thread(target=reader)
    t.start()
    for lo in range(20000, 40000, 2500):
        idx.insert(pts[lo:lo + 2500])
    idx.drain_merges(timeout=300)
    stop.set()
    t.join(300)
    assert not errors, errors
    assert idx.merge_stats()["completed"] >= 2 and answers
    # answers taken while merges ran are exact for the points live then
    # (a prefix of pts); the one after the drain is exact for all
    bd, _ = knn_brute(q, pts, 10, device=dev)
    dd, _, _ = idx.query(q, 10)
    np.testing.assert_allclose(dd, bd, rtol=1e-5, atol=1e-6)
    for dd, _ in answers:
        assert np.all(dd >= bd - 1e-5)


@pytest.mark.cuda
def test_launch_counts_summed_across_fanout_threads():
    """Four slots of the card queried by the fan-out's four threads: the
    launch counts equal the sum of each shard's own rounds."""
    from repro_torch.core.dynamic import DynamicIndex

    dev = _device()
    rng = np.random.default_rng(24)
    idx = DynamicIndex(10, base_capacity=1024, brute_cutoff=2048, devices=[dev] * 4)
    for n in (32768, 16384, 8192, 4096):
        idx.insert(rng.normal(size=(n, 10)).astype(np.float32))
    trees = [s for s in idx._shards if s.kind == "tree"]
    assert len({s.slot for s in trees}) == 4
    q = rng.normal(size=(4096, 10)).astype(np.float32)
    knn_scan.reset_launches()
    idx.query(q, 10)
    torch.cuda.synchronize()
    per_shard = sum(s.engine.stats.chunk_rounds for s in trees)
    assert knn_scan.leaf_scan_units.launches == per_shard > 0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["forest", "sharded", "ring"])
def test_multi_device_engines_on_four_slots_of_the_card(engine):
    """The multi-device engines on ``(cuda:0,) * 4`` (a thread and a stream
    per slot) against the same engine on one slot and against knn_brute:
    the same distances, ids bit for bit on ``sharded`` and ``ring`` (up to
    ties on the forest, whose shards change with the slot count); every
    scan of the query the CUDA kernel (launched by the wrapper, or replayed
    in the forest's graphs: one per slot, captured by the warm while the
    other slots run)."""
    from repro_torch.api import IndexSpec, KNNIndex

    dev = _device()
    rng = np.random.default_rng(31)
    pts = rng.normal(size=(40000, 10)).astype(np.float32)
    q = rng.normal(size=(3000, 10)).astype(np.float32)
    one = KNNIndex.build(pts, IndexSpec(engine=engine, devices=(dev,))).query(q, 10)
    four = KNNIndex.build(pts, IndexSpec(engine=engine, devices=(dev,) * 4))
    four.warm(q.shape[0], 10)
    torch.cuda.synchronize()
    rounds = ([r for sh in four._state.shards for r in sh.rounds.values()]
              if engine == "forest" else [])
    before = [(r.eager_rounds, r.replays) for r in rounds]
    knn_scan.reset_launches()   # the query's own launches, not the warm's
    res = four.query(q, 10)
    if engine == "forest":
        # the warm captured every slot's round: the query only replays
        # graphs (which launch the kernel without the wrapper)
        assert knn_scan.leaf_scan_units.launches == 0
        assert all(r.eager_rounds == e for r, (e, _) in zip(rounds, before))
        assert all(r.replays > p for r, (_, p) in zip(rounds, before))
    else:
        assert knn_scan.leaf_scan_units.launches > 0
    bd, bi = knn_brute(q, pts, 10, device=dev)
    np.testing.assert_allclose(res.dists, bd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.dists, one.dists, rtol=1e-5, atol=1e-6)
    d_of_idx = np.sqrt(np.sum((q[:, None, :] - pts[res.idx]) ** 2, -1))
    np.testing.assert_allclose(d_of_idx, bd, rtol=1e-5, atol=1e-6)
    if engine == "forest":
        graphs = [r.graph for sh in four._state.shards for r in sh.rounds.values()]
        assert len(graphs) == 4 and all(g is not None for g in graphs)
        assert res.stats.exact_rows == 0
    else:
        assert np.array_equal(res.dists, one.dists) and np.array_equal(res.idx, one.idx)
    assert four.resident_bytes() > 0 and len(four._state.slot_seconds) == 4


@pytest.mark.cuda
def test_knnlm_datastore_queries_launch_the_narrow_kernel():
    """A smoke-size kNN-LM on the card: the datastore (8192 keys of the
    projected hidden states, d = 16) goes on the LM's device, its queries
    launch the narrow leaf-scan kernel and are exact against knn_brute,
    and the interpolated rows sum to 1."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serving import KNNLM

    dev = _device()
    lm = LanguageModel(get_config("qwen15_0_5b", smoke=True))
    assert lm.device == dev
    knn = KNNLM(lm, proj_dim=16, k=10)
    corpus = np.random.default_rng(0).integers(
        0, lm.cfg.vocab_size, size=(64, 129)).astype(np.int32)
    knn.build_datastore(corpus)
    assert knn.index.spec.devices == (dev,) and knn.index.plan.engine == "chunked"
    keys = knn.embed_contexts(corpus[:, :-1])
    knn_scan.reset_launches()
    dd, di = knn.index.query(keys[:512], k=10)
    variants = dict(knn_scan.leaf_scan_units.launches_by_variant)
    assert variants and all(v.startswith("narrow<") for v in variants), variants
    bd, _ = knn_brute(keys[:512], keys, 10, device=dev)
    np.testing.assert_allclose(dd, bd, **TOL)
    p = knn.next_token_probs(corpus[:8, :32])
    assert p.shape == (8, lm.cfg.vocab_size) and (p >= 0).all()
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-3)


def _smoke_pair(arch, dev):
    """The fp32 smoke model of ``arch`` on the CPU and the same weights on
    ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    cpu = LanguageModel(cfg, device=torch.device("cpu"),
                        generator=torch.Generator().manual_seed(0))
    card = LanguageModel(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _rel(a, b):
    return float((a.float().cpu() - b.float().cpu()).norm() / max(float(b.float().norm()),
                                                                   1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen15_0_5b", "olmoe_1b_7b", "mamba2_370m",
                                  "recurrentgemma_9b"])
def test_train_step_on_card_matches_the_cpu(arch):
    """Three fp32 train steps of a smoke model (remat "full") on the card
    and on the CPU from the same weights and batches: losses and grad norms
    within 1e-4 relative, each parameter tensor within 1e-4 of its norm
    (the attention key bias aside: its gradient is 0 in exact arithmetic)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.training import Hyper, adamw_init, build_train_step

    dev = _device()
    models = _smoke_pair(arch, dev)
    pipe = TokenPipeline(models[0].cfg.vocab_size, 32, 4, seed=1)
    h = Hyper(lr=1e-2, warmup_steps=1, total_steps=6)
    metrics = []
    for lm in models:
        step = build_train_step(lm, h)
        opt = adamw_init(dict(lm.named_parameters()))
        assert opt["m"]["embed.embedding"].device == lm.device
        metrics.append([step(opt, pipe.global_batch_at(t), t) for t in range(3)])
    for mc, mg in zip(*metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-4, err_msg=k)
    card = models[1].state_dict()
    for k, v in models[0].state_dict().items():
        if not k.endswith("b_k"):
            assert _rel(card[k], v) <= 1e-4, k


@pytest.mark.cuda
def test_checkpoint_saved_on_cpu_restores_onto_the_card(tmp_path):
    """A CPU run's checkpoint (params and AdamW state) restored onto the
    card bit for bit, and the next step there matches the CPU's next step."""
    from repro_torch.data import TokenPipeline
    from repro_torch.training import CheckpointManager, Hyper, adamw_init, build_train_step

    dev = _device()
    cpu, card = _smoke_pair("qwen15_0_5b", dev)
    pipe = TokenPipeline(cpu.cfg.vocab_size, 32, 4, seed=2)
    h = Hyper(lr=1e-2, warmup_steps=1, total_steps=6)
    step = build_train_step(cpu, h)
    opt = adamw_init(dict(cpu.named_parameters()))
    for t in range(2):
        step(opt, pipe.global_batch_at(t), t)
    ck = CheckpointManager(str(tmp_path))
    ck.save(2, {"params": cpu.state_dict(), "opt": opt}, extra={"data_step": 2}, block=True)
    card_opt = adamw_init(dict(card.named_parameters()))
    got, man = ck.restore({"params": card.state_dict(), "opt": card_opt})
    assert got["opt"]["m"]["embed.embedding"].device == dev and man["extra"]["data_step"] == 2
    for k, v in cpu.state_dict().items():
        assert torch.equal(got["params"][k].cpu(), v), k
        assert torch.equal(got["opt"]["v"][k].cpu(), opt["v"][k]), k
    card.load_state_dict(got["params"])
    mg = build_train_step(card, h)(got["opt"], pipe.global_batch_at(2), 2)
    mc = step(opt, pipe.global_batch_at(2), 2)
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "mamba2_370m",
                                  "recurrentgemma_9b", "llava_next_mistral_7b"])
def test_family_decode_on_card_matches_the_cpu(arch):
    """Each family that decodes, fp32 smoke size: prefill of 20 tokens (and
    the image prefix) then 6 decode steps with per-row positions and one
    row inactive on odd steps, on the card against the CPU (logits and
    states within 1e-4)."""
    from repro_torch.models.transformer import grow_cache

    dev = _device()
    models = _smoke_pair(arch, dev)
    cfg = models[0].cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20))}
    if cfg.frontend == "vision":
        batch["frontend_feats"] = rng.normal(size=(2, cfg.frontend_tokens, cfg.frontend_dim)
                                             ).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab_size, (6, 2))
    outs, states = [], []
    for lm in models:
        logits, caches = lm.prefill(batch)
        caches = grow_cache(caches, cfg, 40)
        pos = np.full(2, 20 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0))
        seq = [logits]
        for t in range(6):
            active = np.array([True, t % 2 == 0])
            lg, caches = lm.decode_step({"tokens": nxt[t][:, None], "pos": pos,
                                         "active": active}, caches)
            seq.append(lg)
            pos = pos + active
        outs.append(seq)
        states.append(caches)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4, atol=1e-4)
    for a, b in zip(*states):
        for name in a:
            np.testing.assert_allclose(b[name].float().cpu().numpy(), a[name].float().numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tp", "zero1", "mp_zero1", "fsdp"])
def test_sharded_lm_on_four_slots_of_the_card_matches_one_slot(mode):
    """Qwen1.5 smoke in fp32 on a 2 x 2 mesh of four slots of cuda:0
    (``ShardedLM``): the forward's logits within 1e-4 (in norm) of the
    one-slot model's on the card, and one ``make_sharded_train_step``
    (``mode``) against ``build_train_step`` on one slot: the loss within
    1e-5, the update within 1e-2 of its norm (the first AdamW step moves
    each weight by about lr times the sign of its gradient)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.mesh import SlotMesh
    from repro_torch.models import LanguageModel
    from repro_torch.training import (
        Hyper,
        adamw_init,
        build_train_step,
        make_sharded_train_step,
        sharded_adamw_init,
    )

    dev = _device()
    cfg = get_config("qwen15_0_5b", smoke=True).replace(dtype="float32")
    if mode == "mp_zero1":
        cfg = cfg.replace(param_dtype="bfloat16")
    one = LanguageModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    start = {k: v.detach().clone() for k, v in one.state_dict().items()}
    batch = TokenPipeline(cfg.vocab_size, 32, 4, seed=1).global_batch_at(0)
    h = Hyper(lr=1e-2, warmup_steps=1, total_steps=6)
    mesh = SlotMesh((dev,) * 4, {"data": 2, "model": 2})
    lm = LanguageModel(cfg, tp=2, device=dev)
    lm.load_state_dict(start)
    step, specs = make_sharded_train_step(lm, h, mesh, param_mode=mode)
    slm = lm.shard(specs["dist"], specs["params"])
    with torch.no_grad():
        want, got = one(batch)[0], slm.forward(batch)[0]
    assert got.device == dev
    assert _rel(got, want) <= 1e-4
    m1 = build_train_step(one, h)(adamw_init(dict(one.named_parameters()),
                                             master_fp32=mode == "mp_zero1"), batch, 1)
    m4 = step(slm, sharded_adamw_init(slm, specs["opt"]), batch, 1)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-5)
    num = den = 0.0
    after = slm.state_dict(dev)
    for k, v in one.state_dict().items():
        if k.endswith("b_k"):
            continue
        num += float((after[k].float() - v.float()).square().sum())
        den += float((v.float() - start[k].float()).square().sum())
    assert (num / den) ** 0.5 <= 1e-2
