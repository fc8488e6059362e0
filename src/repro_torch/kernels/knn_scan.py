"""Leaf-scan kernel wrapper: the buffered brute-force kNN scan on Hopper.

Counterpart of ``repro.kernels.knn_scan`` (the Pallas TPU kernel
``leaf_scan_pallas``).  The CUDA kernels are in ``csrc/leaf_scan.cu``; its
source note says what bounds them and how they are laid out.

Two call forms, one kernel:

* ``leaf_scan_units(qpad, slab, unit_leaf, unit_query, n_units, k=)`` —
  the indexed form the chunk round uses: the kernel reads query rows and
  leaf slabs through the work plan's indices, so no gathered copies of the
  query tiles or slabs are made, and it skips plan rows at or beyond the
  device scalar ``n_units``.
* ``leaf_scan_cuda(q, leaf_pts, k=)`` — the work-unit contract of
  ``leaf_scan_pallas`` (q f32[W, TQ, d], leaf_pts f32[W, L_pad, d]
  -> f32[W, TQ, k], i32[W, TQ, k]), the same kernel with identity indices.

Both launch the kernel or raise: they take CUDA tensors only, any
1 <= k <= L_pad, any d >= 1 and any TQ (a tile wider than 128 query slots
is scanned as blocks of at most 128, one launch each).  The slab may hold fp32 rows or
the budgeted store's codes (``core/chunked.py``): float16, or uint8 with a
per-leaf scale and offset, each with the bit-packed dead-row mask.  The
kernel reads the codes and dequantizes them as it stages a tile; the plain
version dequantizes the gathered slabs as the reference's round does
(``repro/core/chunked_jit.py::_chunk_round``) and scans them.  ``choose_variant`` is the one
place that picks the kernel instance, block width, list placement and
shared memory for a call; it runs without a card.  The plain version is
``leaf_scan_units_ref``; ``kernels/ops.py`` picks between the two by the
tensors' device.  ``_extract_topk`` and ``_rank_merge`` are the Pallas
kernel's selection helpers as plain torch functions; ``_rank_merge`` is
also called on its own by the dynamic index.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Tuple

import torch

from repro_torch.core.quantize import unpack_dead
from repro_torch.kernels import build
from repro_torch.kernels.ref import INVALID_DIST, PAD_COORD, leaf_scan_ref

__all__ = [
    "leaf_scan_units",
    "leaf_scan_units_ref",
    "leaf_scan_cuda",
    "dequantize",
    "reset_launches",
    "choose_variant",
    "CODES",
    "build_all",
    "Variant",
    "DEFAULT_TQ",
]

DEFAULT_TQ = 128
_BIG_I = 2**30
_REF_BLOCK = 256   # plan rows per step of the plain version (bounds memory)

# The kernel library's instances and sizes (csrc/leaf_scan.cu).
MAX_TQ = 128
SMEM_LIMIT = 232_448             # dynamic shared memory one block may use
NARROW_WIDTHS = (2, 4, 6, 8, 10, 12, 14, 16)
REG_KMAX = (4, 8, 10, 16)        # register-list lengths
TILE = 64                        # narrow: slab rows per pipeline stage
WIDE_ROWS = 32                   # wide: slab rows per piece (one filter pass)
WIDE_FC = 128                    # wide: features per piece where whole rows do not fit
WIDE_THREADS = 128               # wide: threads per block (one query slot each)
_KINDS = {"narrow": 0, "wide": 1}
_LIST_AT = {"reg": 0, "smem": 1, "out": 2}
# slab code types: name -> (csrc Code, bytes per coordinate, torch dtype)
CODES = {"f32": (0, 4, torch.float32), "f16": (1, 2, torch.float16),
         "u8": (2, 1, torch.uint8)}
_CODE_OF_DTYPE = {dt: name for name, (_, _, dt) in CODES.items()}


@dataclasses.dataclass(frozen=True)
class Variant:
    """One launch of the leaf-scan library: ``kind`` "narrow" (rows of
    d <= ``width`` staged whole) or "wide" (rows staged whole for
    ``width`` 0, else in chunks of ``width`` features); ``list_at`` "reg"
    (a sorted list of ``kmax`` entries in registers), "smem" or "out" (a
    heap of 64-bit keys in shared memory or in the output rows); ``qpt``
    query slots per thread (narrow: 2 with a register list, else 1; wide:
    1, ``WIDE_THREADS`` threads), ``threads`` per block, ``smem_bytes`` of
    dynamic shared memory."""

    kind: str
    width: int
    kmax: int
    qpt: int
    list_at: str
    threads: int
    smem_bytes: int
    code: str = "f32"

    @property
    def name(self) -> str:
        suffix = "" if self.code == "f32" else f"/{self.code}"
        if self.kind == "wide":
            lst = f"{self.kmax}>/reg" if self.list_at == "reg" else f"heap>/{self.list_at}"
            rows = f"/chunk{self.width}" if self.width else ""
            return f"wide<{lst}{rows}{suffix}"
        if self.list_at == "reg":
            return f"narrow<{self.width},{self.kmax}>/reg{suffix}"
        return f"narrow<{self.width},heap>/{self.list_at}{suffix}"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _raw_region_bytes(code: str, d: int) -> int:
    """Narrow kernel: shared memory before the staged rows
    (csrc/leaf_scan.cu ``raw_region_bytes``).  fp32: two raw tiles.
    Codes: the uint8 scale and offset of the leaf, then two raw byte tiles
    with 4 bytes of slack for an unaligned start, 16-byte aligned."""
    es = CODES[code][1]
    if code == "f32":
        return 2 * TILE * d * 4
    meta = 4 * _round_up(2 * d, 4) if code == "u8" else 0
    return meta + 2 * _round_up(TILE * d * es + 4, 16)


def _wide_base_bytes(code: str, d: int, width: int, slots: int) -> int:
    """Wide kernel, shared memory besides a heap (csrc/leaf_scan.cu
    ``smem_needed``): -2q of every slot when rows are staged whole (``width``
    0), the staged pieces (fp32: two, codes: one; rows of ``fc`` features
    padded by 4 where fc / 4 is even, so that 4 consecutive rows' loads
    fall in distinct banks), and with whole rows of codes the raw byte
    tiles and u8 metadata."""
    dp = _round_up(d, 4)
    fc = width or dp
    rs = fc if (fc // 4) % 2 else fc + 4
    b = (4 * slots * dp if width == 0 else 0) + 4 * (2 if code == "f32" else 1) * WIDE_ROWS * rs
    if code != "f32" and width == 0:
        meta = 4 * _round_up(2 * d, 4) if code == "u8" else 0
        b += meta + 2 * _round_up(WIDE_ROWS * d * CODES[code][1] + 4, 16)
    return b


def choose_variant(d: int, k: int, tq: int, l_pad: int, code: str = "f32") -> Variant:
    """The kernel launch for rows of width ``d`` stored as ``code`` ("f32",
    "f16" or "u8"), lists of ``k``, ``tq`` query slots and ``l_pad`` slab
    rows.  Rows of d <= 16 take the narrow kernel at d rounded up to even:
    k <= 16 a register list with two queries per thread; longer lists a
    heap of 64-bit keys with one query per thread, in shared memory while
    it fits (k up to 216 at TQ = 128), else in the output rows.  Wider rows
    take the wide kernel with the same lists (``WIDE_THREADS`` threads, one
    slot each): rows staged whole while that fits in shared memory, else in
    chunks of ``WIDE_FC`` features.  The code type changes only the raw
    tile bytes (and the wide kernel's staged buffers)."""
    if code not in CODES:
        raise ValueError(f"code={code!r}: the leaf scan reads {sorted(CODES)}")
    if not 1 <= k <= l_pad:
        raise ValueError(f"k={k}: the leaf scan takes 1 <= k <= L_pad={l_pad}")
    if d < 1:
        raise ValueError(f"d={d}: rows need at least one feature")
    if not 1 <= tq <= MAX_TQ:
        raise ValueError(f"TQ={tq}: one launch of the CUDA leaf scan takes 1 <= TQ <= "
                         f"{MAX_TQ} (one block per query tile; leaf_scan_units scans a "
                         "wider tile in blocks)")
    kmax = next((km for km in REG_KMAX if km >= k), 0)
    if d <= NARROW_WIDTHS[-1]:
        width = d + d % 2
        kind, qpt = "narrow", 2 if kmax else 1
        threads = max(32, _round_up(-(-tq // qpt), 32))
        base = _raw_region_bytes(code, d) + 4 * 2 * TILE * _round_up(width + 1, 4)
    else:
        kind, qpt, threads = "wide", 1, WIDE_THREADS
        width = 0 if _wide_base_bytes(code, d, 0, qpt * threads) <= SMEM_LIMIT else WIDE_FC
        base = _wide_base_bytes(code, d, width, qpt * threads)
    if kmax:
        return Variant(kind, width, kmax, qpt, "reg", threads, base, code)
    in_smem = base + 8 * k * qpt * threads
    if in_smem <= SMEM_LIMIT:
        return Variant(kind, width, 0, qpt, "smem", threads, in_smem, code)
    return Variant(kind, width, 0, qpt, "out", threads, base, code)


def _extract_topk(cand_d, cand_i, k):
    """k min-extraction passes over [TQ, width] candidates; sorted
    ascending ([TQ, k], [TQ, k]), ties to the first position."""
    tq, width = cand_d.shape
    pos = torch.arange(width, dtype=torch.int32, device=cand_d.device).expand(tq, width)
    big = torch.full_like(pos, _BIG_I)
    out_d, out_i = [], []
    for _ in range(k):
        mn = torch.min(cand_d, dim=1).values
        am = torch.min(torch.where(cand_d == mn[:, None], pos, big), dim=1).values
        hit = pos == am[:, None]
        iv = torch.min(torch.where(hit, cand_i, big), dim=1).values
        out_d.append(mn[:, None])
        out_i.append(iv[:, None])
        cand_d = torch.where(hit, INVALID_DIST * 100.0, cand_d)
    return torch.cat(out_d, dim=1), torch.cat(out_i, dim=1)


def _rank_merge(a_d, a_i, b_d, b_i, k):
    """Merge two sorted-ascending k-lists by rank arithmetic, keeping the k
    smallest; ``a`` wins ties.  Merged rank of a[i] is i + |{j: b[j] < a[i]}|,
    of b[j] is j + |{i: a[i] <= b[j]}|."""
    tq = a_d.shape[0]
    pos_k = torch.arange(k, dtype=torch.int32, device=a_d.device).expand(tq, k)
    ra = pos_k.clone()
    rb = pos_k.clone()
    for j in range(k):
        ra = ra + (b_d[:, j : j + 1] < a_d).to(torch.int32)
        rb = rb + (a_d[:, j : j + 1] <= b_d).to(torch.int32)
    out_d = torch.full((tq, k), INVALID_DIST * 10.0, dtype=torch.float32,
                       device=a_d.device)
    out_i = torch.full((tq, k), _BIG_I, dtype=torch.int32, device=a_d.device)
    for j in range(k):
        hit_a = ra[:, j : j + 1] == pos_k
        out_d = torch.where(hit_a, a_d[:, j : j + 1], out_d)
        out_i = torch.where(hit_a, a_i[:, j : j + 1], out_i)
        hit_b = rb[:, j : j + 1] == pos_k
        out_d = torch.where(hit_b, b_d[:, j : j + 1], out_d)
        out_i = torch.where(hit_b, b_i[:, j : j + 1], out_i)
    return out_d, out_i


def dequantize(slabs, scale=None, offset=None, dead=None) -> torch.Tensor:
    """Gathered slabs as the scan sees them (the reference round's
    dequantize, ``repro/core/chunked_jit.py::_chunk_round``): fp32 as is;
    codes cast to fp32, times ``scale`` plus ``offset`` (u8, [.., d], two
    roundings), and dead rows (``dead`` u8[.., ceil(L_pad/8)] packed) set to
    PAD_COORD."""
    if slabs.dtype == torch.float32:
        return slabs
    x = slabs.float()
    if scale is not None:
        x = x * scale[..., None, :] + offset[..., None, :]
    rows_dead = unpack_dead(dead, slabs.shape[-2])
    return torch.where(rows_dead[..., None], PAD_COORD, x)


def _check_meta(slab, scale, offset, dead) -> str:
    """The slab's code name, after checking it carries the metadata its
    code needs: dead rows for codes, scale and offset for u8 only."""
    code = _CODE_OF_DTYPE.get(slab.dtype)
    if code is None:
        raise ValueError(f"the leaf scan reads slabs of {sorted(CODES)}, got {slab.dtype}")
    if (dead is None) != (code == "f32"):
        raise ValueError(f"a {code} slab {'carries no' if code == 'f32' else 'needs a'} "
                         "dead-row mask")
    if (scale is None, offset is None) != ((code != "u8"),) * 2:
        raise ValueError("scale and offset go with a u8 slab, and only with it")
    return code


def leaf_scan_units_ref(
    qpad: torch.Tensor,
    slab: torch.Tensor,
    unit_leaf: torch.Tensor,
    unit_query: torch.Tensor,
    n_units: torch.Tensor,
    *,
    k: int,
    scale=None,
    offset=None,
    dead=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the indexed leaf scan.  Scans every plan row (rows
    at or beyond ``n_units`` too: their values are never read), gathering
    query tiles (zeros for empty slots) and slabs a block of rows at a
    time; code slabs are dequantized after the gather (``dequantize``)."""
    _check_meta(slab, scale, offset, dead)
    out_d, out_i = [], []
    for s in range(0, unit_leaf.shape[0], _REF_BLOCK):
        uq = unit_query[s : s + _REF_BLOCK]
        ul = unit_leaf[s : s + _REF_BLOCK].long()
        q = torch.where(
            (uq >= 0)[..., None], qpad[uq.clamp(min=0).long()], 0.0
        )
        x = dequantize(
            slab[ul],
            None if scale is None else scale[ul],
            None if offset is None else offset[ul],
            None if dead is None else dead[ul],
        )
        d, i = leaf_scan_ref(q, x, k=k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _part(v: Variant) -> Tuple[str, Tuple[str, ...]]:
    """The library holding ``v``'s instance: one per narrow width, one for
    the wide kernel (csrc/leaf_scan.cu, LEAF_SCAN_PART)."""
    return "leaf_scan", (f"LEAF_SCAN_PART={v.width if v.kind == 'narrow' else 0}",)


def build_all() -> Tuple[float, list]:
    """Build every leaf-scan library at once (one nvcc each) and load them;
    returns the wall seconds and the ``build.KernelLibrary``s."""
    specs = [("leaf_scan", (f"LEAF_SCAN_PART={p}",)) for p in (*NARROW_WIDTHS, 0)]
    wall = build.build_all(specs)
    return wall, [build.load(*s) for s in specs]


def _lib(v: Variant) -> ctypes.CDLL:
    lib = build.load(*_part(v)).lib
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.leaf_scan_units.argtypes = [p] * 7 + [i] * 13 + [p] * 4
        lib.leaf_scan_units.restype = i
        lib.leaf_scan_error_string.argtypes = [i]
        lib.leaf_scan_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_cuda_args(qpad, slab, unit_leaf, unit_query, n_units, scale, offset,
                     dead) -> None:
    dev = qpad.device
    c, l_pad, d = slab.shape if slab.dim() == 3 else (0, 0, 0)
    checks = [
        ("qpad", qpad, torch.float32, 2),
        ("slab", slab, slab.dtype, 3),
        ("unit_leaf", unit_leaf, torch.int32, 1),
        ("unit_query", unit_query, torch.int32, 2),
        ("n_units", n_units, torch.int32, None),
    ]
    for name, t, dtype, shape in (("scale", scale, torch.float32, (c, d)),
                                  ("offset", offset, torch.float32, (c, d)),
                                  ("dead", dead, torch.uint8, (c, -(-l_pad // 8)))):
        if t is not None:
            checks.append((name, t, dtype, 2))
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape} for slab {tuple(slab.shape)}, "
                                 f"got {tuple(t.shape)}")
    for name, t, dtype, ndim in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qpad on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if ndim is not None and t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if n_units.numel() != 1:
        raise ValueError("n_units must hold one element")
    if slab.shape[2] != qpad.shape[1]:
        raise ValueError(f"width mismatch: qpad {tuple(qpad.shape)} slab {tuple(slab.shape)}")
    if unit_query.shape[0] != unit_leaf.shape[0]:
        raise ValueError("unit_leaf and unit_query disagree on the plan rows")


def leaf_scan_units(
    qpad: torch.Tensor,
    slab: torch.Tensor,
    unit_leaf: torch.Tensor,
    unit_query: torch.Tensor,
    n_units: torch.Tensor,
    *,
    k: int,
    scale=None,
    offset=None,
    dead=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indexed leaf scan over a work plan.

    qpad f32[m, d]; slab [C, L_pad, d] (rows at the points' own width) of
    f32, or of f16 / u8 codes with ``dead`` u8[C, ceil(L_pad/8)] (packed
    dead rows) and, for u8, ``scale`` / ``offset`` f32[C, d], all indexed
    by the slab's leaf; unit_leaf i32[W] (leaf of ``slab``); unit_query
    i32[W, TQ] (row of ``qpad``, -1 = empty slot); n_units i32 scalar.
    Returns (f32[W, TQ, k], i32[W, TQ, k]) for plan rows < n_units; rows
    beyond are left unwritten by the kernel.  ``choose_variant`` picks the
    launch; a tile wider than ``MAX_TQ`` query slots is scanned as blocks
    of at most ``MAX_TQ`` slots, one launch each.  ``launches`` counts every
    launch, ``launches_by_code`` those of each code type,
    ``launches_by_instance`` those of each (code type, k), keyed
    ``"f32_k12"`` (the wide kernel's ``"f32_d30_k16"``), and
    ``launches_by_variant`` those of each ``Variant.name``.
    """
    if qpad.device.type != "cuda":
        raise ValueError(
            f"the CUDA leaf scan takes CUDA tensors, got {qpad.device} "
            "(ops.leaf_scan_units runs the plain version on the CPU)"
        )
    _check_cuda_args(qpad, slab, unit_leaf, unit_query, n_units, scale, offset, dead)
    code = _check_meta(slab, scale, offset, dead)
    c, l_pad, d = slab.shape
    tq = unit_query.shape[1]
    if tq <= MAX_TQ:
        v = choose_variant(d, k, tq, l_pad, code)
        return _launch(v, qpad, slab, unit_leaf, unit_query, n_units, k, scale, offset,
                       dead)
    # a wider tile: one launch per block of at most MAX_TQ query slots; every
    # slot's list is its own, so the blocks' rows are put side by side
    parts = [leaf_scan_units(qpad, slab, unit_leaf, unit_query[:, s : s + MAX_TQ].contiguous(),
                             n_units, k=k, scale=scale, offset=offset, dead=dead)
             for s in range(0, tq, MAX_TQ)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def _launch(v: Variant, qpad, slab, unit_leaf, unit_query, n_units, k, scale, offset,
            dead) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the instance ``v`` on checked arguments and count it."""
    w, tq = unit_query.shape
    c, l_pad, d = slab.shape
    code = v.code
    out_d = torch.empty((w, tq, k), dtype=torch.float32, device=qpad.device)
    out_i = torch.empty((w, tq, k), dtype=torch.int32, device=qpad.device)
    lib = _lib(v)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.leaf_scan_units(
        qpad.data_ptr(), slab.data_ptr(), unit_leaf.data_ptr(),
        unit_query.data_ptr(), n_units.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), w, tq, l_pad, d, k, _KINDS[v.kind], v.width,
        v.kmax, v.qpt, _LIST_AT[v.list_at], v.threads, v.smem_bytes,
        CODES[code][0], ptr(scale), ptr(offset), ptr(dead),
        torch.cuda.current_stream(qpad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"leaf_scan kernel launch failed ({err}, {v.name}): "
            f"{lib.leaf_scan_error_string(err).decode()}"
        )
    count_launch(code, f"{code}_k{k}" if v.kind == "narrow" else f"{code}_d{d}_k{k}",
                 v.name)
    return out_d, out_i


# the counts are read-modify-writes of shared dicts, and the mutable index
# launches from several threads (one per device slot of its fan-out, and its
# merge worker): one lock keeps each launch counted once
_COUNT_LOCK = threading.Lock()


def count_launch(code: str, instance: str, variant: str) -> None:
    """Add one launch to the counts of ``leaf_scan_units``: in all, for the
    code type, the (code type, k) instance and the variant name."""
    w = leaf_scan_units
    with _COUNT_LOCK:
        w.launches += 1
        w.launches_by_code[code] += 1
        w.launches_by_instance[instance] = w.launches_by_instance.get(instance, 0) + 1
        w.launches_by_variant[variant] = w.launches_by_variant.get(variant, 0) + 1


def reset_launches() -> None:
    """Set the launch counts of ``leaf_scan_units`` to 0."""
    with _COUNT_LOCK:
        leaf_scan_units.launches = 0
        leaf_scan_units.launches_by_code = dict.fromkeys(CODES, 0)
        leaf_scan_units.launches_by_instance = {}
        leaf_scan_units.launches_by_variant = {}


# kernel launches (not plain-version calls), in all, per code type, per
# (code type, k) and per variant
reset_launches()


def leaf_scan_cuda(
    q: torch.Tensor, leaf_pts: torch.Tensor, *, k: int, scale=None, offset=None,
    dead=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``leaf_scan_pallas``'s work-unit contract: the kernel with identity
    indices (unit w scans query tile w against slab w); code slabs take
    their metadata as ``leaf_scan_units`` does."""
    w, tq, d = q.shape
    dev = q.device
    unit_leaf = torch.arange(w, dtype=torch.int32, device=dev)
    unit_query = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    n_units = torch.tensor([w], dtype=torch.int32, device=dev)
    return leaf_scan_units(
        q.reshape(w * tq, d).contiguous(), leaf_pts.contiguous(),
        unit_leaf, unit_query, n_units, k=k, scale=scale, offset=offset, dead=dead,
    )
