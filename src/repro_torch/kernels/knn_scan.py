"""Leaf-scan kernel wrapper: the buffered brute-force kNN scan on Hopper.

Counterpart of ``repro.kernels.knn_scan`` (the Pallas TPU kernel
``leaf_scan_pallas``).  The CUDA kernel is ``csrc/leaf_scan.cu``; its
source note says what bounds it and how it is laid out.

Two call forms, one kernel:

* ``leaf_scan_units(qpad, slab, unit_leaf, unit_query, n_units, k=)`` —
  the indexed form the chunk round uses: the kernel reads query rows and
  leaf slabs through the work plan's indices, so no gathered copies of the
  query tiles or slabs are made, and it skips plan rows at or beyond the
  device scalar ``n_units``.
* ``leaf_scan_cuda(q, leaf_pts, k=)`` — the work-unit contract of
  ``leaf_scan_pallas`` (q f32[W, TQ, d_pad], leaf_pts f32[W, L_pad, d_pad]
  -> f32[W, TQ, k], i32[W, TQ, k]), the same kernel with identity indices.

Both launch the kernel or raise: they take CUDA tensors only.  The plain
version is ``leaf_scan_units_ref``; ``kernels/ops.py`` picks between the
two by the tensors' device.  ``_extract_topk`` and
``_rank_merge`` are the Pallas kernel's selection helpers as plain torch
functions; ``_rank_merge`` is also called on its own by the dynamic index.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import INVALID_DIST, leaf_scan_ref

__all__ = [
    "leaf_scan_units",
    "leaf_scan_units_ref",
    "leaf_scan_cuda",
    "kernel_limits",
    "DEFAULT_TQ",
]

DEFAULT_TQ = 128
_BIG_I = 2**30
_REF_BLOCK = 256   # plan rows per step of the plain version (bounds memory)


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


def leaf_scan_units_ref(
    qpad: torch.Tensor,
    slab: torch.Tensor,
    unit_leaf: torch.Tensor,
    unit_query: torch.Tensor,
    n_units: torch.Tensor,
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the indexed leaf scan.  Scans every plan row (rows
    at or beyond ``n_units`` too: their values are never read), gathering
    query tiles (zeros for empty slots) and slabs a block of rows at a
    time."""
    out_d, out_i = [], []
    for s in range(0, unit_leaf.shape[0], _REF_BLOCK):
        uq = unit_query[s : s + _REF_BLOCK]
        q = torch.where(
            (uq >= 0)[..., None], qpad[uq.clamp(min=0).long()], 0.0
        )
        d, i = leaf_scan_ref(q, slab[unit_leaf[s : s + _REF_BLOCK].long()], k=k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _lib() -> ctypes.CDLL:
    lib = build.load("leaf_scan").lib
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.leaf_scan_units.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.leaf_scan_units.restype = i
        lib.leaf_scan_error_string.argtypes = [i]
        lib.leaf_scan_error_string.restype = ctypes.c_char_p
        for fn in ("leaf_scan_max_k", "leaf_scan_max_d_pad", "leaf_scan_max_tq"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib._argtypes_set = True
    return lib


def kernel_limits() -> Tuple[int, int, int]:
    """(max k, max d_pad, max TQ) the CUDA kernel takes (builds it)."""
    lib = _lib()
    return lib.leaf_scan_max_k(), lib.leaf_scan_max_d_pad(), lib.leaf_scan_max_tq()


def _check_cuda_args(qpad, slab, unit_leaf, unit_query, n_units, k) -> None:
    dev = qpad.device
    for name, t, dtype, ndim in (
        ("qpad", qpad, torch.float32, 2),
        ("slab", slab, torch.float32, 3),
        ("unit_leaf", unit_leaf, torch.int32, 1),
        ("unit_query", unit_query, torch.int32, 2),
        ("n_units", n_units, torch.int32, None),
    ):
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
        raise ValueError(f"d_pad mismatch: qpad {tuple(qpad.shape)} slab {tuple(slab.shape)}")
    if unit_query.shape[0] != unit_leaf.shape[0]:
        raise ValueError("unit_leaf and unit_query disagree on the plan rows")
    max_k, max_d, max_tq = kernel_limits()
    if not 1 <= k <= min(max_k, slab.shape[1]):
        raise ValueError(
            f"k={k}: the CUDA leaf scan takes 1 <= k <= min({max_k}, L_pad="
            f"{slab.shape[1]})"
        )
    if qpad.shape[1] > max_d:
        raise ValueError(f"d_pad={qpad.shape[1]} > {max_d}, the CUDA leaf scan's limit")
    if not 1 <= unit_query.shape[1] <= max_tq:
        raise ValueError(
            f"TQ={unit_query.shape[1]}: the CUDA leaf scan takes 1 <= TQ <= {max_tq}"
        )


def leaf_scan_units(
    qpad: torch.Tensor,
    slab: torch.Tensor,
    unit_leaf: torch.Tensor,
    unit_query: torch.Tensor,
    n_units: torch.Tensor,
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indexed leaf scan over a work plan.

    qpad f32[m, d_pad]; slab f32[C, L_pad, d_pad] (any d_pad up to the
    kernel's limit: it pads rows with zeros itself); unit_leaf i32[W] (leaf
    of ``slab``); unit_query i32[W, TQ] (row of ``qpad``, -1 = empty slot);
    n_units i32 scalar.  Returns (f32[W, TQ, k], i32[W, TQ, k]) for plan
    rows < n_units; rows beyond are left unwritten by the kernel.
    """
    if qpad.device.type != "cuda":
        raise ValueError(
            f"the CUDA leaf scan takes CUDA tensors, got {qpad.device} "
            "(ops.leaf_scan_units runs the plain version on the CPU)"
        )
    _check_cuda_args(qpad, slab, unit_leaf, unit_query, n_units, k)
    w, tq = unit_query.shape
    out_d = torch.empty((w, tq, k), dtype=torch.float32, device=qpad.device)
    out_i = torch.empty((w, tq, k), dtype=torch.int32, device=qpad.device)
    lib = _lib()
    err = lib.leaf_scan_units(
        qpad.data_ptr(), slab.data_ptr(), unit_leaf.data_ptr(),
        unit_query.data_ptr(), n_units.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), w, tq, slab.shape[1], slab.shape[2], k,
        torch.cuda.current_stream(qpad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"leaf_scan kernel launch failed ({err}): "
            f"{lib.leaf_scan_error_string(err).decode()}"
        )
    leaf_scan_units.launches += 1
    return out_d, out_i


leaf_scan_units.launches = 0   # kernel launches (not plain-version calls)


def leaf_scan_cuda(
    q: torch.Tensor, leaf_pts: torch.Tensor, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``leaf_scan_pallas``'s work-unit contract: the kernel with identity
    indices (unit w scans query tile w against slab w)."""
    w, tq, d_pad = q.shape
    dev = q.device
    unit_leaf = torch.arange(w, dtype=torch.int32, device=dev)
    unit_query = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    n_units = torch.tensor([w], dtype=torch.int32, device=dev)
    return leaf_scan_units(
        q.reshape(w * tq, d_pad).contiguous(), leaf_pts.contiguous(),
        unit_leaf, unit_query, n_units, k=k,
    )
