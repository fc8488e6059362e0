"""Dispatch for the kNN leaf-scan kernel, and device resolution.

Counterpart of ``repro.kernels.ops``, and the one place that picks between
the CUDA kernel and its plain version: by the tensors' device, the kernel
for CUDA tensors and the plain ``leaf_scan_ref`` for CPU tensors
(``resolve_backend``).  ``resolve_device`` is the one place a missing device
choice becomes the card: entry points run on ``cuda:0`` unless the caller
passes a CPU device, and without a card they raise instead of carrying on
quietly on the CPU.  ``owned_tensor`` is how entry points take the
caller's arrays: as a copy the port owns, on every device.  ``sqrt`` is
the square root every distance and search radius of the port takes.
"""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np
import torch

from repro_torch.kernels import knn_scan as _knn_scan
from repro_torch.kernels import ref as _ref

__all__ = [
    "leaf_scan",
    "leaf_scan_units",
    "pad_dim",
    "engine_tile_q",
    "resolve_backend",
    "resolve_device",
    "visible_devices",
    "owned_tensor",
    "sqrt",
    "PAD_COORD",
    "INVALID_DIST",
]

PAD_COORD = _ref.PAD_COORD
INVALID_DIST = _ref.INVALID_DIST

Backend = Literal["auto", "cuda", "ref"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0``, and
    raises when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; to run on the CPU pass "
            "devices=(torch.device('cpu'),) (or device=torch.device('cpu'))"
        )
    return torch.device("cuda", 0)


def visible_devices() -> Tuple[torch.device, ...]:
    """Every visible CUDA device, ``cuda:0`` ... ``cuda:{count-1}`` (what
    the reference's ``jax.devices()`` gives); raises without a card."""
    resolve_device(None)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def owned_tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    """``a`` (a numpy array or a tensor) as a ``dtype`` tensor on ``device``
    that shares no memory with ``a``.  On the CPU ``torch.from_numpy`` and
    ``.to`` return views of the caller's buffer, which other code in the
    process (the caller, or another framework holding the same array) may
    write while the port reads it; a copy taken here cannot change under
    the port."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``t`` (IEEE ``sqrt``), on its
    device.  On CUDA that is ``torch.sqrt``.  On the CPU it is numpy's:
    PyTorch's CPU float32 ``sqrt`` is not correctly rounded (1 ulp low at
    267, on every call), and it once returned ``x * rsqrt(x)`` with a 12-bit
    estimate for a sixth of a tensor, caught with its input kept and
    correct (ROADMAP Queue 3 item 5); an exact oracle cannot rest on it."""
    if t.device.type != "cpu":
        return torch.sqrt(t)
    return torch.from_numpy(np.sqrt(t.numpy()))


def resolve_backend(backend: str, device) -> str:
    """The CUDA kernel ("cuda") on a CUDA device, the plain reference
    ("ref") elsewhere.  "auto" picks by device; naming the other one raises
    (neither stands in for the other)."""
    want = "cuda" if torch.device(device).type == "cuda" else "ref"
    if backend not in ("auto", want):
        raise ValueError(
            f"backend={backend!r} cannot run on {torch.device(device)}: the "
            "CUDA kernel takes CUDA tensors, the plain version CPU tensors"
        )
    return want


def engine_tile_q(tile_q: int, backend: str) -> int:
    """Query-tile width for the chunked engine: the kernel takes the full
    tile; the plain path wastes far less padding in sparse rounds with
    small tiles."""
    return tile_q if backend == "cuda" else min(tile_q, 16)


def leaf_scan(
    q: torch.Tensor,
    leaf_pts: torch.Tensor,
    *,
    k: int,
    backend: Backend = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Work-unit leaf scan (contract in ``kernels/knn_scan.py``)."""
    if resolve_backend(backend, q.device) == "ref":
        return _ref.leaf_scan_ref(q, leaf_pts, k=k)
    return _knn_scan.leaf_scan_cuda(q, leaf_pts, k=k)


def leaf_scan_units(
    qpad, slab, unit_leaf, unit_query, n_units, *, k: int,
    backend: Backend = "auto", scale=None, offset=None, dead=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indexed leaf scan over a work plan (``knn_scan.leaf_scan_units``);
    a code slab comes with its dequantize metadata, indexed by the slab's
    leaf."""
    meta = dict(scale=scale, offset=offset, dead=dead)
    if resolve_backend(backend, qpad.device) == "ref":
        return _knn_scan.leaf_scan_units_ref(
            qpad, slab, unit_leaf, unit_query, n_units, k=k, **meta
        )
    return _knn_scan.leaf_scan_units(
        qpad, slab, unit_leaf, unit_query, n_units, k=k, **meta
    )


def pad_dim(arr: torch.Tensor, d_pad: int, fill: float = 0.0) -> torch.Tensor:
    """Pad the trailing (feature) dim to ``d_pad`` with ``fill``."""
    d = arr.shape[-1]
    if d == d_pad:
        return arr
    if d > d_pad:
        raise ValueError(f"d={d} > d_pad={d_pad}")
    return torch.nn.functional.pad(arr, (0, d_pad - d), value=fill)
